// Fused GroupNorm (+ optional SiLU) forward over channel-last activations,
// for samples too large for one thread-block cluster: a persistent,
// co-resident grid of row tiles that meet at a per-sample arrival counter.
// The main paths' samples take the cluster kernel of csrc/groupnorm_cluster.cu;
// this one takes every shape ops/groupnorm.py:kernel_for does not give it (a
// sample over 8 blocks' shared memory, C not a whole number of 16-byte
// vectors, x off a 16-byte boundary).
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/groupnorm.py:_gn_kernel (launched
// by _pallas_fwd). Same math: per (sample, group) fp32 sums of x and x^2,
// var = E[x^2] - mean^2, rstd = rsqrt(var + eps), fp32 affine, optional
// SiLU, output in the input dtype.
//
// What bounds it on an H100: bytes. The op does ~10 flops per element
// against 4-8 bytes moved, far below the ~295 flops/byte a Hopper card needs
// before compute matters; the least it can move is one read of x and one
// write of the output. A 3D level-0 sample of 20x20x16 latents at 384
// channels is 4.9 MB in bf16, six times what a cluster's shared memory holds.
//
// Design (ops/groupnorm.py:large_plan chooses the numbers and this file's
// `layout` repeats them):
//   - A work item is a tile of `rows` whole rows x all C channels of one
//     sample: one contiguous range of device memory. A sample's T tiles are
//     consecutive items; the grid (as many blocks as the SMs hold at once,
//     launched cooperatively, so all are resident) walks the items in order,
//     item = blockIdx.x + k * gridDim.x.
//   - Resident tiles (the sample's T tiles fit the blocks' shared memory): one
//     bulk copy (TMA) brings the tile into shared memory, so x crosses HBM
//     once. Samples too large even for that stream their tiles from device
//     memory twice; narrower vectors (C x itemsize not a multiple of 16, or
//     x off a 16-byte boundary) copy the tile with 8-, 4- or 2-byte loads.
//   - Each thread owns one vector of channels (16 bytes: 8 bf16 or 4 fp32)
//     and a row lane (rows lane, lane + lanes, ...), so a warp reads
//     contiguous memory and no element costs an index division; it sums x and
//     x^2 per channel in fp32. The lanes' sums add in lane order, then fold
//     into group sums channel by channel (at C/G = 12 a vector straddles two
//     groups), and the tile's 2G partials go to device memory.
//   - Publication: every writer fences, one thread adds 1 to the sample's
//     arrival counter and spins (acquire, nanosleep) until it reads T. Then
//     every block of the sample adds the T tiles' partials in tile order:
//     the statistics do not depend on which block ran which tile, and two
//     launches give bitwise-equal outputs. No float atomics.
//   - The block normalises its tile from shared memory with gamma, beta and
//     the statistics of its channels in registers, and writes 16-byte
//     vectors.
// No deadlock: a block waits only on its current item's sample, every earlier
// item of its own is finished, a sample's T items are consecutive and T is at
// most the grid (the launcher refuses otherwise); so the block holding the
// missing tile of the lowest waiting sample is never itself waiting. A wait
// over 4 seconds traps (a fault, not a hang).
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace ddpm {
namespace {

constexpr int kThreads = 256;
constexpr int kBarrierBytes = 16;  // the bulk copy's mbarrier, padded

// ops/groupnorm.py:large_plan computes the same numbers
struct Layout {
  int lanes;     // row lanes
  int threads;   // a thread per vector of a row (at most kThreads) x the lanes
  int tiles;     // tiles per sample
  size_t bytes;  // dynamic shared memory
};

inline Layout layout(int N, int C, int G, int elem, int vec_bytes, int rows, int resident) {
  Layout L;
  const int vecs = C * elem / vec_bytes;
  const int cols = vecs < kThreads ? vecs : kThreads;
  L.lanes = kThreads / cols;
  L.threads = cols * L.lanes;
  L.tiles = (N + rows - 1) / rows;
  // the barrier, the tile, per-lane channel sums of x and x^2, the sample's
  // partials and its statistics
  const size_t tile = resident ? (static_cast<size_t>(rows) * C * elem + 15) / 16 * 16 : 0;
  L.bytes = kBarrierBytes + tile + 2 * static_cast<size_t>(L.lanes) * C * sizeof(float) +
            (2 * static_cast<size_t>(L.tiles) + 2) * G * sizeof(float);
  return L;
}

// `VB` bytes as 32-bit words (one half-filled word at VB = 2)
template <int VB>
struct Words {
  static constexpr int kW = VB >= 4 ? VB / 4 : 1;
  __device__ static void load(const void* p, uint32_t (&w)[kW]) {
    if constexpr (VB == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else if constexpr (VB == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else if constexpr (VB == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
  __device__ static void store(void* p, const uint32_t (&w)[kW]) {
    if constexpr (VB == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VB == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (VB == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    }
  }
};

// one vector of kN = VB / sizeof(T) channels, as fp32
template <typename T, int VB>
struct Vec;

template <int VB>
struct Vec<float, VB> {
  static constexpr int kN = VB / 4;
  using W = Words<VB>;
  __device__ static void load(const float* p, float (&f)[kN]) {
    uint32_t w[W::kW];
    W::load(p, w);
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = __uint_as_float(w[i]);
  }
  __device__ static void store(float* p, const float (&f)[kN]) {
    uint32_t w[W::kW];
#pragma unroll
    for (int i = 0; i < kN; ++i) w[i] = __float_as_uint(f[i]);
    W::store(p, w);
  }
};

template <int VB>
struct Vec<__nv_bfloat16, VB> {
  static constexpr int kN = VB / 2;
  using W = Words<VB>;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[kN]) {
    uint32_t w[W::kW];
    W::load(p, w);
    if constexpr (kN == 1) {
      f[0] = __uint_as_float(w[0] << 16);
    } else {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {  // a bf16 is the high half of its fp32
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[kN]) {
    uint32_t w[W::kW];
    if constexpr (kN == 1) {
      w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
    } else {
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) w[i] = tc::pack_bf16(f[2 * i], f[2 * i + 1]);
    }
    W::store(p, w);
  }
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// spin until the sample's `tiles` blocks have published their partials
__device__ __forceinline__ void wait_arrivals(const unsigned* counter, unsigned tiles) {
  uint64_t t0 = 0;
  while (load_acquire(counter) < tiles) {
    __nanosleep(64);
    const uint64_t now = sm90::global_ns();
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 4000000000ull)
      __trap();
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
    groupnorm_act_large_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, T* __restrict__ out,
                               unsigned* __restrict__ arrivals, float* __restrict__ partials,
                               int B, int N, int C, int G, int rows_per_tile, int tiles,
                               int resident, float eps, int act) {
  using V = Vec<T, VB>;
  constexpr int kN = V::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* stile = reinterpret_cast<T*>(smem + kBarrierBytes);
  const size_t tile_bytes =
      resident ? (static_cast<size_t>(rows_per_tile) * C * sizeof(T) + 15) / 16 * 16 : 0;
  const int vecs = C / kN;
  const int cols = vecs < kThreads ? vecs : kThreads;
  const int lanes = blockDim.x / cols;
  float* red1 = reinterpret_cast<float*>(smem + kBarrierBytes + tile_bytes);  // [lanes][C]
  float* red2 = red1 + lanes * C;                                             // [lanes][C]
  float* stage = red2 + lanes * C;     // [tiles][2G]: the sample's partials, in tile order
  float* stats = stage + tiles * 2 * G;  // [2][G]: mean, rstd
  const int cpg = C / G;
  const int col = threadIdx.x % cols;
  const int lane = threadIdx.x / cols;
  const int two_g = 2 * G;
  const float inv_count = 1.f / static_cast<float>(N * cpg);
  // 16-byte tiles arrive by one bulk copy, narrower ones by the threads' loads
  constexpr bool kBulk = VB == 16;
  if (kBulk && resident && threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  uint32_t phase = 0;

  for (int item = blockIdx.x; item < B * tiles; item += gridDim.x) {
    const int b = item / tiles;
    const int r0 = (item - b * tiles) * rows_per_tile;
    const int rows = min(rows_per_tile, N - r0);
    const size_t base = (static_cast<size_t>(b) * N + r0) * C;
    const T* tile = x + base;
    if (resident) {
      if constexpr (kBulk) {
        if (threadIdx.x == 0) {
          const uint32_t bytes = static_cast<uint32_t>(rows) * C * sizeof(T);
          sm90::fence_proxy_async();  // the last item's reads of the tile come first
          sm90::mbar_arrive_expect_tx(bar, bytes);
          sm90::bulk_copy_g2s(stile, tile, bytes, bar);
        }
        sm90::mbar_wait(bar, phase);
        phase ^= 1u;
      } else {
        uint32_t w[Words<VB>::kW];
        for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x) {
          Words<VB>::load(tile + static_cast<size_t>(e) * kN, w);
          Words<VB>::store(stile + static_cast<size_t>(e) * kN, w);
        }
        __syncthreads();
      }
      tile = stile;
    }

    // per-channel sums over this thread's row lane, a pass per `cols` vectors
    for (int v = col; v < vecs; v += cols) {
      float s1[kN], s2[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) s1[i] = s2[i] = 0.f;
      for (int r = lane; r < rows; r += lanes) {
        float f[kN];
        V::load(tile + static_cast<size_t>(r) * C + v * kN, f);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          s1[i] += f[i];
          s2[i] += f[i] * f[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        red1[lane * C + v * kN + i] = s1[i];
        red2[lane * C + v * kN + i] = s2[i];
      }
    }
    __syncthreads();
    // channel sums over the lanes, in lane order, into lane 0's row; then the
    // tile's group sums channel by channel, published to device memory
    for (int ch = threadIdx.x; ch < C; ch += blockDim.x) {
      float a1 = 0.f, a2 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        a1 += red1[l * C + ch];
        a2 += red2[l * C + ch];
      }
      red1[ch] = a1;
      red2[ch] = a2;
    }
    __syncthreads();
    float* mine = partials + static_cast<size_t>(item) * two_g;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float a1 = 0.f, a2 = 0.f;
      for (int i = 0; i < cpg; ++i) {
        a1 += red1[g * cpg + i];
        a2 += red2[g * cpg + i];
      }
      mine[g] = a1;
      mine[G + g] = a2;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(arrivals + b, 1u);
      wait_arrivals(arrivals + b, static_cast<unsigned>(tiles));
    }
    __syncthreads();

    // the sample's statistics: its tiles' partials added in tile order
    const float* all = partials + static_cast<size_t>(b) * tiles * two_g;
    for (int e = threadIdx.x; e < tiles * two_g; e += blockDim.x) stage[e] = __ldcg(all + e);
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float a1 = 0.f, a2 = 0.f;
      for (int t = 0; t < tiles; ++t) {
        a1 += stage[t * two_g + g];
        a2 += stage[t * two_g + G + g];
      }
      const float mean = a1 * inv_count;
      const float var = a2 * inv_count - mean * mean;
      stats[g] = mean;
      stats[G + g] = rsqrtf(var + eps);
    }
    __syncthreads();

    // normalise the tile, write vectors
    for (int v = col; v < vecs; v += cols) {
      float mu[kN], rs[kN], ga[kN], be[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int ch = v * kN + i;
        const int g = ch / cpg;
        mu[i] = stats[g];
        rs[i] = stats[G + g];
        ga[i] = gamma[ch];
        be[i] = beta[ch];
      }
      for (int r = lane; r < rows; r += lanes) {
        const size_t at = static_cast<size_t>(r) * C + v * kN;
        float f[kN];
        V::load(tile + at, f);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          float y = (f[i] - mu[i]) * rs[i] * ga[i] + be[i];
          // SiLU, y * sigmoid(y), on the fast intrinsics, as the cluster
          // kernel (a denominator past 2^126 gives 0, as it should)
          if (act) y = __fdividef(y, 1.f + __expf(-y));
          f[i] = y;
        }
        V::store(out + base + at, f);
      }
    }
    __syncthreads();  // the tile's reads are done before the next item's copy
  }
}

template <typename T, int VB>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* out, void* work,
                   int B, int N, int C, int G, float eps, int act, int rows, int resident,
                   size_t smem, cudaStream_t stream) {
  const Layout L = layout(N, C, G, sizeof(T), VB, rows, resident);
  if (L.lanes < 1 || smem != L.bytes) return cudaErrorInvalidValue;
  auto kernel = groupnorm_act_large_kernel<T, VB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, resident_blocks = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident_blocks, kernel, L.threads, smem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(B) * L.tiles;
  const long long slots = static_cast<long long>(resident_blocks) * sms;
  const long long grid = items < slots ? items : slots;
  // every tile of a sample must be resident at once (no deadlock)
  if (grid < L.tiles) return cudaErrorCooperativeLaunchTooLarge;
  unsigned* arrivals = static_cast<unsigned*>(work);
  float* partials = reinterpret_cast<float*>(arrivals + B);
  err = cudaMemsetAsync(arrivals, 0, static_cast<size_t>(B) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  void* args[] = {&xp, &gamma, &beta, &op, &arrivals, &partials, &B, &N, &C,
                  &G, &rows, const_cast<int*>(&L.tiles), &resident, &eps, &act};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(L.threads), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(int vec_bytes, const void* x, const float* gamma, const float* beta,
                       void* out, void* work, int B, int N, int C, int G, float eps, int act,
                       int rows, int resident, size_t smem, cudaStream_t stream) {
  switch (vec_bytes) {
    case 16:
      return launch<T, 16>(x, gamma, beta, out, work, B, N, C, G, eps, act, rows, resident,
                           smem, stream);
    case 8:
      return launch<T, 8>(x, gamma, beta, out, work, B, N, C, G, eps, act, rows, resident,
                          smem, stream);
    case 4:
      return launch<T, 4>(x, gamma, beta, out, work, B, N, C, G, eps, act, rows, resident,
                          smem, stream);
    default:
      if constexpr (sizeof(T) == 2) {
        if (vec_bytes == 2)
          return launch<T, 2>(x, gamma, beta, out, work, B, N, C, G, eps, act, rows, resident,
                              smem, stream);
      }
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ddpm

// x, out: (B, N, C) contiguous, channel-last, on `vec_bytes` boundaries, a row
// a whole number of vectors; gamma, beta: (C,) fp32; work: B unsigned
// arrival counters (zeroed here) then B x tiles x 2G fp32 partials. The tile
// rows, residency and shared-memory bytes must be what
// ops/groupnorm.py:large_plan computes for this shape.
extern "C" int ddpm_groupnorm_act(const void* x, const float* gamma, const float* beta,
                                  void* out, void* work, int B, int N, int C, int G, float eps,
                                  int act, int dtype, int vec_bytes, int tile_rows, int resident,
                                  int smem_bytes, int device, void* stream) {
  if (B < 1 || N < 1 || G < 1 || C < G || C % G != 0 || tile_rows < 1)
    return cudaErrorInvalidValue;
  const int elem = dtype == ddpm::kFloat32 ? 4 : 2;
  if (vec_bytes < elem || (C * elem) % vec_bytes != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % vec_bytes != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  switch (dtype) {
    case ddpm::kFloat32:
      return ddpm::launch_vec<float>(vec_bytes, x, gamma, beta, out, work, B, N, C, G, eps, act,
                                     tile_rows, resident, smem, s);
    case ddpm::kBFloat16:
      return ddpm::launch_vec<__nv_bfloat16>(vec_bytes, x, gamma, beta, out, work, B, N, C, G,
                                             eps, act, tile_rows, resident, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ddpm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
