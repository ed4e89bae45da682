// Fused GroupNorm (+ optional SiLU) forward over channel-last activations, one
// thread-block cluster per sample.
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/groupnorm.py:_gn_kernel (launched
// by _pallas_fwd). Same math: per (sample, group) fp32 sums of x and x^2,
// var = E[x^2] - mean^2, rstd = rsqrt(var + eps), fp32 affine, optional
// SiLU, output in the input dtype.
//
// What bounds it on an H100: bytes. The op does ~10 flops per element against
// 4-8 bytes moved, far below the ~295 flops/byte a Hopper card needs before
// compute matters; the least it can move is one read of x and one write.
//
// Design: the TPU kernel keeps a whole sample (N x C) in VMEM. A block's
// 227 KB of shared memory cannot hold one small-UNet sample at 32x32 (768 KB
// in bf16), but a cluster of up to 8 blocks can: each block of the cluster
// owns a contiguous run of rows x all C channels, one contiguous range of
// device memory, and copies it into shared memory once (16-byte cp.async).
// The cluster size S (1, 2, 4 or 8) and the shared-memory bytes are chosen by
// the caller (ops/groupnorm.py:cluster_plan, which this file's `layout`
// repeats): the smallest S whose slice fits two blocks on an SM, else one.
//   1. Each thread owns one fixed 16-byte vector of channels (8 bf16 or 4
//      fp32) and a row lane: rows lane, lane + R, ... of the slice, so a warp
//      reads 512 contiguous bytes. It sums x and x^2 per channel in fp32.
//   2. The R row lanes' per-channel sums are added in shared memory in lane
//      order, then folded into group sums channel by channel: at C/G = 4 or
//      12 an 8-channel vector straddles two groups, so never by vector.
//   3. The blocks exchange group sums through distributed shared memory
//      (cluster.map_shared_rank), each adding the S blocks' sums in rank
//      order, so every block holds the same statistics.
//   4. Each block normalises its slice from shared memory, with gamma, beta
//      and the statistics of its channels in registers, and writes 16-byte
//      vectors. One read of x from device memory and one write in all.
// The order of every sum is fixed: the result does not depend on scheduling.
// Shapes the plan refuses (a sample over 8 blocks' shared memory, C not a
// whole number of vectors) take the one-block-per-group kernel of
// csrc/groupnorm.cu; ops/groupnorm.py chooses, by shape, before the launch.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace ddpm {
namespace {

constexpr int kMaxThreads = 256;
constexpr int kVecBytes = 16;

// A block's threads and shared memory; ops/groupnorm.py:cluster_smem_bytes
// computes the same bytes.
struct Layout {
  int threads;  // one per 16-byte vector of a row, times the row lanes
  int lanes;    // row lanes
  int rows;     // rows per block
  size_t bytes;
};

inline Layout layout(int N, int C, int G, int S, int elem) {
  Layout L;
  const int vecs = C * elem / kVecBytes;
  L.lanes = vecs > 0 ? kMaxThreads / vecs : 0;
  L.threads = vecs * L.lanes;
  L.rows = (N + S - 1) / S;
  // the slice, per-lane channel sums of x and x^2, group sums and statistics
  L.bytes = static_cast<size_t>(L.rows) * C * elem +
            2 * static_cast<size_t>(L.lanes) * C * sizeof(float) +
            4 * static_cast<size_t>(G) * sizeof(float);
  return L;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&f)[kN]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ static void store(float* p, const float (&f)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[kN]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[kN]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]),
                   tc::pack_bf16(f[4], f[5]), tc::pack_bf16(f[6], f[7]));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    groupnorm_act_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                 const float* __restrict__ beta, T* __restrict__ out, int N,
                                 int C, int G, int rows_per_block, float eps, int act) {
  constexpr int kN = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / S;
  const int vecs = C / kN;
  const int lanes = blockDim.x / vecs;
  const int cpg = C / G;
  const int r0 = rank * rows_per_block;
  const int rows = max(0, min(rows_per_block, N - r0));
  T* sx = reinterpret_cast<T*>(smem);
  float* red1 = reinterpret_cast<float*>(smem + static_cast<size_t>(rows_per_block) * C *
                                                    sizeof(T));  // [lanes][C]
  float* red2 = red1 + lanes * C;                                 // [lanes][C]
  float* part = red2 + lanes * C;  // [2][G]: this block's group sums of x, x^2
  float* stats = part + 2 * G;     // [2][G]: mean, rstd

  // the block's rows x all channels: one contiguous range of device memory
  const size_t base = (static_cast<size_t>(b) * N + r0) * C;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x + base);
  for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x)
    tc::cp_async_16(smem + static_cast<size_t>(e) * kVecBytes,
                    src + static_cast<size_t>(e) * kVecBytes, true);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // 1. per-channel sums over this thread's row lane (blockDim.x == vecs x lanes)
  const int vec = threadIdx.x % vecs;
  const int lane = threadIdx.x / vecs;
  float s1[kN], s2[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) s1[i] = s2[i] = 0.f;
  for (int r = lane; r < rows; r += lanes) {
    float f[kN];
    Vec<T>::load(sx + static_cast<size_t>(r) * C + vec * kN, f);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      s1[i] += f[i];
      s2[i] += f[i] * f[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const int at = lane * C + vec * kN + i;
    *reinterpret_cast<float4*>(red1 + at) = make_float4(s1[i], s1[i + 1], s1[i + 2], s1[i + 3]);
    *reinterpret_cast<float4*>(red2 + at) = make_float4(s2[i], s2[i + 1], s2[i + 2], s2[i + 3]);
  }
  __syncthreads();

  // 2. channel sums over the lanes, in lane order, into lane 0's row; then
  // group sums channel by channel
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
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      a1 += red1[g * cpg + i];
      a2 += red2[g * cpg + i];
    }
    part[g] = a1;
    part[G + g] = a2;
  }

  // 3. the cluster's group sums, in rank order, from each block's shared memory
  cluster.sync();
  const float inv_count = 1.f / static_cast<float>(N * cpg);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int rk = 0; rk < S; ++rk) {
      const float* remote = cluster.map_shared_rank(part, rk);
      a1 += remote[g];
      a2 += remote[G + g];
    }
    const float mean = a1 * inv_count;
    const float var = a2 * inv_count - mean * mean;
    stats[g] = mean;
    stats[G + g] = rsqrtf(var + eps);
  }
  // every block has read every `part` (none may exit before), and `stats` is
  // visible to the whole block
  cluster.sync();

  // 4. normalise from shared memory, write 16-byte vectors
  float mu[kN], rs[kN], ga[kN], be[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int ch = vec * kN + i;
    const int g = ch / cpg;
    mu[i] = stats[g];
    rs[i] = stats[G + g];
    ga[i] = gamma[ch];
    be[i] = beta[ch];
  }
  for (int r = lane; r < rows; r += lanes) {
    const size_t at = static_cast<size_t>(r) * C + vec * kN;
    float f[kN];
    Vec<T>::load(sx + at, f);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float y = (f[i] - mu[i]) * rs[i] * ga[i] + be[i];
      // SiLU, y * sigmoid(y), on the fast intrinsics (a few ulp): with IEEE
      // expf and division it cost 64% more than no activation at
      // (64, 1024, 384) bf16 on an H100. A denominator past 2^126 gives 0,
      // as it should.
      if (act) y = __fdividef(y, 1.f + __expf(-y));
      f[i] = y;
    }
    Vec<T>::store(out + base + at, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* out, int B, int N,
                   int C, int G, float eps, int act, int S, size_t smem, cudaStream_t stream) {
  const Layout L = layout(N, C, G, S, sizeof(T));
  if (C % Vec<T>::kN != 0 || L.lanes < 1 || smem != L.bytes) return cudaErrorInvalidValue;
  auto kernel = groupnorm_act_cluster_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * S);
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), gamma, beta,
                           static_cast<T*>(out), N, C, G, L.rows, eps, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// x, out: (B, N, C) contiguous, channel-last, on 16-byte boundaries, C a whole
// number of 16-byte vectors; gamma, beta: (C,) fp32. `cluster` blocks (1, 2, 4
// or 8) per sample, each with `smem_bytes` of dynamic shared memory, which
// must be what ops/groupnorm.py:cluster_plan computes for this shape.
extern "C" int ddpm_groupnorm_act_cluster(const void* x, const float* gamma, const float* beta,
                                          void* out, int B, int N, int C, int G, float eps,
                                          int act, int dtype, int cluster, int smem_bytes,
                                          int device, void* stream) {
  if (B < 1 || N < 1 || G < 1 || C < G || C % G != 0) return cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  switch (dtype) {
    case ddpm::kFloat32:
      return ddpm::launch<float>(x, gamma, beta, out, B, N, C, G, eps, act, cluster, smem, s);
    case ddpm::kBFloat16:
      return ddpm::launch<__nv_bfloat16>(x, gamma, beta, out, B, N, C, G, eps, act, cluster,
                                         smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}
