// Flash-attention backward: dQ, dK, dV of O = softmax(Q K^T * scale) V from
// the forward's per-row logsumexp, without the (N, N) probabilities ever
// reaching device memory. Q, K, V, dO, dQ, dK, dV are (BH, N, D) contiguous in
// f32 or bf16; lse and delta = rowsum(dO * O) are (BH, N) fp32.
//
// Replaces the TPU kernels ddpm_ood_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// and _flash_bwd_dq_kernel (both launched by _flash_bwd_impl). Same math:
//   p = exp(q k^T * scale - lse);  dV += p^T dO;  dP = dO V^T;
//   dS = p * (dP - delta) * scale;  dK += dS^T Q;  dQ += dS K.
// On the TPU the inner loop is a sequential grid axis with dK/dV (or dQ)
// carried in VMEM scratch between grid steps. Hopper blocks run in no order,
// so here a block owns its output tile for the whole loop: the dK/dV kernel
// takes one (bh, 32-key tile) and walks the q-tiles itself, the dQ kernel one
// (bh, 32-query tile) and walks the k-tiles. The sums live in registers.
//
// What bounds it on an H100: at the UNet's shapes (N = 64 tokens, D = 256,
// one head) each kernel does ~N/2 to ~N flops per byte of its inputs, far under
// the ~295 flops/byte where bf16 tensor cores would bound it, so bytes and
// latency bound it; the probabilities are recomputed, never stored. At long
// sequences the flops grow as N^2 and this CUDA-core version becomes
// compute-bound; tensor cores (wgmma) are later work.
//
// Design: tiles of BQ = 32 queries and BK = 32 keys held in shared memory as
// fp32 (inputs are converted on load, so f32 and bf16 share one code path). At
// D = 256 a block holds Q, dO (32 x 256 each), K, V (32 x 257 each, rows padded
// by one float so the 32 lanes computing 32 logits read 32 different banks),
// P and dS (32 x 33 each): ~137 KB, above the 48 KB default, so the launcher
// raises the block's dynamic shared-memory limit; one block fits on an SM. The
// two accumulators of the dK/dV kernel take 64 registers a thread, dQ's 32.
// Rows and keys past N are masked (their P and dS are 0), so any N works.
#include <math.h>

#include "common.cuh"

namespace ddpm {
namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;  // == warp size: one lane per key column of a logit tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kAcc = kBQ * kMaxD / kThreads;               // accumulators per thread
constexpr int kRowsPerThread = kBQ * kBK / kThreads;       // logits per thread
constexpr int kRowStride = kThreads / kBK;                 // rows between them
static_assert(kBQ == kBK, "both kernels share one tile layout");
static_assert(kBK == 32, "a warp owns one logit row: lane = key column");

__host__ __device__ constexpr size_t smem_floats(int d) {
  return 2 * static_cast<size_t>(kBQ) * d          // Q, dO tiles
         + 2 * static_cast<size_t>(kBK) * (d + 1)  // K, V tiles, padded rows
         + 2 * static_cast<size_t>(kBQ) * (kBK + 1)  // P, dS
         + 2 * kBQ;                                // lse, delta per row
}

struct Tiles {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
};

__device__ __forceinline__ Tiles carve(float* smem, int D) {
  Tiles t;
  t.q = smem;
  t.dout = t.q + kBQ * D;
  t.k = t.dout + kBQ * D;
  t.v = t.k + kBK * (D + 1);
  t.p = t.v + kBK * (D + 1);
  t.ds = t.p + kBQ * (kBK + 1);
  t.lse = t.ds + kBQ * (kBK + 1);
  t.delta = t.lse + kBQ;
  return t;
}

// Q, dO rows q0.. of head `head` (and their lse, delta); rows past N are 0.
template <typename T>
__device__ void load_q_tile(const Tiles& t, const T* __restrict__ q, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            size_t head, size_t row_base, int q0, int N, int D) {
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int i = e / D;
    const int row = q0 + i;
    float qv = 0.f, ov = 0.f;
    if (row < N) {
      const size_t idx = head + static_cast<size_t>(row) * D + (e - i * D);
      qv = to_f32(q[idx]);
      ov = to_f32(dout[idx]);
    }
    t.q[e] = qv;
    t.dout[e] = ov;
  }
  if (threadIdx.x < kBQ) {
    const int row = q0 + threadIdx.x;
    t.lse[threadIdx.x] = row < N ? lse[row_base + row] : 0.f;
    t.delta[threadIdx.x] = row < N ? delta[row_base + row] : 0.f;
  }
}

// K, V rows k0.. into the padded tiles; rows past N are 0.
template <typename T>
__device__ void load_kv_tile(const Tiles& t, const T* __restrict__ k, const T* __restrict__ v,
                             size_t head, int k0, int N, int D) {
  const int ldk = D + 1;
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int j = e / D;
    const int d = e - j * D;
    const int row = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (row < N) {
      const size_t idx = head + static_cast<size_t>(row) * D + d;
      kv = to_f32(k[idx]);
      vv = to_f32(v[idx]);
    }
    t.k[j * ldk + d] = kv;
    t.v[j * ldk + d] = vv;
  }
}

// P = exp(Q K^T scale - lse) and dS = P (dO V^T - delta) scale for the loaded
// tiles. Thread owns key column `col` of rows row0, row0 + 8, ...; a warp
// shares its rows, so Q and dO reads are broadcasts.
__device__ void p_and_ds(const Tiles& t, int q0, int k0, int N, int D, float scale) {
  const int ldk = D + 1;
  const int lds = kBK + 1;
  const int col = threadIdx.x % kBK;
  const int row0 = threadIdx.x / kBK;
  float s[kRowsPerThread], dp[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) s[r] = dp[r] = 0.f;
  const float* krow = t.k + col * ldk;
  const float* vrow = t.v + col * ldk;
  for (int d = 0; d < D; ++d) {
    const float kd = krow[d];
    const float vd = vrow[d];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = row0 + r * kRowStride;
      s[r] += t.q[i * D + d] * kd;
      dp[r] += t.dout[i * D + d] * vd;
    }
  }
  const bool key_ok = k0 + col < N;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + r * kRowStride;
    const float p = (key_ok && q0 + i < N) ? expf(s[r] * scale - t.lse[i]) : 0.f;
    t.p[i * lds + col] = p;
    t.ds[i * lds + col] = p * (dp[r] - t.delta[i]) * scale;
  }
}

// One block per (bh, k-tile): dV = sum over q-tiles of P^T dO, dK of dS^T Q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int N, int D, float scale,
                         int k_tiles) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, D);
  const int lds = kBK + 1;
  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - bh * k_tiles) * kBK;
  const size_t head = static_cast<size_t>(bh) * N * D;
  const size_t row_base = static_cast<size_t>(bh) * N;
  const int tid = threadIdx.x;

  load_kv_tile(t, k, v, head, k0, N, D);
  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc_k[r] = acc_v[r] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBQ) {
    __syncthreads();  // the previous q-tile is fully consumed
    load_q_tile(t, q, dout, lse, delta, head, row_base, q0, N, D);
    __syncthreads();
    p_and_ds(t, q0, k0, N, D, scale);
    __syncthreads();
    // thread owns elements tid, tid + 256, ... of the (BK, D) tiles, so a warp
    // reads 32 consecutive columns of dO and Q and one P / dS column
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < kBK * D) {
        const int j = e / D;
        const int d = e - j * D;
        float a_k = acc_k[r], a_v = acc_v[r];
#pragma unroll 8
        for (int i = 0; i < kBQ; ++i) {
          a_v += t.p[i * lds + j] * t.dout[i * D + d];
          a_k += t.ds[i * lds + j] * t.q[i * D + d];
        }
        acc_k[r] = a_k;
        acc_v[r] = a_v;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < kBK * D) {
      const int j = e / D;
      const int row = k0 + j;
      if (row < N) {
        const size_t idx = head + static_cast<size_t>(row) * D + (e - j * D);
        dk[idx] = from_f32<T>(acc_k[r]);
        dv[idx] = from_f32<T>(acc_v[r]);
      }
    }
  }
}

// One block per (bh, q-tile): dQ = sum over k-tiles of dS K.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int N, int D, float scale, int q_tiles) {
  extern __shared__ float smem[];
  const Tiles t = carve(smem, D);
  const int ldk = D + 1;
  const int lds = kBK + 1;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kBQ;
  const size_t head = static_cast<size_t>(bh) * N * D;
  const size_t row_base = static_cast<size_t>(bh) * N;
  const int tid = threadIdx.x;

  load_q_tile(t, q, dout, lse, delta, head, row_base, q0, N, D);
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous k-tile is fully consumed (and Q / dO loaded)
    load_kv_tile(t, k, v, head, k0, N, D);
    __syncthreads();
    p_and_ds(t, q0, k0, N, D, scale);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int e = tid + r * kThreads;
      if (e < kBQ * D) {
        const int i = e / D;
        const int d = e - i * D;
        const float* dsrow = t.ds + i * lds;
        float a = acc[r];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) a += dsrow[j] * t.k[j * ldk + d];
        acc[r] = a;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int e = tid + r * kThreads;
    if (e < kBQ * D) {
      const int i = e / D;
      const int row = q0 + i;
      if (row < N) dq[head + static_cast<size_t>(row) * D + (e - i * D)] = from_f32<T>(acc[r]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int D, size_t* smem) {
  *smem = smem_floats(D) * sizeof(float);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int BH, int N,
                       int D, float scale, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T>, D, &smem);
  if (err != cudaSuccess) return err;
  const int k_tiles = (N + kBK - 1) / kBK;
  flash_bwd_dkv_kernel<T><<<BH * k_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, D,
      scale, k_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int BH, int N, int D,
                      float scale, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare(flash_bwd_dq_kernel<T>, D, &smem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  flash_bwd_dq_kernel<T><<<BH * q_tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), N, D, scale, q_tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// q, k, v, dout, dk, dv: (BH, N, D) contiguous, D <= 256; lse, delta: (BH, N) fp32.
extern "C" int ddpm_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int BH, int N, int D, float scale,
                                       int dtype, int device, void* stream) {
  if (BH < 1 || N < 1 || D < 1 || D > ddpm::kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ddpm::kFloat32:
      return ddpm::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, s);
    case ddpm::kBFloat16:
      return ddpm::launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale,
                                             s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q, k, v, dout, dq: (BH, N, D) contiguous, D <= 256; lse, delta: (BH, N) fp32.
extern "C" int ddpm_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int BH, int N, int D, float scale, int dtype,
                                      int device, void* stream) {
  if (BH < 1 || N < 1 || D < 1 || D > ddpm::kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ddpm::kFloat32:
      return ddpm::launch_dq<float>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, s);
    case ddpm::kBFloat16:
      return ddpm::launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
