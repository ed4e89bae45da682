// Flash-attention forward: O = softmax(Q K^T * scale) V and the per-row
// logsumexp, by online softmax. Q, K, V, O are (BH, N, D) contiguous.
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_fwd). Same math: running row max m and row sum l in
// fp32, the accumulator rescaled by exp(m_prev - m_new) at every k-block,
// O = acc / l, lse = m + log(l). On the TPU the k-blocks are a sequential grid
// axis with m/l/acc carried in VMEM scratch between grid steps; Hopper blocks
// run in no order, so here one block owns one (bh, q-tile) and loops over the
// k-blocks itself. The TPU's lse was (BH, N, 128) lane-replicated (a Mosaic
// layout artifact); here it is (BH, N).
//
// What bounds it on an H100: at the UNet's shapes (N = 64 tokens, D = 256,
// one head) it does 4*N*D flops per row against 8*D bytes of Q/O plus K/V
// read once per q-tile: ~N/2 flops per byte, far under the ~295 flops/byte
// where bf16 tensor cores would bound it, so bytes and latency bound it. At
// long sequences (the big preset reaches N = 1024) the flops grow as N^2 and
// this CUDA-core version becomes compute-bound; tensor cores (wgmma) are
// later work.
//
// This CUDA-core kernel serves fp32 inputs only; bf16 runs on
// tensor cores (csrc/attention_fwd_tc.cu).
//
// Design: tiles of BQ = 32 query rows and BK = 32 keys, held in shared memory.
// At D = 256 that is 32 KB per tile and ~101 KB per block in all, above the
// 48 KB default, so the launcher raises the block's dynamic shared-memory
// limit; two blocks fit on an SM. K rows are padded by one float so the 32
// lanes computing 32 logits read 32 different banks. The logits never reach
// device memory. Rows and keys past N are masked (zero Q rows are not
// stored; masked keys get -inf logits), so any N works.
#include <math.h>

#include "common.cuh"

namespace ddpm {
namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;  // == warp size: one lane per key column in the softmax
constexpr int kAttnThreads = 256;
constexpr int kMaxD = 256;
constexpr int kAcc = kBQ * kMaxD / kAttnThreads;    // accumulators per thread
constexpr int kRowsPerThread = kBQ * kBK / kAttnThreads;  // logits per thread
constexpr int kRowStride = kAttnThreads / kBK;            // rows between them
static_assert(kBK == 32, "softmax maps one lane to one key column");

__host__ __device__ constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ) * d          // Q tile
         + static_cast<size_t>(kBK) * (d + 1)  // K tile, padded rows
         + static_cast<size_t>(kBK) * d        // V tile
         + static_cast<size_t>(kBQ) * (kBK + 1)  // logits / probabilities
         + 3 * kBQ;                            // alpha, l, m per row
}

__global__ void __launch_bounds__(kAttnThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int N, int D, float scale, int q_tiles) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  const int lds = kBK + 1;
  float* sQ = smem;
  float* sK = sQ + kBQ * D;
  float* sV = sK + kBK * ldk;
  float* sS = sV + kBK * D;
  float* sAlpha = sS + kBQ * lds;
  float* sL = sAlpha + kBQ;
  float* sM = sL + kBQ;

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * kBQ;
  const size_t head = static_cast<size_t>(bh) * N * D;
  const int tid = threadIdx.x;

  for (int e = tid; e < kBQ * D; e += kAttnThreads) {
    const int i = e / D;
    const int row = q0 + i;
    sQ[e] = row < N ? q[head + static_cast<size_t>(row) * D + (e - i * D)] : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = -1e30f;  // finite, so exp(m_prev - m_new) never sees inf - inf
    sL[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  const int col = tid % kBK;  // this thread's key column for the logits
  const int row0 = tid / kBK;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q / m / l written)
    for (int e = tid; e < kBK * D; e += kAttnThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int row = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (row < N) {
        const size_t idx = head + static_cast<size_t>(row) * D + d;
        kv = k[idx];
        vv = v[idx];
      }
      sK[j * ldk + d] = kv;
      sV[e] = vv;
    }
    __syncthreads();

    // logits: thread owns column `col` of rows row0, row0 + 8, ...
    float s[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) s[r] = 0.f;
    const float* krow = sK + col * ldk;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) s[r] += sQ[(row0 + r * kRowStride) * D + d] * kd;
    }
    const bool valid = k0 + col < N;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      sS[(row0 + r * kRowStride) * lds + col] = valid ? s[r] * scale : -INFINITY;
    __syncthreads();

    // online softmax: warp w owns rows w, w + 8, ...; lane = key column
    for (int i = warp; i < kBQ; i += kAttnThreads / 32) {
      const float x = sS[i * lds + lane];
      const float m_prev = sM[i];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = expf(x - m_new);
      const float p_sum = warp_sum(p);
      sS[i * lds + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[i] = alpha;
        sL[i] = alpha * sL[i] + p_sum;
        sM[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; thread owns elements tid, tid + 256, ... of the
    // (BQ, D) output tile, so a warp reads 32 consecutive V columns
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int e = tid + r * kAttnThreads;
      if (e < kBQ * D) {
        const int i = e / D;
        const int d = e - i * D;
        const float* prow = sS + i * lds;
        float a = acc[r] * sAlpha[i];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) a += prow[j] * sV[j * D + d];
        acc[r] = a;
      }
    }
  }

  // sL / sM were last written before the final tile's P V barrier
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int e = tid + r * kAttnThreads;
    if (e < kBQ * D) {
      const int i = e / D;
      const int row = q0 + i;
      if (row < N) o[head + static_cast<size_t>(row) * D + (e - i * D)] = acc[r] / sL[i];
    }
  }
  if (tid < kBQ && q0 + tid < N)
    lse[static_cast<size_t>(bh) * N + q0 + tid] = sM[tid] + logf(sL[tid]);
}

cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse, int BH,
                   int N, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int q_tiles = (N + kBQ - 1) / kBQ;
  flash_fwd_kernel<<<BH * q_tiles, kAttnThreads, smem, stream>>>(q, k, v, o, lse, N, D, scale,
                                                                 q_tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// q, k, v, o: (BH, N, D) contiguous fp32, D <= 256; lse: (BH, N) fp32.
// (bf16 runs on tensor cores: ddpm_flash_attn_fwd_tc)
extern "C" int ddpm_flash_attn_fwd(const float* q, const float* k, const float* v, float* o,
                                   float* lse, int BH, int N, int D, float scale, int device,
                                   void* stream) {
  if (BH < 1 || N < 1 || D < 1 || D > ddpm::kMaxD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return ddpm::launch(q, k, v, o, lse, BH, N, D, scale, static_cast<cudaStream_t>(stream));
}
