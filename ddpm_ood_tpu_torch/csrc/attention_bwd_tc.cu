// Flash-attention backward dK/dV for bf16 on Hopper tensor cores, from the
// forward's per-row logsumexp. Q, K, V, dO, dK, dV are (BH, N, D) contiguous
// bf16, D a multiple of 8 up to 256; lse and delta = rowsum(dO * O) are
// (BH, N) fp32. fp32 inputs keep the CUDA-core kernel of csrc/attention_bwd.cu;
// bf16 dQ has its own tensor-core kernel (csrc/attention_bwd_dq_tc.cu).
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (launched by _flash_bwd_impl). Same math:
//   p = exp(q k^T * scale - lse);  dV += p^T dO;
//   dS = p * (dO V^T - delta) * scale;  dK += dS^T Q.
// Like FlashAttention-2, p and dS are rounded to bf16 before the two
// accumulating products (the TPU kernel multiplies fp32 operands).
//
// What bounds it on an H100: at the UNet's shapes (N = 64, D = 256, one head)
// it does ~N/2 = 32 flops per byte of Q, K, V, dO, dK and dV, far under the
// ~295 flops/byte where bf16 tensor cores would bound it: bytes and latency
// bound it. The tensor cores take the arithmetic off the shared-memory path
// (the CUDA-core kernel did one FMA per 2 shared loads from fp32 copies).
//
// Design: one block of 8 warps per (bh, 64-key tile). K and V stay in bf16
// shared tiles (rows padded by 16 bytes, so ldmatrix is free of bank
// conflicts) for the whole loop over 64-query tiles; Q, dO, lse and delta
// arrive by cp.async, the next q-tile double-buffered behind the current
// one's math when there is more than one. Per q-tile:
//   1. S^T = K Q^T and dP^T = V dO^T on mma.sync m16n8k16 (bf16 in, fp32
//      out), each warp a 16-key x 32-query part; P^T and dS^T are formed in
//      registers, rounded to bf16 and staged once in shared memory (64 x 64
//      each, 9 KB with padding).
//   2. dV += P^T dO (warps 0-3) and dK += dS^T Q (warps 4-7) on mma.sync,
//      each warp 16 keys x all D columns: 128 fp32 accumulators a thread at
//      D = 256.
// Shared memory at D = 256: K, V 33,792 bytes each, Q and dO 33,792 each per
// stage, P^T and dS^T 9,216 each: 222,208 bytes with two stages (N > 64),
// 154,112 with one; one block per SM. BH = 128, N = 64 (training) is 128
// blocks. ptxas: 227 registers at DP = 256, no spills, with the two loops
// over 16-wide steps left rolled (unrolled, hoisted loads spill). Query rows past
// N give p = 0; K/V rows past N load as zeros and are not stored; columns past
// D load as zeros and are not stored. Widths are compiled for DP = 64, 128
// and 256.
#include "common.cuh"
#include "mma.cuh"

namespace ddpm {
namespace {

using bf16 = __nv_bfloat16;
using namespace tc;

constexpr int kB = 64;  // keys per block, queries per tile
constexpr int kThreads = 256;
constexpr int kLdP = kB + kPad;  // row stride of the staged P^T and dS^T
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr size_t bwd_smem_bytes(int dp, int stages) {
  return (static_cast<size_t>(2 + 2 * stages) * kB * (dp + kPad) + 2 * kB * kLdP) * sizeof(bf16) +
         2 * stages * kB * sizeof(float);
}

template <int DP>
__device__ __forceinline__ void load_q_tile(bf16* sQ, bf16* sdO, float* sLse, float* sDelta,
                                            const bf16* q, const bf16* dout, const float* lse,
                                            const float* delta, int q0, int N, int D) {
  load_rows<DP>(sQ, q, q0, kB, N, D);
  load_rows<DP>(sdO, dout, q0, kB, N, D);
  load_row_stats(sLse, lse, q0, kB, N);
  load_row_stats(sDelta, delta, q0, kB, N);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int D,
                            float scale, int k_tiles, int stages) {
  constexpr int LD = DP + kPad;
  constexpr int kNT = DP / 8;  // 8-wide column tiles of dK / dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kB * LD;
  bf16* sQ = sV + kB * LD;           // stage s at sQ + s kB LD
  bf16* sdO = sQ + stages * kB * LD;  // stage s at sdO + s kB LD
  bf16* sP = sdO + stages * kB * LD;  // P^T: [key][query]
  bf16* sdS = sP + kB * kLdP;         // dS^T: [key][query]
  float* sLse = reinterpret_cast<float*>(sdS + kB * kLdP);  // stage s at sLse + s kB
  float* sDelta = sLse + stages * kB;

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x - bh * k_tiles) * kB;
  const size_t head = static_cast<size_t>(bh) * N * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * N;
  const float* delta_h = delta + static_cast<size_t>(bh) * N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int kg = warp % 4;   // this warp's 16 keys
  const int half = warp / 4;  // step 1: its 32 queries; step 2: dV (0) or dK (1)
  const int n_tiles = (N + kB - 1) / kB;
  const float scale_log2 = scale * kLog2e;

  load_rows<DP>(sK, k + head, k0, kB, N, D);
  load_rows<DP>(sV, v + head, k0, kB, N, D);
  load_q_tile<DP>(sQ, sdO, sLse, sDelta, q + head, dout + head, lse_h, delta_h, 0, N, D);
  cp_async_commit();

  float acc[kNT][4];  // dV (warps 0-3) or dK (warps 4-7) for keys 16 kg..
#pragma unroll
  for (int t = 0; t < kNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = stages == 2 ? (i & 1) : 0;
    if (stages == 2 && i + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_q_tile<DP>(sQ + nb * kB * LD, sdO + nb * kB * LD, sLse + nb * kB, sDelta + nb * kB,
                      q + head, dout + head, lse_h, delta_h, (i + 1) * kB, N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + buf * kB * LD;
    const bf16* tdO = sdO + buf * kB * LD;
    const float* tLse = sLse + buf * kB;
    const float* tDelta = sDelta + buf * kB;
    const int q0 = i * kB;

    // 1. S^T and dP^T for keys 16 kg.. and queries 32 half..: 4 n-tiles each
    {
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
      // not unrolled: with 128 accumulators live, loads hoisted from later
      // steps would push the registers past 255 and spill
#pragma unroll 1
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldmatrix_x4(ak, sK + kg * 16 * LD + a_frag_offset(lane, LD, kk * 16));
        ldmatrix_x4(av, sV + kg * 16 * LD + a_frag_offset(lane, LD, kk * 16));
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, tQ + b_frag_offset(lane, LD, half * 32 + nn * 16, kk * 16));
          ldmatrix_x4(bo, tdO + b_frag_offset(lane, LD, half * 32 + nn * 16, kk * 16));
          mma_bf16(st[2 * nn], ak, bq[0], bq[1]);
          mma_bf16(st[2 * nn + 1], ak, bq[2], bq[3]);
          mma_bf16(dpt[2 * nn], av, bo[0], bo[1]);
          mma_bf16(dpt[2 * nn + 1], av, bo[2], bo[3]);
        }
      }
      // this thread holds keys 16 kg + g (e = 0, 1) and + 8 (e = 2, 3),
      // queries 32 half + 8 t + 2 c + (e & 1)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int qi = half * 32 + 8 * t + 2 * c;
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qj = qi + (e & 1);
          p[e] = q0 + qj < N ? exp2f(st[t][e] * scale_log2 - tLse[qj] * kLog2e) : 0.f;
          ds[e] = p[e] * (dpt[t][e] - tDelta[qj]) * scale;
        }
        const int key = kg * 16 + g;
        *reinterpret_cast<uint32_t*>(sP + key * kLdP + qi) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sP + (key + 8) * kLdP + qi) = pack_bf16(p[2], p[3]);
        *reinterpret_cast<uint32_t*>(sdS + key * kLdP + qi) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(sdS + (key + 8) * kLdP + qi) = pack_bf16(ds[2], ds[3]);
      }
    }
    __syncthreads();

    // 2. dV += P^T dO or dK += dS^T Q: 4 query steps of 16, all D columns
    {
      const bf16* sA = (half == 0 ? sP : sdS) + kg * 16 * kLdP;
      const bf16* sB = half == 0 ? tdO : tQ;
#pragma unroll 1
      for (int kk = 0; kk < kB / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sA + a_frag_offset(lane, kLdP, kk * 16));
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, sB + bt_frag_offset(lane, LD, kk * 16, dn * 16));
          mma_bf16(acc[2 * dn], a, b[0], b[1]);
          mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
        }
      }
    }

    if (i + 1 < n_tiles) {
      __syncthreads();  // P^T, dS^T and this stage are consumed before they are refilled
      if (stages == 1) {
        load_q_tile<DP>(sQ, sdO, sLse, sDelta, q + head, dout + head, lse_h, delta_h,
                        (i + 1) * kB, N, D);
        cp_async_commit();
      }
    }
  }

  bf16* out = (half == 0 ? dv : dk) + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + kg * 16 + g + 8 * r;
    if (row >= N) continue;
    bf16* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int col = 8 * t + 2 * c;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(acc[t][2 * r], acc[t][2 * r + 1]);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int BH, int N,
                   int D, float scale, cudaStream_t stream) {
  const int k_tiles = (N + kB - 1) / kB;
  const int stages = N > kB ? 2 : 1;
  const size_t smem = bwd_smem_bytes(DP, stages);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tc_kernel<DP><<<BH * k_tiles, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), N, D, scale, k_tiles, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// q, k, v, dout, dk, dv: (BH, N, D) contiguous bf16 on 16-byte boundaries, D a
// multiple of 8 up to 256; lse, delta: (BH, N) fp32.
extern "C" int ddpm_flash_attn_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dk, void* dv, int BH,
                                          int N, int D, float scale, int device, void* stream) {
  if (BH < 1 || N < 1 || D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return ddpm::launch<64>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, s);
  if (D <= 128) return ddpm::launch<128>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, s);
  return ddpm::launch<256>(q, k, v, dout, lse, delta, dk, dv, BH, N, D, scale, s);
}
