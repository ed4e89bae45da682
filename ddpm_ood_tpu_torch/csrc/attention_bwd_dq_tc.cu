// Flash-attention backward dQ for bf16 on Hopper tensor cores, from the
// forward's per-row logsumexp. Q, K, V, dO, dQ are (BH, N, D) contiguous
// bf16, D a multiple of 8 up to 256; lse and delta = rowsum(dO * O) are
// (BH, N) fp32. fp32 inputs keep the CUDA-core kernel of csrc/attention_bwd.cu.
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (launched by _flash_bwd_impl). Same math:
//   p = exp(q k^T * scale - lse);  dS = p * (dO V^T - delta) * scale;
//   dQ = sum over key tiles of dS K.
// Like FlashAttention-2 and the dK/dV kernel, dS is rounded to bf16 before
// dS K (the TPU kernel multiplies fp32 operands); the plain version rounds
// nothing but the output.
//
// What bounds it on an H100: at the UNet's shapes (N = 64, D = 256, one head)
// it does ~N/2 = 32 flops per byte of Q, K, V, dO and dQ, far under the ~295
// flops/byte where bf16 tensor cores would bound it: bytes and latency bound
// it. The tensor cores take the arithmetic off the shared-memory path (the
// CUDA-core kernel formed S and dP by scalar FMAs from fp32 copies and did
// one FMA per two shared loads for dQ).
//
// Design, after the forward (csrc/attention_fwd_tc.cu): a block is 1, 2 or 4
// warps, each owning 16 query rows; key tiles are 64 wide. The Q and dO tile,
// their lse and delta, and the first K/V tile are issued together as
// zero-filling 16-byte cp.async copies into bf16 shared tiles (rows padded by
// 16 bytes, so ldmatrix is free of bank conflicts); with more than one key
// tile, the next K/V tile is double-buffered behind the current one's math.
// Each 64-key tile is taken in two 32-key halves, so S and dP need 16 fp32
// registers each beside the 128 of dQ at D = 256:
//   1. S = Q K^T and dP = dO V^T on mma.sync m16n8k16 (bf16 in, fp32 out),
//      Q and dO as A fragments (ldmatrix), K and V rows as B fragments;
//   2. p = exp2(S scale log2(e) - lse log2(e)) and dS = p (dP - delta) scale
//      in registers, rounded to bf16 and packed straight into the A
//      fragments of the next product (mma.cuh's C-to-A identity): dS never
//      touches shared memory;
//   3. dQ += dS K with K read by ldmatrix.trans as the B operand.
// The k-step loop of step 1 is left rolled: unrolled, its hoisted loads
// would push the registers past 255 beside the 128 accumulators (as in the
// dK/dV kernel). The launcher takes the tallest tile (64, 32 or 16 rows) that
// still gives every SM a block: BH = 128, N = 64 (training) runs 256 blocks
// of 2 warps with 101,632 bytes of dynamic shared memory (2 blocks per SM).
// Keys past N get p = 0; Q/dO rows and K/V rows past N load as zeros; rows
// past N are not stored; columns past D load as zeros and are not stored.
// Widths are compiled for DP = 64, 128 and 256.
#include "common.cuh"
#include "mma.cuh"

namespace ddpm {
namespace {

using bf16 = __nv_bfloat16;
using namespace tc;

constexpr int kBK = 64;       // keys per tile
constexpr int kMaxWarps = 4;  // 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr size_t dq_smem_bytes(int dp, int rows, int stages) {
  return static_cast<size_t>(2 * rows + 2 * stages * kBK) * (dp + kPad) * sizeof(bf16) +
         2 * rows * sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, int N, int D, float scale, int q_tiles,
                           int stages) {
  constexpr int LD = DP + kPad;
  constexpr int kNT = DP / 8;  // 8-wide column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;  // 16 query rows per warp
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + rows * LD;
  bf16* sKV = sdO + rows * LD;  // stage s: K at sKV + 2 s kBK LD, V after it
  float* sLse = reinterpret_cast<float*>(sKV + 2 * stages * kBK * LD);
  float* sDelta = sLse + rows;

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * rows;
  const size_t head = static_cast<size_t>(bh) * N * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (N + kBK - 1) / kBK;
  const float scale_log2 = scale * kLog2e;

  load_rows<DP>(sQ, q + head, q0, rows, N, D);
  load_rows<DP>(sdO, dout + head, q0, rows, N, D);
  load_row_stats(sLse, lse + static_cast<size_t>(bh) * N, q0, rows, N);
  load_row_stats(sDelta, delta + static_cast<size_t>(bh) * N, q0, rows, N);
  load_rows<DP>(sKV, k + head, 0, kBK, N, D);
  load_rows<DP>(sKV + kBK * LD, v + head, 0, kBK, N, D);
  cp_async_commit();

  float acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  // this thread's rows are 16 warp + g (r = 0) and + 8 (r = 1)
  float lse_log2[2], dlt[2];
  const bf16* sQw = sQ + warp * 16 * LD;
  const bf16* sdOw = sdO + warp * 16 * LD;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = stages == 2 ? (j & 1) : 0;
    if (stages == 2 && j + 1 < n_tiles) {
      bf16* next = sKV + (buf ^ 1) * 2 * kBK * LD;
      load_rows<DP>(next, k + head, (j + 1) * kBK, kBK, N, D);
      load_rows<DP>(next + kBK * LD, v + head, (j + 1) * kBK, kBK, N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse_log2[r] = sLse[warp * 16 + g + 8 * r] * kLog2e;
        dlt[r] = sDelta[warp * 16 + g + 8 * r];
      }
    }
    const bf16* sK = sKV + buf * 2 * kBK * LD;
    const bf16* sV = sK + kBK * LD;

#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      const int kh = hf * 32;  // first key of this half within the tile
      // 1. S and dP for this warp's 16 rows and 32 keys: 4 n-tiles of 8 each
      float s[4][4], dp[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t aq[4], ao[4];
        ldmatrix_x4(aq, sQw + a_frag_offset(lane, LD, kk * 16));
        ldmatrix_x4(ao, sdOw + a_frag_offset(lane, LD, kk * 16));
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, sK + b_frag_offset(lane, LD, kh + nn * 16, kk * 16));
          ldmatrix_x4(bv, sV + b_frag_offset(lane, LD, kh + nn * 16, kk * 16));
          mma_bf16(s[2 * nn], aq, bk[0], bk[1]);
          mma_bf16(s[2 * nn + 1], aq, bk[2], bk[3]);
          mma_bf16(dp[2 * nn], ao, bv[0], bv[1]);
          mma_bf16(dp[2 * nn + 1], ao, bv[2], bv[3]);
        }
      }

      // 2. p and dS; this thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3),
      // keys kh + 8 t + 2 c + (e & 1). n-tiles 2 kk and 2 kk + 1 are the A
      // fragment of key step kk.
      uint32_t a[2][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = j * kBK + kh + 8 * t + 2 * c + (e & 1) < N;
          const float p = key_ok ? exp2f(s[t][e] * scale_log2 - lse_log2[e / 2]) : 0.f;
          ds[e] = p * (dp[t][e] - dlt[e / 2]) * scale;
        }
        a[t / 2][2 * (t % 2)] = pack_bf16(ds[0], ds[1]);
        a[t / 2][2 * (t % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // 3. dQ += dS K: 2 key steps of 16, all D columns
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, sK + bt_frag_offset(lane, LD, kh + kk * 16, dn * 16));
          mma_bf16(acc[2 * dn], a[kk], b[0], b[1]);
          mma_bf16(acc[2 * dn + 1], a[kk], b[2], b[3]);
        }
      }
    }

    if (j + 1 < n_tiles) {
      __syncthreads();  // every warp is done with this buffer before it is refilled
      if (stages == 1) {
        load_rows<DP>(sKV, k + head, (j + 1) * kBK, kBK, N, D);
        load_rows<DP>(sKV + kBK * LD, v + head, (j + 1) * kBK, kBK, N, D);
        cp_async_commit();
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= N) continue;
    bf16* orow = dq + head + static_cast<size_t>(row) * D;
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
                   const float* lse, const float* delta, void* dq, int BH, int N, int D,
                   float scale, int sms, cudaStream_t stream) {
  // the tallest tile that still gives every SM a block
  int warps = kMaxWarps;
  while (warps > 1 && static_cast<long>(BH) * ((N + 16 * warps - 1) / (16 * warps)) < sms)
    warps /= 2;
  const int rows = 16 * warps;
  const int q_tiles = (N + rows - 1) / rows;
  const int stages = N > kBK ? 2 : 1;
  const size_t smem = dq_smem_bytes(DP, rows, stages);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<DP><<<BH * q_tiles, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), N, D, scale, q_tiles,
      stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// q, k, v, dout, dq: (BH, N, D) contiguous bf16 on 16-byte boundaries, D a
// multiple of 8 up to 256; lse, delta: (BH, N) fp32.
extern "C" int ddpm_flash_attn_bwd_dq_tc(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         void* dq, int BH, int N, int D, float scale, int device,
                                         void* stream) {
  if (BH < 1 || N < 1 || D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return ddpm::launch<64>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, sms, s);
  if (D <= 128) return ddpm::launch<128>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, sms, s);
  return ddpm::launch<256>(q, k, v, dout, lse, delta, dq, BH, N, D, scale, sms, s);
}
