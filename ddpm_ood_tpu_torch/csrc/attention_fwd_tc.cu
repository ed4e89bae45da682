// Flash-attention forward for bf16 on Hopper tensor cores: O = softmax(Q K^T *
// scale) V and the per-row logsumexp, by online softmax. Q, K, V, O are
// (BH, N, D) contiguous bf16, D a multiple of 8 up to 256; lse is (BH, N) fp32.
// fp32 inputs keep the CUDA-core kernel of csrc/attention.cu.
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_fwd). Same math: running row max m and row sum l in
// fp32, the accumulator rescaled by exp(m_prev - m_new) at every key tile,
// O = acc / l in bf16, lse = m + log(l). Like FlashAttention-2, the
// probabilities are rounded to bf16 before P V (the TPU kernel multiplies
// fp32 probabilities); the plain version rounds them too.
//
// What bounds it on an H100: at the UNet's shapes (N = 64 tokens, D = 256,
// one head) it does ~N/2 = 32 flops per byte of Q, K, V and O, far under the
// ~295 flops/byte where bf16 tensor cores would bound it: bytes and latency
// bound it. The tensor cores are here to take the arithmetic off the
// shared-memory path (the CUDA-core kernel did 4 FMAs per 5 shared loads from
// fp32 copies), not for their peak rate.
//
// Design: a block is 1, 2 or 4 warps, each owning 16 query rows; key tiles are
// 64 wide. The Q tile and the first K/V tile are issued together as 16-byte
// cp.async copies into bf16 shared tiles (rows padded by 16 bytes, so
// ldmatrix is free of bank conflicts); with more than one key tile, the next
// K/V tile is double-buffered behind the current one's math. S = Q K^T runs
// on mma.sync m16n8k16 (bf16 in, fp32 out) fed by ldmatrix; S, the running
// max and the running sum stay in registers (row reductions over the 4 lanes
// of a quad), P is rounded to bf16 A-fragments in registers and multiplied
// into V read by ldmatrix.trans. The logits never touch shared memory. At
// D = 256 a thread holds 128 fp32 accumulators of O. The launcher takes the
// tallest tile (64, 32 or 16 rows) that still gives at least one block per SM:
// BH = 128, N = 64 (training) runs 256 blocks of 2 warps with 84,480 bytes of
// dynamic shared memory (2 blocks per SM); BH = 64, N = 64 (scoring) 256
// blocks of 1 warp with 76,032 bytes (3 per SM). ptxas: 231 registers at
// DP = 256, no spills. Key columns past N get -inf logits; Q rows past N and K/V
// rows past N load as zeros; rows past N are not stored; columns past D load
// as zeros and are not stored. Widths are compiled for DP = 64, 128 and 256.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace ddpm {
namespace {

using bf16 = __nv_bfloat16;
using namespace tc;

constexpr int kBK = 64;       // keys per tile
constexpr int kMaxWarps = 4;  // 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr size_t fwd_smem_bytes(int dp, int rows, int stages) {
  return static_cast<size_t>(rows + 2 * stages * kBK) * (dp + kPad) * sizeof(bf16);
}

template <int DP>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int N, int D, float scale_log2, int q_tiles,
                        int stages) {
  constexpr int LD = DP + kPad;
  constexpr int kNT = DP / 8;  // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  const int rows = blockDim.x / 2;  // 16 query rows per warp
  bf16* sKV = sQ + rows * LD;       // stage s: K at sKV + 2 s kBK LD, V after it

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bh * q_tiles) * rows;
  const size_t head = static_cast<size_t>(bh) * N * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (N + kBK - 1) / kBK;

  load_rows<DP>(sQ, q + head, q0, rows, N, D);
  load_rows<DP>(sKV, k + head, 0, kBK, N, D);
  load_rows<DP>(sKV + kBK * LD, v + head, 0, kBK, N, D);
  cp_async_commit();

  float acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // finite, so exp2(m_prev - m_new) never sees inf - inf
  float l[2] = {0.f, 0.f};        // this thread's part of the row sums
  const bf16* sQw = sQ + warp * 16 * LD;

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
    const bf16* sK = sKV + buf * 2 * kBK * LD;
    const bf16* sV = sK + kBK * LD;

    // S = Q K^T for this warp's 16 rows and 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sQw + a_frag_offset(lane, LD, kk * 16));
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + b_frag_offset(lane, LD, nn * 16, kk * 16));
        mma_bf16(s[2 * nn], a, b[0], b[1]);
        mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // online softmax in log2 units; this thread holds rows g (e = 0, 1) and
    // g + 8 (e = 2, 3), columns 8 t + 2 c + (e & 1)
    const int k0 = j * kBK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * t + 2 * c + (e & 1) < N;
        s[t][e] = valid ? s[t][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[t][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = exp2f(s[t][e] - m[e / 2]);
        l[e / 2] += s[t][e];
      }
    }
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    // acc += P V: P's C fragments are the A fragments of 4 key steps of 16
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + bt_frag_offset(lane, LD, kk * 16, dn * 16));
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
    bf16* orow = o + head + static_cast<size_t>(row) * D;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int col = 8 * t + 2 * c;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
    }
    if (c == 0) lse[static_cast<size_t>(bh) * N + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int N, int D, float scale, int sms, cudaStream_t stream) {
  // the tallest tile that still gives every SM a block
  int warps = kMaxWarps;
  while (warps > 1 && static_cast<long>(BH) * ((N + 16 * warps - 1) / (16 * warps)) < sms)
    warps /= 2;
  const int rows = 16 * warps;
  const int q_tiles = (N + rows - 1) / rows;
  const int stages = N > kBK ? 2 : 1;
  const size_t smem = fwd_smem_bytes(DP, rows, stages);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<DP><<<BH * q_tiles, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, N, D, scale * kLog2e, q_tiles, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// q, k, v, o: (BH, N, D) contiguous bf16 on 16-byte boundaries, D a multiple
// of 8 up to 256; lse: (BH, N) fp32.
extern "C" int ddpm_flash_attn_fwd_tc(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int BH, int N, int D, float scale, int device,
                                      void* stream) {
  if (BH < 1 || N < 1 || D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return ddpm::launch<64>(q, k, v, o, lse, BH, N, D, scale, sms, s);
  if (D <= 128) return ddpm::launch<128>(q, k, v, o, lse, BH, N, D, scale, sms, s);
  return ddpm::launch<256>(q, k, v, o, lse, BH, N, D, scale, sms, s);
}
