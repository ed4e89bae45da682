// int8 x int8 -> int32 channels-last convolution with the activation
// quantised on load and an fp32 dequantising epilogue: the arithmetic of
// ddpm_ood_tpu/ops/quant.py:qconv (and of qdot, as a 1x1 convolution over a
// (1, tokens, C) view) on Hopper's s8 tensor cores.
//
// Replaces no Pallas kernel: JAX runs this product as XLA convolutions and
// dots with preferred_element_type=int32 (ops/quant.py:62-90, :126-139). The
// port needs a kernel because PyTorch has no int8 convolution on CUDA, and a
// bf16 emulation would round the sums (they pass 2^24).
//
// Layout: x (B, D, H, W, Cin), 2D as D = 1, bf16 or fp32, contiguous; the
// weight codes (Np, Kp) s8 row-major with K = KD*KH*KW*Cin ordered (kd, kh,
// kw, cin), zero-padded to Np a multiple of kBN and Kp of kBK (the wrapper
// quantises and packs them once per load of the weights); sw (Cout,) fp32
// per-output-channel weight scales; bias (Cout,) fp32 or null; the device
// scalar absmax = max|x| (csrc/quant_absmax.cu). y (B, Do, Ho, Wo, Cout) in
// fp32, bf16, or (out dtype 2) the raw int32 sums, which the card check
// compares exactly. The output is a GEMM of M = B*Do*Ho*Wo rows, N = Cout
// columns and depth K: row m's K vector is the window of input positions
// (od*SD - PD + kd, ...) over all Cin channels, zero outside the input.
//
// Numerics, in JAX's order as its jitted program computes them: sx = max|x|
// * float32(1 / 127) (XLA turns the division by the constant 127 into that
// product), 1 where it is 0; each activation q = clamp(rint(x / sx), -127, 127) with x / sx the IEEE
// quotient (no fast math; the product with 1 / sx stands in for it only
// where both round to the same integer, see `code`) and rint rounding half
// to even as jnp.round does; exact int32 sums (|sum| <= K * 127^2 < 2^31 for K <
// 133,000); y = float(acc) * (sx * sw[n]) + bias[n] with __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA, then one round to bf16
// (round to nearest even) where the model computes in bf16.
//
// What bounds it on an H100: at the UNet's shapes the s8 work (2 ops a
// multiply-add, 1,979 TOPS dense) and the bf16 bytes in and out (3.35 TB/s)
// take about the same least time (level 0 at 64 images: 0.0098 ms of ops,
// 0.010 ms of bytes). This first kernel is simple and right, not near
// either: mma.sync (not wgmma) on register fragments, synchronous loads of
// the activation (they must be divided and rounded on the way, so cp.async
// cannot place them), and a scalar epilogue.
//
// Design: a block of 8 warps owns a 128 x 128 output tile; each warp a
// 64 x 32 sub-tile of int32 accumulators (4 x 4 fragments of
// mma.sync.m16n8k32.s8). K advances 64 at a time through double-buffered
// shared tiles (rows padded by 16 bytes, so ldmatrix is free of bank
// conflicts): while the tensor cores work on one, the next weight tile
// arrives by cp.async and the next activation tile is loaded into
// registers, then divided, rounded and packed into the other buffer. The s8
// fragment layout of m16n8k32 is, byte for byte, that of bf16 m16n8k16, so
// the bf16 ldmatrix offsets of mma.cuh serve, with a 32-byte k-step read
// as 16 b16 columns. A thread loads 8 consecutive channels of one window tap
// in one (bf16) or two (fp32) 16-byte loads, so Cin must be a multiple of 8
// and x must start on a 16-byte boundary (every UNet site's channel count is
// a multiple of 8, and its input a fresh tensor). Rows past M, columns past
// Cout and K past K are masked.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace ddpm {
namespace {

using namespace tc;

constexpr int kBM = 128, kBN = 128, kBK = 64;  // tile; kBK in s8 elements (bytes)
constexpr int kThreads = 256;                  // 8 warps: 2 along M x 4 along N
constexpr int kLdh = (kBK + 16) / 2;           // shared row stride in b16 units (80 bytes)
constexpr int kRows = kBM * kBK / 8 / kThreads;  // activation rows a thread loads: 4
constexpr int kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2;
constexpr float kRecip127 = 0x1.020408p-7f;  // float32(1 / 127), ops/quant.py:RECIP_127

// 8 consecutive elements of T as raw bits: one uint4 of bf16, two of fp32.
template <typename T>
struct Raw8 {
  uint4 v[sizeof(T) / 2];
};

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

__device__ __forceinline__ float elem(const Raw8<__nv_bfloat16>& r, int j) {
  const uint32_t w = word_of(r.v[0], j / 2);
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(
      j % 2 ? w >> 16 : w & 0xffffu)));
}

__device__ __forceinline__ float elem(const Raw8<float>& r, int j) {
  return __uint_as_float(word_of(r.v[j / 4], j % 4));
}

// Half the width of the band around a half-integer where x * (1 / sx) may
// round otherwise than x / sx: |x / sx| <= 127 (1 + 2^-22) (sx is max|x|
// times a rounded 1 / 127), and the product with the rounded reciprocal lies
// within 1.5 * 2^-23 * 128 = 2.3e-5 of the rounded quotient, so 2^-14 leaves
// a margin of 2.6x.
constexpr float kTieBand = 6.103515625e-05f;

// one activation code: rint(x / sx) (IEEE quotient, ties to even), clamped
// to +-127. The quotient's rint equals the product's wherever the product
// lies outside kTieBand of a half-integer; inside it (and where 1 / sx is
// not finite) the code takes the quotient itself, __fdiv_rn, whose slow
// sequence would otherwise run for every element.
__device__ __forceinline__ uint32_t code(float x, float sx, float inv) {
  float y = __fmul_rn(x, inv);
  if (!(fabsf(fabsf(y - truncf(y)) - 0.5f) >= kTieBand)) y = __fdiv_rn(x, sx);
  const int q = __float2int_rn(y);
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xffu;
}

// d += a * b for one 16x8x32 tile: s8 operands, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geometry {
  int B, D, H, W, Cin, Do, Ho, Wo, Cout, KD, KH, KW, SD, SH, SW, PD, PH, PW, Kp;
  int M, taps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    qconv_s8_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
                    const int8_t* __restrict__ wq, const float* __restrict__ sw,
                    const float* __restrict__ bias, void* __restrict__ y, int out_dtype,
                    Geometry g) {
  __shared__ __align__(16) uint16_t a_s[2][kBM * kLdh];
  __shared__ __align__(16) uint16_t b_s[2][kBN * kLdh];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // warp's 64-row, 32-column sub-tile
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  float sx = __fmul_rn(*absmax, kRecip127);
  if (sx == 0.0f) sx = 1.0f;
  const float inv = __fdiv_rn(1.0f, sx);

  // the activation rows this thread loads (tid / 8 + 32 i) and its 8 columns
  const int kv = (tid % 8) * 8;
  int id0[kRows], ih0[kRows], iw0[kRows];
  long long base[kRows];  // element offset of the row's sample, -1 past M
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + tid / 8 + 32 * i;
    int t = m;
    const int ow = t % g.Wo;
    t /= g.Wo;
    const int oh = t % g.Ho;
    t /= g.Ho;
    const int od = t % g.Do;
    const int b = t / g.Do;
    id0[i] = od * g.SD - g.PD;
    ih0[i] = oh * g.SH - g.PH;
    iw0[i] = ow * g.SW - g.PW;
    base[i] = m < g.M ? static_cast<long long>(b) * g.D * g.H * g.W * g.Cin : -1;
  }

  // load activation tile kt into registers (zeros outside the input)
  auto load_a = [&](int kt, Raw8<T> (&raw)[kRows]) {
    const int k = kt * kBK + kv;
    // the 8 columns share one tap: Cin % 8 == 0
    const int tap = k / g.Cin, c = k - tap * g.Cin;
    const int kd = tap / (g.KH * g.KW), rem = tap - kd * g.KH * g.KW;
    const int kh = rem / g.KW, kw = rem - kh * g.KW;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int id = id0[i] + kd, ih = ih0[i] + kh, iw = iw0[i] + kw;
      const bool ok = tap < g.taps && base[i] >= 0 && id >= 0 && id < g.D && ih >= 0 &&
                      ih < g.H && iw >= 0 && iw < g.W;
      const uint4* p = reinterpret_cast<const uint4*>(
          x + (ok ? base[i] + ((static_cast<long long>(id) * g.H + ih) * g.W + iw) * g.Cin + c
                  : 0));
#pragma unroll
      for (int v = 0; v < static_cast<int>(sizeof(T)) / 2; ++v)
        raw[i].v[v] = ok ? __ldg(p + v) : make_uint4(0, 0, 0, 0);
    }
  };

  // divide, round and pack registers into the shared activation tile
  auto store_a = [&](const Raw8<T> (&raw)[kRows], uint16_t* tile) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= code(elem(raw[i], j), sx, inv) << (8 * j);
        hi |= code(elem(raw[i], j + 4), sx, inv) << (8 * j);
      }
      *reinterpret_cast<uint2*>(tile + (tid / 8 + 32 * i) * kLdh + kv / 2) = make_uint2(lo, hi);
    }
  };

  // weight tile kt: 128 rows x 64 bytes, two 16-byte cp.async per thread
  auto load_b = [&](int kt, uint16_t* tile) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * kThreads;
      const int n = e / 4, col = (e % 4) * 16;
      cp_async_16(tile + n * kLdh + col / 2,
                  wq + static_cast<long long>(n0 + n) * g.Kp + kt * kBK + col, true);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = 0;

  const int kt_count = g.Kp / kBK;
  Raw8<T> raw[kRows];
  load_a(0, raw);
  load_b(0, b_s[0]);
  store_a(raw, a_s[0]);
  cp_async_wait<0>();
  __syncthreads();

  for (int kt = 0; kt < kt_count; ++kt) {
    const int cur = kt % 2;
    const bool more = kt + 1 < kt_count;
    if (more) {
      load_a(kt + 1, raw);
      load_b(kt + 1, b_s[cur ^ 1]);
    }
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {  // 32-byte k-steps, 16 b16 columns each
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], a_s[cur] + (wm * 64 + mi * 16) * kLdh +
                               a_frag_offset(lane, kLdh, ks * 16));
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s[cur] + b_frag_offset(lane, kLdh, wn * 32 + nb * 16, ks * 16));
        b[2 * nb][0] = r[0];
        b[2 * nb][1] = r[1];
        b[2 * nb + 1][0] = r[2];
        b[2 * nb + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_s8(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
    if (more) {
      store_a(raw, a_s[cur ^ 1]);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  // epilogue: fragment c0, c1 = rows g, columns 2t, 2t+1; c2, c3 = row g + 8
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + wm * 64 + mi * 16 + gq + (r >= 2 ? 8 : 0);
      if (m >= g.M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn * 32 + nj * 8 + 2 * tq + (r % 2);
        if (n >= g.Cout) continue;
        const long long o = static_cast<long long>(m) * g.Cout + n;
        const int s = acc[mi][nj][r];
        if (out_dtype == kOutI32) {
          static_cast<int*>(y)[o] = s;
          continue;
        }
        float v = __fmul_rn(__int2float_rn(s), __fmul_rn(sx, sw[n]));
        if (bias != nullptr) v = __fadd_rn(v, bias[n]);
        if (out_dtype == kOutBF16)
          static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(y)[o] = v;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* absmax, const int8_t* wq, const float* sw,
                   const float* bias, void* y, int out_dtype, const Geometry& g,
                   cudaStream_t s) {
  const dim3 grid((g.M + kBM - 1) / kBM, (g.Cout + kBN - 1) / kBN);
  qconv_s8_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), absmax, wq, sw, bias,
                                               y, out_dtype, g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// Shapes as the header says: geo = B, D, H, W, Cin, Do, Ho, Wo, Cout, KD, KH,
// KW, SD, SH, SW, PD, PH, PW, Kp (19 ints). in_dtype 0 fp32, 1 bf16;
// out_dtype 0 fp32, 1 bf16, 2 int32 sums. wq holds ceil(Cout / 128) * 128
// rows of Kp bytes. Cin must be a multiple of 8 and x, like wq, must start on
// a 16-byte boundary (16-byte loads). Returns cudaGetLastError() after the
// launch.
extern "C" int ddpm_qconv_s8(const void* x, int in_dtype, const float* absmax,
                             const int8_t* wq, const float* sw, const float* bias, void* y,
                             int out_dtype, const int* geo, int device, void* stream) {
  ddpm::Geometry g{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  geo[5],  geo[6],
                   geo[7],  geo[8],  geo[9],  geo[10], geo[11], geo[12], geo[13],
                   geo[14], geo[15], geo[16], geo[17], geo[18], 0,       0};
  const long long m = static_cast<long long>(g.B) * g.Do * g.Ho * g.Wo;
  const long long taps = static_cast<long long>(g.KD) * g.KH * g.KW;
  if (g.B < 1 || g.D < 1 || g.H < 1 || g.W < 1 || g.Cin < 1 || g.Do < 1 || g.Ho < 1 ||
      g.Wo < 1 || g.Cout < 1 || taps < 1 || g.SD < 1 || g.SH < 1 || g.SW < 1 ||
      m >= (1LL << 31) || g.Kp % ddpm::kBK != 0 || g.Kp < taps * g.Cin ||
      taps * g.Cin >= 133000 || (in_dtype != ddpm::kFloat32 && in_dtype != ddpm::kBFloat16) ||
      out_dtype < 0 || out_dtype > 2 || g.Cin % 8 != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return cudaErrorMisalignedAddress;
  g.M = static_cast<int>(m);
  g.taps = static_cast<int>(taps);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == ddpm::kFloat32)
    return ddpm::launch<float>(x, absmax, wq, sw, bias, y, out_dtype, g, s);
  return ddpm::launch<__nv_bfloat16>(x, absmax, wq, sw, bias, y, out_dtype, g, s);
}
