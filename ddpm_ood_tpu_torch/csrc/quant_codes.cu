// The int8 codes of an activation under its per-tensor scale: q =
// clamp(rint(x / sx), -127, 127), sx = max|x| * float32(1 / 127) (1 where
// that is 0), written once into a channels-last s8 tensor whose channels are
// zero-padded to a multiple of 16, the layout csrc/qconv_s8.cu's product
// reads with 16-byte copies. The quantisation of
// ddpm_ood_tpu/ops/quant.py:quantize_int8 (axes=None) as its jitted program
// computes it, on the device scalar absmax = max|x| (csrc/quant_absmax.cu).
//
// Replaces no Pallas kernel: XLA fuses this into its s8 convolution's
// operand in the JAX package. The product kernel used to quantise on its own
// loads, once per window tap and per 128-wide output-column tile (9 to 18
// times an element at a 3x3 site), on the CUDA cores between its loads;
// made once here, the codes are an eighth (bf16) of what the product then
// re-reads, and they stay in the 50 MB L2 at the UNet's sizes.
//
// What bounds it on an H100: bytes. It reads each element once (2 or 4
// bytes) and writes one byte a padded channel: 0.0075 ms at level 0 of the
// headline's 64 images (16.8 MB in, 8.4 MB out, 3.35 TB/s).
// Design: a grid-stride loop over 8-channel chunks of a pixel, one or two
// 16-byte loads and one 8-byte store a chunk; a chunk past the real
// channels stores zeros. Cin must be a multiple of 8 and x start on a
// 16-byte boundary (the wrapper refuses anything else).
//
// Numerics: x / sx is the IEEE quotient rounded half to even (jnp.round). The
// product with 1 / sx stands in for it wherever the two round to the same
// integer, which `code` checks: |x / sx| <= 127 (1 + 2^-22) (sx is max|x|
// times a rounded 1 / 127), and the product with the rounded reciprocal lies
// within 1.5 * 2^-23 * 128 = 2.3e-5 of the rounded quotient, so outside a
// band of 2^-14 (a margin of 2.6x) around a half-integer the two round
// alike; inside it (and where 1 / sx is not finite) the code takes the
// quotient itself, __fdiv_rn, whose slow sequence would otherwise run for
// every element.
#include <stdint.h>

#include "common.cuh"

namespace ddpm {
namespace {

constexpr int kThreads = 256;
constexpr float kRecip127 = 0x1.020408p-7f;  // float32(1 / 127), ops/quant.py:RECIP_127
constexpr float kTieBand = 6.103515625e-05f;  // 2^-14

__device__ __forceinline__ uint32_t code(float x, float sx, float inv) {
  float y = __fmul_rn(x, inv);
  if (!(fabsf(fabsf(y - truncf(y)) - 0.5f) >= kTieBand)) y = __fdiv_rn(x, sx);
  const int q = __float2int_rn(y);
  return static_cast<uint32_t>(min(max(q, -127), 127)) & 0xffu;
}

// 8 consecutive elements as floats: one 16-byte load of bf16, two of fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_codes_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
                       int8_t* __restrict__ codes, unsigned pixels, unsigned cin,
                       unsigned cp) {
  float sx = __fmul_rn(*absmax, kRecip127);
  if (sx == 0.0f) sx = 1.0f;
  const float inv = __fdiv_rn(1.0f, sx);
  const unsigned chunks = cp / 8, total = pixels * chunks;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    const unsigned p = e / chunks, c = (e - p * chunks) * 8;
    uint32_t lo = 0, hi = 0;
    if (c < cin) {
      float v[8];
      load8(x + static_cast<size_t>(p) * cin + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= code(v[j], sx, inv) << (8 * j);
        hi |= code(v[j + 4], sx, inv) << (8 * j);
      }
    }
    *reinterpret_cast<uint2*>(codes + static_cast<size_t>(p) * cp + c) = make_uint2(lo, hi);
  }
}

}  // namespace
}  // namespace ddpm

// x (pixels, cin) bf16 (dtype 1) or fp32 (0), contiguous, on a 16-byte
// boundary; absmax one fp32 on the card; codes (pixels, cp) s8 with cp a
// multiple of 16 and cp >= cin, cin a multiple of 8, pixels * cp / 8 < 2^31.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int ddpm_quant_codes(const void* x, int dtype, const float* absmax, int8_t* codes,
                                long long pixels, int cin, int cp, int device, void* stream) {
  if (pixels < 1 || cin < 8 || cin % 8 != 0 || cp % 16 != 0 || cp < cin ||
      pixels * (cp / 8) >= (1LL << 31) || (dtype != ddpm::kFloat32 && dtype != ddpm::kBFloat16))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long total = pixels * (cp / 8);
  long long blocks = (total + ddpm::kThreads - 1) / ddpm::kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;  // the grid-stride loop covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned p = static_cast<unsigned>(pixels);
  if (dtype == ddpm::kFloat32)
    ddpm::quant_codes_kernel<float><<<static_cast<int>(blocks), ddpm::kThreads, 0, s>>>(
        static_cast<const float*>(x), absmax, codes, p, cin, cp);
  else
    ddpm::quant_codes_kernel<__nv_bfloat16><<<static_cast<int>(blocks), ddpm::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), absmax, codes, p, cin, cp);
  return cudaGetLastError();
}
