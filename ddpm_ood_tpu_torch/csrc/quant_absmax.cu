// Per-tensor absmax of a bf16 or fp32 tensor, max |x| in fp32, into a
// 4-byte device scalar: the dynamic activation scale of int8 scoring
// (ddpm_ood_tpu/ops/quant.py:quantize_int8 with axes=None, whose
// jnp.max(jnp.abs(x)) this computes; qconv_s8.cu then scales it by 1 / 127).
//
// Replaces no Pallas kernel: the JAX package leaves this reduction to XLA
// inside its jitted sweep (ops/quant.py:40). The port needs it on the card
// because the scale must stay there: reading it back to the host would
// synchronise every quantised convolution.
//
// What bounds it on an H100: bytes. It reads each element once (2 or 4
// bytes) and does one max per element, far under any compute limit.
// Design: a grid-stride loop of 16-byte vector loads (8 bf16 or 4 fp32 a
// thread per step) where the tensor starts on a 16-byte boundary, scalar
// loads for the tail (and for the whole of a misaligned tensor); fmaxf of
// |x| in registers, a warp max by shuffles, a block max through shared
// memory, then one atomicMax per block on the float's bit pattern into the
// output. For values >= 0 the IEEE-754 bit patterns, read as signed ints,
// order as the floats do, so the integer max is the float max. The entry
// point zeroes the output on the stream before the launch (max |x| >= 0, so
// 0 is the identity).
// fmaxf drops NaN where x.abs().max() would return it; inputs are finite.
#include <stdint.h>

#include "common.cuh"

namespace ddpm {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float absmax8(const uint4& v, const __nv_bfloat16*) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(e[i])));
  return m;
}

__device__ __forceinline__ float absmax8(const uint4& v, const float*) {
  const float* e = reinterpret_cast<const float*>(&v);
  return fmaxf(fmaxf(fabsf(e[0]), fabsf(e[1])), fmaxf(fabsf(e[2]), fabsf(e[3])));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_absmax_kernel(const T* __restrict__ x, long long n, int vectorised,
                        int* __restrict__ out_bits) {
  constexpr int kPerVec = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float m = 0.0f;
  long long done = 0;
  if (vectorised) {
    const long long nvec = n / kPerVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = tid; i < nvec; i += stride) m = fmaxf(m, absmax8(__ldg(xv + i), x));
    done = nvec * kPerVec;
  }
  for (long long i = done + tid; i < n; i += stride) m = fmaxf(m, fabsf(to_f32(x[i])));

  __shared__ float warp_max_s[kThreads / 32];
  m = warp_max(m);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max_s[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max_s[lane] : 0.0f;
    m = warp_max(m);
    if (lane == 0) atomicMax(out_bits, __float_as_int(m));
  }
}

}  // namespace
}  // namespace ddpm

// x: n elements (dtype 0 fp32, 1 bf16); out: one fp32 on the same card,
// zeroed here first. Launches on `stream`; returns cudaGetLastError().
extern "C" int ddpm_quant_absmax(const void* x, long long n, int dtype, float* out, int device,
                                 void* stream) {
  if (n < 1 || (dtype != ddpm::kFloat32 && dtype != ddpm::kBFloat16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int elem = dtype == ddpm::kFloat32 ? 4 : 2;
  const long long per_block = static_cast<long long>(ddpm::kThreads) * (16 / elem);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // the grid-stride loop covers the rest
  const int vectorised = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, sizeof(float), s);
  if (err != cudaSuccess) return err;
  int* bits = reinterpret_cast<int*>(out);
  if (dtype == ddpm::kFloat32) {
    ddpm::quant_absmax_kernel<float><<<static_cast<int>(blocks), ddpm::kThreads, 0, s>>>(
        static_cast<const float*>(x), n, vectorised, bits);
  } else {
    ddpm::quant_absmax_kernel<__nv_bfloat16>
        <<<static_cast<int>(blocks), ddpm::kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), n, vectorised, bits);
  }
  return cudaGetLastError();
}
