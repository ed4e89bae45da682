// Fused GroupNorm (+ optional SiLU) forward over channel-last activations,
// one block per (sample, group). The main paths take the cluster kernel of
// csrc/groupnorm_cluster.cu; this one serves the shapes its plan refuses
// (ops/groupnorm.py:cluster_plan): a sample over 8 blocks' shared memory, C
// not a whole number of 16-byte vectors, or x off a 16-byte boundary.
//
// Replaces the TPU kernel ddpm_ood_tpu/ops/groupnorm.py:_gn_kernel (launched
// by _pallas_fwd). Same math: per (sample, group) fp32 sums of x and x^2,
// var = E[x^2] - mean^2, rstd = rsqrt(var + eps), fp32 affine, optional
// SiLU, output in the input dtype.
//
// What bounds it on an H100: bytes. The op does ~10 flops per element against
// 4-8 bytes moved (read twice, write once), far below the ~295 flops/byte a
// Hopper card needs before compute matters.
//
// Design: the TPU kernel keeps one whole sample (N x C) in VMEM; one
// small-UNet sample at 32x32 is 1024 x 384 x 2 B = 768 KB, over a block's
// 227 KB of shared memory, so that does not carry over. Here one block owns
// one (sample, group) slice of N x C/G elements and keeps nothing in shared
// memory but the reduction: pass 1 reduces the fp32 sums in registers, warp
// shuffles and a 32-slot scratch; pass 2 re-reads the slice (now L2-hot: a
// slice is at most a few tens of KB and the card has 50 MB of L2), normalises
// and writes. The grid of B x G blocks (2048 at the main path's batch of 64)
// fills the 132 SMs many times over. Neighbouring groups are neighbouring
// blocks, so the 32-byte sectors a slice row only partly uses are shared
// through L2 rather than fetched again from HBM. Any (N, C, G) with C % G == 0
// works: there is no lane-alignment gate as on the TPU.
#include "common.cuh"

namespace ddpm {
namespace {

constexpr int kGnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGnThreads)
    groupnorm_act_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ out, int N, int C,
                         int G, float eps, int act) {
  const int b = blockIdx.x / G;
  const int g = blockIdx.x - b * G;
  const int cpg = C / G;
  const int count = N * cpg;
  const size_t base = static_cast<size_t>(b) * N * C + static_cast<size_t>(g) * cpg;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < count; i += kGnThreads) {
    const int n = i / cpg;
    const float v = to_f32(x[base + static_cast<size_t>(n) * C + (i - n * cpg)]);
    s1 += v;
    s2 += v * v;
  }

  __shared__ float red1[kGnThreads / 32];
  __shared__ float red2[kGnThreads / 32];
  __shared__ float stats[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red1[warp] = s1;
    red2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kGnThreads / 32 ? red1[lane] : 0.f;
    s2 = lane < kGnThreads / 32 ? red2[lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float inv_count = 1.f / static_cast<float>(count);
      const float mean = s1 * inv_count;
      const float var = s2 * inv_count - mean * mean;
      stats[0] = mean;
      stats[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0];
  const float rstd = stats[1];

  for (int i = threadIdx.x; i < count; i += kGnThreads) {
    const int n = i / cpg;
    const int c = i - n * cpg;
    const size_t idx = base + static_cast<size_t>(n) * C + c;
    const int ch = g * cpg + c;
    float y = (to_f32(x[idx]) - mean) * rstd * gamma[ch] + beta[ch];
    if (act) y = y / (1.f + expf(-y));  // SiLU: y * sigmoid(y)
    out[idx] = from_f32<T>(y);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta, void* out, int B,
                   int N, int C, int G, float eps, int act, cudaStream_t stream) {
  groupnorm_act_kernel<T><<<B * G, kGnThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), N, C, G, eps, act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// x, out: (B, N, C) contiguous, channel-last; gamma, beta: (C,) fp32.
extern "C" int ddpm_groupnorm_act(const void* x, const float* gamma, const float* beta,
                                  void* out, int B, int N, int C, int G, float eps, int act,
                                  int dtype, int device, void* stream) {
  if (B < 1 || N < 1 || G < 1 || C < G || C % G != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ddpm::kFloat32:
      return ddpm::launch<float>(x, gamma, beta, out, B, N, C, G, eps, act, s);
    case ddpm::kBFloat16:
      return ddpm::launch<__nv_bfloat16>(x, gamma, beta, out, B, N, C, G, eps, act, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ddpm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
