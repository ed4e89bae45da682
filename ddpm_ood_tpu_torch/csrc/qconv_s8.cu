// int8 x int8 -> int32 channels-last convolution with an fp32 dequantising
// epilogue, on Hopper's warpgroup s8 tensor cores: the arithmetic of
// ddpm_ood_tpu/ops/quant.py:qconv (and of qdot, as a 1x1 convolution over a
// (1, tokens, C) view). Its activation operand is the codes that
// csrc/quant_codes.cu makes once a call.
//
// Replaces no Pallas kernel: JAX runs this product as XLA convolutions and
// dots with preferred_element_type=int32 (ops/quant.py:62-90, :126-139). The
// port needs a kernel because PyTorch has no int8 convolution on CUDA, and a
// bf16 emulation would round the sums (they pass 2^24).
//
// Layout: codes (B, D, H, W, Cp) s8, 2D as D = 1, Cp the channels padded with
// zeros to a multiple of 16; the weight codes packed by ops/quant.py:
// pack_weight, (ceil(Cout / 128), Kp / 128) blocks of 128 output channels
// by 128 bytes of K, K ordered (kd, kh, kw, c) with each tap's channels
// zero-padded to a multiple of 128 (so a K slice is one tap's), each block
// already in the 128-byte-swizzled layout of sm90.cuh so that one bulk copy
// places it; sw (Cout,) fp32 per-output-channel weight scales; bias (Cout,)
// fp32 or null; the device scalar absmax = max|x| (csrc/quant_absmax.cu).
// y (B, Do, Ho, Wo, Cout) in fp32, bf16, or (out dtype 2) the raw int32
// sums, which the card check compares exactly. The output is a GEMM of M =
// B*Do*Ho*Wo rows, N = Cout columns and depth K: row m's K vector is the
// window of input positions (od*SD - PD + kd, ...) over all channels, zero
// outside the input.
//
// Numerics, in JAX's order as its jitted program computes them: exact int32
// sums (|sum| <= K * 127^2 < 2^31 for K < 133,000); y = float(acc) * (sx *
// sw[n]) + bias[n] with sx = max|x| * float32(1 / 127) (1 where it is 0),
// __fmul_rn and __fadd_rn, which nvcc never contracts into an FMA, then one
// round to bf16 (round to nearest even) where the model computes in bf16.
//
// What bounds it on an H100: at the UNet's shapes the s8 work (2 ops a
// multiply-add, 1,979 TOPS dense) and the bytes in and out (3.35 TB/s) take
// about the same least time (level 0 at 64 images: 0.0098 ms of ops). The
// kernel this design replaces (mma.sync m16n8k32) reached 4.5% of it: it quantised
// each activation on the CUDA cores once per window tap and per 128-column
// tile, between synchronous loads, fed mma.sync from one block an SM, and
// stored its results a scalar at a time. What this design does about each:
//
// - The codes are made once a call (quant_codes.cu), so the product's
//   operands are plain bytes, which TMA places: the weight block by one bulk
//   copy, the activation slice by TMA's im2col mode (a 5D map of the codes,
//   BM output positions by 128 channels of one window tap, the padding and
//   the channels past Cp read as zeros, strides as the map's traversal
//   steps). Threads spend nothing on addresses: in a cp.async version of
//   the activation loads the issuing threads, not the tensor cores, set the
//   pace of every slice.
// - wgmma.mma_async m64nNk32 .s32.s8.s8, both operands from 128-byte-swizzled
//   shared memory through descriptors.
// - A persistent grid, one 384-thread block an SM, walks BM x BN output
//   tiles (columns fastest, so tiles sharing rows of the codes run together
//   and meet them in L2): 256 x 128 where Cout <= 128, 128 x 256 above, a
//   quarter less L2 traffic an operation than 128 x 128, which it keeps
//   where it fills the SMs in fewer waves (a short M). One producer thread
//   keeps a 3- or 4-stage mbarrier ring of 128-byte-deep K slices in flight;
//   two consumer warpgroups (setmaxnreg: 232 registers, the producer 40)
//   each own BM / 2 rows and release a stage once the next slice's product
//   is issued.
// - The epilogue reads each column's factors from a table made once a block,
//   converts with no branch in the loop (a branch a value cost several
//   times the arithmetic in reconvergence), stages bf16 in 128-byte-swizzled boxes
//   (conflict-free pair stores) and leaves by TMA tensor stores, so the
//   warpgroup starts its next tile while they drain. fp32 and int32 outputs
//   (checks, fp32 runs) store from the fragments.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "sm90.cuh"

namespace ddpm {
namespace {

using namespace sm90;

constexpr int kBK = 128;       // bytes (s8 elements) of K a stage: one tap's 128 channels
constexpr int kBlock = 128;    // rows of a packed weight block (ops/quant.py:TILE_N)
constexpr int kConsumers = 2;  // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kOutBF16 = 1, kOutI32 = 2;
constexpr int kMaxCout = 1024;  // columns whose dequantising factors sit in shared memory
constexpr float kRecip127 = 0x1.020408p-7f;  // float32(1 / 127), ops/quant.py:RECIP_127

// a BM x BN output tile: each consumer warpgroup owns BM / 2 rows (one or
// two wgmma m64 blocks) by all BN columns
template <int BM, int BN>
struct Tile {
  static constexpr int kStages = BM * BN == 128 * 128 ? 4 : 3;
  static constexpr int kRows = BM / kConsumers;  // a consumer warpgroup's rows
  static constexpr int kMI = kRows / 64;         // its m64 blocks
  static constexpr int kBox = kRows * 128;       // a staged box: 64 bf16 columns of kRows rows
  struct Smem {
    uint8_t a[kStages][BM * kBK];  // each 1024-byte aligned: the swizzle's period
    uint8_t b[kStages][BN * kBK];
    uint8_t out[kConsumers][BN / 64][kBox];  // bf16 output boxes, 128-byte swizzled
    float scale[kMaxCout + 256], bias[kMaxCout + 256];  // sx * sw[n] and bias[n], 0 past Cout
    uint64_t full[kStages], empty[kStages];
  };
  static constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + room to align the base
};

struct Geometry {
  int B, D, H, W, Cp, Do, Ho, Wo, Cout, KD, KH, KW, SD, SH, SW, PD, PH, PW, Kp;
  int M, n_tiles, tiles, kt_count, c_slices, n_blocks;
};

// byte offset of bf16 column `col` (< 64) of row r in a 128-byte-swizzled box
__device__ __forceinline__ int box_offset(int r, int col) {
  return r * 128 + (((col >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// a box of staged bf16 rows to y at (column c, row m) by TMA, in this
// thread's bulk group; rows and columns past y's edge are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c,
                                             int m) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(m)
      : "memory");
}

// one K slice of the activation: BM output positions (from the tile's
// first, in (n, d, h, w) order) by 128 channels from c of window tap (kw,
// kh, kd), by TMA's im2col mode into a 128-byte-swizzled tile; positions
// outside the input (the padding) and channels past Cp read as zeros
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c, int w, int h, int d, int n, uint16_t kw,
                                           uint16_t kh, uint16_t kd) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2], {%8, %9, %10};\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(w), "r"(h), "r"(d),
      "r"(n), "h"(kw), "h"(kh), "h"(kd)
      : "memory");
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    qconv_s8_kernel(const __grid_constant__ CUtensorMap codes,
                    const __grid_constant__ CUtensorMap out_map, const float* __restrict__ absmax,
                    const int8_t* __restrict__ wq, const float* __restrict__ sw,
                    const float* __restrict__ bias, void* __restrict__ y, int out_dtype,
                    Geometry g) {
  using T = Tile<BM, BN>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  auto& s = *reinterpret_cast<typename T::Smem*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);  // the producer's arrival, then the copies' bytes
      mbar_init(&s.empty[i], kConsumers * 4);  // a consumer warp each
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ----
    setmaxnreg_dec<40>();
    if (t != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      const int mt = tile / g.n_tiles, nt = tile - mt * g.n_tiles;
      int r = mt * BM;  // the tile's first output position, as (n, od, oh, ow)
      const int ow = r % g.Wo;
      r /= g.Wo;
      const int oh = r % g.Ho;
      r /= g.Ho;
      const int od = r % g.Do;
      const int n = r / g.Do;
      const int w0 = ow * g.SW - g.PW, h0 = oh * g.SH - g.PH, d0 = od * g.SD - g.PD;
      // the packed weight blocks of this tile's columns (the last may lack some)
      const int block0 = nt * (BN / kBlock);
      const int blocks = min(BN / kBlock, g.n_blocks - block0);
      int c = 0, kw = 0, kh = 0, kd = 0;  // slice kt's channels and window tap
      for (int kt = 0; kt < g.kt_count; ++kt) {
        mbar_wait(&s.empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&s.full[stage], BM * kBK + blocks * kBlock * kBK);
        tma_im2col(s.a[stage], &codes, &s.full[stage], c, w0, h0, d0, n, kw, kh, kd);
        for (int j = 0; j < blocks; ++j)
          bulk_copy_g2s(s.b[stage] + j * kBlock * kBK,
                        wq + (static_cast<size_t>(block0 + j) * g.kt_count + kt) * kBlock * kBK,
                        kBlock * kBK, &s.full[stage]);
        if ((c += kBK) >= g.Cp) {
          c = 0;
          if (++kw == g.KW) {
            kw = 0;
            if (++kh == g.KH) {
              kh = 0;
              ++kd;
            }
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  setmaxnreg_inc<232>();
  const int warp = t / 32, lane = t % 32;
  float sx = __fmul_rn(*absmax, kRecip127);
  if (sx == 0.0f) sx = 1.0f;
  // every column's dequantising factors, once a block (the first stages
  // are on their way meanwhile); past kMaxCout the epilogue reads them itself
  const bool cached = g.Cout <= kMaxCout;
  if (cached) {
    const int span = (g.Cout + 255) / 256 * 256;
    for (int n = threadIdx.x; n < span; n += 128 * kConsumers) {
      s.scale[n] = n < g.Cout ? __fmul_rn(sx, sw[n]) : 0.0f;
      s.bias[n] = bias != nullptr && n < g.Cout ? bias[n] : 0.0f;
    }
  }
  named_barrier(1 + kConsumers, 128 * kConsumers);
  const bool bf16 = out_dtype == kOutBF16;
  // bf16 boxes leave by TMA where y's rows are whole 16-byte chunks
  const bool tma_rows = bf16 && (g.Cout * 2) % 16 == 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const int mt = tile / g.n_tiles, nt = tile - mt * g.n_tiles;
    const int m0 = mt * BM + wg * T::kRows, n0 = nt * BN;
    int acc[T::kMI][BN / 2];
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0;
    int prev = -1;  // the stage whose product may still be in flight
    for (int kt = 0; kt < g.kt_count; ++kt) {
      mbar_wait(&s.full[stage], phase);
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[mi][i]);
      wgmma_fence();
      const uint8_t* a = s.a[stage] + wg * T::kRows * kBK;
      const uint8_t* b = s.b[stage];
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks)
#pragma unroll
        for (int mi = 0; mi < T::kMI; ++mi)
          wgmma_s8<BN>(acc[mi], desc_sw128(a + mi * 64 * kBK + 32 * ks), desc_sw128(b + 32 * ks),
                       1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's product is done: release its stage
      if (prev >= 0 && lane == 0) mbar_arrive(&s.empty[prev]);
      prev = stage;
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[mi][i]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[mi][i]);
    if (lane == 0) mbar_arrive(&s.empty[prev]);

    // epilogue: JAX's dequantisation of each sum, then bf16 rows through the
    // staging tile (bulk copies), or fp32 / int32 values straight from the
    // fragments
    bulk_wait_read();            // this thread's stores of the last tile have left
    named_barrier(1 + wg, 128);  // ... so the staged boxes are free
    const int rows = min(T::kRows, g.M - m0);
    if (bf16 && cached) {
      // the main path: no branch in the loop (a branch per value here costs
      // its reconvergence, several times the arithmetic)
      const bool has_bias = bias != nullptr;
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * (lane % 4);
          const float2 sc = *reinterpret_cast<const float2*>(&s.scale[n0 + col]);
          const float2 bi = *reinterpret_cast<const float2*>(&s.bias[n0 + col]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mi * 64 + warp * 16 + lane / 4 + 8 * h;  // in the warpgroup's rows
            float v0 = __fmul_rn(__int2float_rn(acc[mi][4 * i + 2 * h]), sc.x);
            float v1 = __fmul_rn(__int2float_rn(acc[mi][4 * i + 2 * h + 1]), sc.y);
            const float b0 = __fadd_rn(v0, bi.x), b1 = __fadd_rn(v1, bi.y);
            v0 = has_bias ? b0 : v0;
            v1 = has_bias ? b1 : v1;
            *reinterpret_cast<uint32_t*>(s.out[wg][i / 8] + box_offset(row, col % 64)) =
                tc::pack_bf16(v0, v1);
          }
        }
      }
    } else {
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int col = 8 * i + 2 * (lane % 4), n = n0 + col;
          float2 sc, bi;
          if (cached) {
            sc = *reinterpret_cast<const float2*>(&s.scale[n]);
            bi = *reinterpret_cast<const float2*>(&s.bias[n]);
          } else {
            sc.x = n < g.Cout ? __fmul_rn(sx, sw[n]) : 0.0f;
            sc.y = n + 1 < g.Cout ? __fmul_rn(sx, sw[n + 1]) : 0.0f;
            bi.x = bias != nullptr && n < g.Cout ? bias[n] : 0.0f;
            bi.y = bias != nullptr && n + 1 < g.Cout ? bias[n + 1] : 0.0f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mi * 64 + warp * 16 + lane / 4 + 8 * h;
            const int a0 = acc[mi][4 * i + 2 * h], a1 = acc[mi][4 * i + 2 * h + 1];
            float v0 = __fmul_rn(__int2float_rn(a0), sc.x);
            float v1 = __fmul_rn(__int2float_rn(a1), sc.y);
            if (bias != nullptr) {
              v0 = __fadd_rn(v0, bi.x);
              v1 = __fadd_rn(v1, bi.y);
            }
            if (bf16) {
              *reinterpret_cast<uint32_t*>(s.out[wg][i / 8] + box_offset(row, col % 64)) =
                  tc::pack_bf16(v0, v1);
            } else if (row < rows) {
              const size_t o = static_cast<size_t>(m0 + row) * g.Cout + n;
              if (n < g.Cout) {
                if (out_dtype == kOutI32)
                  static_cast<int*>(y)[o] = a0;
                else
                  static_cast<float*>(y)[o] = v0;
              }
              if (n + 1 < g.Cout) {
                if (out_dtype == kOutI32)
                  static_cast<int*>(y)[o + 1] = a1;
                else
                  static_cast<float*>(y)[o + 1] = v1;
              }
            }
          }
        }
      }
    }
    if (bf16) {
      const int ncols = min(BN, g.Cout - n0);
      if (tma_rows) {
        fence_proxy_async();  // the staged boxes, for TMA's reads
        named_barrier(1 + wg, 128);
        if (t == 0 && rows > 0) {
          for (int bx = 0; bx * 64 < ncols; ++bx)
            tma_store_2d(&out_map, s.out[wg][bx], n0 + 64 * bx, m0);
          bulk_commit();
        }
      } else {
        named_barrier(1 + wg, 128);
        uint16_t* ybase = static_cast<uint16_t*>(y) + static_cast<size_t>(m0) * g.Cout + n0;
        for (int e = t; e < rows * ncols; e += 128) {
          const int r = e / ncols, c = e - r * ncols;
          ybase[static_cast<size_t>(r) * g.Cout + c] = *reinterpret_cast<const uint16_t*>(
              s.out[wg][c / 64] + box_offset(r, c % 64));
        }
      }
    }
  }
  bulk_wait();  // the last rows are written before the block ends
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// a libcuda entry point, looked up by name (the library links the runtime only)
void* libcuda_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p : nullptr;
}

EncodeIm2col encode_im2col() {
  static const auto fn = reinterpret_cast<EncodeIm2col>(libcuda_fn("cuTensorMapEncodeIm2col"));
  return fn;
}

EncodeTiled encode_tiled() {
  static const auto fn = reinterpret_cast<EncodeTiled>(libcuda_fn("cuTensorMapEncodeTiled"));
  return fn;
}

// y as a (Cout, M) bf16 matrix, written in boxes of 64 columns by `rows`
// rows from 128-byte-swizzled staging; an unused map where y's rows are not
// whole 16-byte chunks
cudaError_t encode_out(CUtensorMap* map, void* y, const Geometry& g, int rows) {
  if ((g.Cout * 2) % 16 != 0) return cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.Cout), static_cast<cuuint64_t>(g.M)};
  const cuuint64_t strides[1] = {dims[0] * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(rows)}, steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// the codes as a (C, W, H, D, N) tensor of bytes, read `pixels` output
// positions by 128 channels at a time, each spatial axis at its stride, the
// window's reach given by the box corners
cudaError_t encode_codes(CUtensorMap* map, const int8_t* xq, const Geometry& g, int pixels,
                         int cuda_version) {
  const EncodeIm2col encode = encode_im2col();
  if (encode == nullptr) return cudaErrorNotSupported;
  // the high pads that the output size implies
  const int hi_w = (g.Wo - 1) * g.SW + g.KW - g.W - g.PW;
  const int hi_h = (g.Ho - 1) * g.SH + g.KH - g.H - g.PH;
  const int hi_d = (g.Do - 1) * g.SD + g.KD - g.D - g.PD;
  const int lower[3] = {-g.PW, -g.PH, -g.PD};
  const int upper[3] = {hi_w - (g.KW - 1), hi_h - (g.KH - 1), hi_d - (g.KD - 1)};
  for (int i = 0; i < 3; ++i)  // a 5D im2col map's corner range
    if (lower[i] < -16 || lower[i] > 15 || upper[i] < -16 || upper[i] > 15)
      return cudaErrorInvalidValue;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(g.Cp), static_cast<cuuint64_t>(g.W),
                              static_cast<cuuint64_t>(g.H), static_cast<cuuint64_t>(g.D),
                              static_cast<cuuint64_t>(g.B)};
  const cuuint64_t strides[4] = {dims[0], dims[0] * dims[1], dims[0] * dims[1] * dims[2],
                                 dims[0] * dims[1] * dims[2] * dims[3]};
  const cuuint32_t steps[5] = {1, static_cast<cuuint32_t>(g.SW), static_cast<cuuint32_t>(g.SH),
                               static_cast<cuuint32_t>(g.SD), 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<int8_t*>(xq), dims, strides, lower,
             upper, kBK, pixels, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // libcuda up to 13.1 mis-sets one bit of the map of a tensor under 128 KB
  // (CUTLASS clears it in make_im2col_tma_copy_desc)
  if (cuda_version <= 13010 && strides[3] * dims[4] < 131072)
    reinterpret_cast<uint64_t*>(map)[1] &= ~(1ull << 21);
  return cudaSuccess;
}

template <int BM, int BN>
cudaError_t launch(const int8_t* xq, const float* absmax, const int8_t* wq, const float* sw,
                   const float* bias, void* y, int out_dtype, Geometry g, int sms, int cuda_version,
                   cudaStream_t stream) {
  g.n_tiles = (g.Cout + BN - 1) / BN;
  g.tiles = ((g.M + BM - 1) / BM) * g.n_tiles;
  alignas(64) CUtensorMap map, out_map = {};
  cudaError_t err = encode_codes(&map, xq, g, BM, cuda_version);
  if (err == cudaSuccess && out_dtype == kOutBF16)
    err = encode_out(&out_map, y, g, Tile<BM, BN>::kRows);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(qconv_s8_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<BM, BN>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = g.tiles < sms ? g.tiles : sms;
  qconv_s8_kernel<BM, BN><<<grid, kThreads, Tile<BM, BN>::kSmemBytes, stream>>>(
      map, out_map, absmax, wq, sw, bias, y, out_dtype, g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ddpm

// Shapes as the header says: geo = B, D, H, W, Cp, Do, Ho, Wo, Cout, KD, KH,
// KW, SD, SH, SW, PD, PH, PW, Kp (19 ints; P* the low pads, the high ones
// follow from the output size). out_dtype 0 fp32, 1 bf16, 2 int32 sums. wq
// holds ceil(Cout / 128) * Kp / 128 packed blocks of 16 KB, Kp = taps *
// ceil(Cp / 128) * 128. Cp must be a multiple of 16, and xq and wq must start
// on 16-byte boundaries. Returns cudaGetLastError() after the launch.
extern "C" int ddpm_qconv_s8(const int8_t* xq, const float* absmax, const int8_t* wq,
                             const float* sw, const float* bias, void* y, int out_dtype,
                             const int* geo, int device, void* stream) {
  ddpm::Geometry g{geo[0],  geo[1],  geo[2],  geo[3],  geo[4],  geo[5],  geo[6],
                   geo[7],  geo[8],  geo[9],  geo[10], geo[11], geo[12], geo[13],
                   geo[14], geo[15], geo[16], geo[17], geo[18], 0,       0,
                   0,       0,       0,       0};
  const long long m = static_cast<long long>(g.B) * g.Do * g.Ho * g.Wo;
  const long long taps = static_cast<long long>(g.KD) * g.KH * g.KW;
  g.c_slices = (g.Cp + ddpm::kBK - 1) / ddpm::kBK;
  if (g.B < 1 || g.D < 1 || g.H < 1 || g.W < 1 || g.Cp < 16 || g.Cp % 16 != 0 || g.Do < 1 ||
      g.Ho < 1 || g.Wo < 1 || g.Cout < 1 || taps < 1 || g.SD < 1 || g.SH < 1 || g.SW < 1 ||
      g.SD > 8 || g.SH > 8 || g.SW > 8 || taps > 65535 || m >= (1LL << 31) ||
      g.Kp != taps * g.c_slices * ddpm::kBK || out_dtype < 0 || out_dtype > 2)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return cudaErrorMisalignedAddress;
  g.M = static_cast<int>(m);
  g.kt_count = g.Kp / ddpm::kBK;
  g.n_blocks = (g.Cout + ddpm::kBlock - 1) / ddpm::kBlock;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0, cuda_version = 0;  // libcuda's
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDriverGetVersion(&cuda_version);
  if (err != cudaSuccess) return err;
  // the larger tile (a quarter less traffic through L2 an operation) unless
  // the 128 x 128 tile needs fewer waves of the card's SMs for the same work
  const int wide_m = g.Cout > 128 ? 128 : 256, wide_n = g.Cout > 128 ? 256 : 128;
  const long long small_tiles = ((g.M + 127) / 128) * ((g.Cout + 127) / 128);
  const long long wide_tiles = ((g.M + wide_m - 1) / wide_m) * ((g.Cout + wide_n - 1) / wide_n);
  const bool wide = (wide_tiles + sms - 1) / sms * 2 <= (small_tiles + sms - 1) / sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!wide)
    return ddpm::launch<128, 128>(xq, absmax, wq, sw, bias, y, out_dtype, g, sms, cuda_version, s);
  if (g.Cout > 128)
    return ddpm::launch<128, 256>(xq, absmax, wq, sw, bias, y, out_dtype, g, sms, cuda_version, s);
  return ddpm::launch<256, 128>(xq, absmax, wq, sw, bias, y, out_dtype, g, sms, cuda_version, s);
}
