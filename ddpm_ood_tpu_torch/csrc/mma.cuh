// Tensor-core building blocks for the port's Hopper kernels (sm_90a): 16- and
// 4-byte cp.async copies from device to shared memory that zero-fill what lies
// past an edge, ldmatrix loads of bf16 8x8 tiles, and the warp-wide bf16
// product mma.sync.m16n8k16 with fp32 accumulators.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + c, g in 0..7, c in 0..3):
//   A (16 x 16, row-major): a0 = A[g][2c..2c+1],   a1 = A[g+8][2c..2c+1],
//                           a2 = A[g][2c+8..2c+9], a3 = A[g+8][2c+8..2c+9]
//   B (16 x 8, "col"):      b0 = B[2c..2c+1][g],   b1 = B[2c+8..2c+9][g]
//   C (16 x 8, fp32):       c0, c1 = C[g][2c..2c+1], c2, c3 = C[g+8][2c..2c+1]
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 and
// paired, are the A fragment of a 16-deep product: logits become
// probabilities in registers and go straight into the next product.
//
// bf16 tiles live in shared memory as rows of kPad elements past their width
// (16 bytes): the 8 rows that one ldmatrix reads then start in 8 different
// 16-byte bank groups for every row width used here (a multiple of 64 bf16),
// so the loads are free of bank conflicts without a swizzle.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ddpm {
namespace tc {

constexpr int kPad = 8;  // bf16 elements appended to each shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes device -> shared, bypassing L1; when !pred nothing is read and the
// 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes device -> shared, zero-filled when !pred.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Four 8x8 bf16 tiles; lane l gives the address of row (l % 8) of tile l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each tile transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b for one 16x8x16 tile: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Address lane `lane` hands ldmatrix_x4 for the A fragment of rows 0..15 and
// columns k0..k0+15 of a row-major tile with row stride ld: tiles (rows 0-7,
// cols k0..), (rows 8-15, k0..), (rows 0-7, k0+8..), (rows 8-15, k0+8..).
__device__ __forceinline__ int a_frag_offset(int lane, int ld, int k0) {
  return (lane % 16) * ld + k0 + (lane / 16) * 8;
}

// ... for the B fragments of two 8-wide n-tiles (rows n0..n0+15 of a
// row-major [n][k] tile, k0..k0+15): r0, r1 serve rows n0..n0+7, r2, r3 rows
// n0+8..n0+15.
__device__ __forceinline__ int b_frag_offset(int lane, int ld, int n0, int k0) {
  return (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8;
}

// ... for ldmatrix_x4_trans: the B fragments of two 8-wide n-tiles (columns
// n0..n0+15) of a row-major [k][n] tile, rows k0..k0+15: r0, r1 serve
// columns n0..n0+7, r2, r3 columns n0+8..n0+15.
__device__ __forceinline__ int bt_frag_offset(int lane, int ld, int k0, int n0) {
  return (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8;
}

// Rows row0..row0+rows-1 of a (N, D) bf16 matrix into a shared tile of
// width DP (row stride DP + kPad), in 16-byte cp.async chunks spread over the
// block; rows past N and columns past D are zero. D is a multiple of 8.
template <int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          int row0, int rows, int N, int D) {
  constexpr int kChunks = DP / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks;
    const int col = (e - r * kChunks) * 8;
    const bool ok = row0 + r < N && col < D;
    cp_async_16(tile + r * (DP + kPad) + col,
                ok ? src + static_cast<size_t>(row0 + r) * D + col : src, ok);
  }
}

// rows entries of a per-row fp32 vector from `row0` on; entries past N are 0.
__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int row0, int rows,
                                               int N) {
  for (int e = threadIdx.x; e < rows; e += blockDim.x) {
    const bool ok = row0 + e < N;
    cp_async_4(dst + e, ok ? src + row0 + e : src, ok);
  }
}

}  // namespace tc
}  // namespace ddpm
