// mma_bf16.cuh — warp-level tensor-core pieces shared by the bf16 flash
// kernels (sm_80 and later; built for sm_90a).
//
// - cp.async: 16- and 4-byte global -> shared copies that run while the
//   warp computes, zero-filling rows past a ragged edge;
// - ldmatrix (plain and .trans): 8x8 bf16 tiles from shared memory into
//   the register fragments of mma.sync;
// - mma.sync.m16n8k16 with bf16 operands and f32 accumulators;
// - the repack of two f32 accumulator tiles into a bf16 A fragment, so a
//   product's result feeds the next product without leaving registers;
// - the loop over K/V tiles that the forward and dQ share: which tile is
//   next (causal and segment-id skips) and the start of its copies.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row): a[0] = A[g][2t..2t+1],   a[1] = A[g+8][2t..2t+1],
//                     a[2] = A[g][2t+8..2t+9], a[3] = A[g+8][2t+8..2t+9]
//   B (16 x 8, col):  b[0] = B[2t..2t+1][g],   b[1] = B[2t+8..2t+9][g]
//   C (16 x 8, f32):  c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16, the lower column (or row of B) in
// the low half.
//
// Tiles in shared memory are rows of kD = 64 bf16 padded to kLDS = 72
// (144 bytes): the eight 16-byte rows one ldmatrix reads start 4 banks
// apart, so every load is free of bank conflicts.

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <stdint.h>

namespace adt_mma {

constexpr int kLDS = 64 + 8;  // padded leading dimension, in elements
constexpr int kKvRows = 64;   // rows of a K/V tile the kernels loop over

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global memory to shared memory asynchronously; with
// valid == false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// The same for 4 bytes (an id or an f32 of a row), through L1.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` rows of 64 bf16 (row r at src + r * stride, 16-byte
// aligned) into dst with leading dimension kLDS; rows >= valid are zeroed.
// Every thread of the block calls it (nthreads of them).
template <int kRowsT, int kThreadsT>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int valid) {
  for (int c = threadIdx.x; c < kRowsT * 8; c += kThreadsT) {
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * kLDS + col,
                src + static_cast<long long>(ok ? r : 0) * stride + col, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A * B for one 16 x 8 x 16 tile, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even) in one register, `lo`
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a row-major
// tile with leading dimension kLDS.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * kLDS + c0 + (lane >> 4) * 8);
}

// B fragments for two n-tiles from a tile stored [n][k] (each n a row,
// k contiguous): rows [n0, n0 + 16), k columns [k0, k0 + 16).
// b[0], b[1] belong to n-tile n0 and b[2], b[3] to n-tile n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kLDS + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments for two n-tiles from a tile stored [k][n] (each k a row,
// n contiguous), through ldmatrix.trans: k rows [k0, k0 + 16), n columns
// [n0, n0 + 16). b[0], b[1] belong to n-tile n0 and b[2], b[3] to n0 + 8.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * kLDS + n0 +
                           (lane >> 4) * 8);
}

// The A fragment (16 rows x 16 columns) made from two 16 x 8 accumulator
// tiles c0 (columns 0-7) and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The range [*lo, *hi] of the segment ids seg[0 .. n), reduced over the
// warp (INT_MAX, INT_MIN for n == 0). Every lane of the warp calls it.
__device__ __forceinline__ void warp_id_range(const int* seg, int n, int* lo,
                                              int* hi) {
  const int lane = threadIdx.x & 31;
  int a = INT_MAX, z = INT_MIN;
  for (int j = lane; j < n; j += 32) {
    const int s = seg[j];
    a = min(a, s);
    z = max(z, s);
  }
  *lo = __reduce_min_sync(0xffffffffu, a);
  *hi = __reduce_max_sync(0xffffffffu, z);
}

// The first K/V tile at or after row k (of Sk) that holds a visible entry
// for query rows up to q_last (under the causal mask, if causal) with
// segment ids in [q_lo, q_hi] (if kv_seg is not null), or Sk when none is
// left. Every lane of the warp calls it and gets the same tile.
__device__ __forceinline__ int next_kv_tile(int k, int Sk, bool causal,
                                            int q_last, const int* kv_seg,
                                            int q_lo, int q_hi) {
  for (; k < Sk; k += kKvRows) {
    if (causal && q_last < k) return Sk;
    if (kv_seg == nullptr) return k;
    int lo, hi;
    warp_id_range(kv_seg + k, min(kKvRows, Sk - k), &lo, &hi);
    if (q_hi >= lo && q_lo <= hi) return k;
  }
  return Sk;
}

// Start the copies of the K/V tile at row k0 (of Sk): K rows into k, V
// rows into v and, if kv_seg is not null, their segment ids into seg; rows
// past Sk are zeroed. Every thread of the block (kThreadsT of them, at
// least kKvRows) calls it.
template <int kThreadsT>
__device__ __forceinline__ void load_kv_async(
    __nv_bfloat16* k, __nv_bfloat16* v, int* seg, const __nv_bfloat16* k_src,
    long long k_stride, const __nv_bfloat16* v_src, long long v_stride,
    const int* kv_seg, int k0, int Sk) {
  const int valid = min(kKvRows, Sk - k0);
  load_rows_async<kKvRows, kThreadsT>(
      k, k_src + static_cast<long long>(k0) * k_stride, k_stride, valid);
  load_rows_async<kKvRows, kThreadsT>(
      v, v_src + static_cast<long long>(k0) * v_stride, v_stride, valid);
  if (kv_seg != nullptr && threadIdx.x < kKvRows) {
    const int j = threadIdx.x;
    cp_async_4(seg + j, kv_seg + k0 + (j < valid ? j : 0), j < valid);
  }
}

// Row max and row sum over the four lanes of a quad (the lanes that hold
// one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace adt_mma
