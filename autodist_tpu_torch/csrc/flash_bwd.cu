// flash_bwd.cu — FlashAttention backward for NVIDIA Hopper (sm_90a).
//
// Two kernels, one per TPU kernel of autodist_tpu/ops/flash_attention.py's
// backward (both launched by _bwd through pl.pallas_call), each in a bf16
// and an f32 design:
//
// - dQ (flash_bwd_dq_mma_kernel, flash_bwd_dq_kernel) replaces _dq_kernel:
//   for a tile of query rows it recomputes P = exp(S - lse) tile by tile
//   over the keys, forms dP = dO V^T and dS = P * (dP - delta) * scale
//   rounded to k's dtype, and accumulates dQ += dS K in f32.
// - dK/dV (flash_bwd_dkdv_mma_kernel, flash_bwd_dkdv_kernel) replaces
//   _dkdv_kernel: for a tile of key rows it
//   loops over the queries, accumulating dV += P^T dO (P rounded to dO's
//   dtype) and dK += dS^T Q (dS from the unrounded exp(S - lse), rounded to
//   q's dtype), both in f32.
//
// The rounding points are the TPU kernels' own, so bf16 gradients agree
// with them. delta = rowsum(dO * O) comes in precomputed in f32, as in _bwd.
// Masked scores are NEG_INF = -1e30 (finite), and lse is the forward's:
// an empty query row has lse = 0, so exp(NEG_INF - 0) = 0 and its
// gradients vanish. Causal flag and optional (q_seg, kv_seg) segment ids
// (attention allowed iff equal) as in the forward.
//
// Layout: q, dO [B, Sq, H, D] and k, v [B, Sk, H, D] read through element
// strides for b, s and h (d contiguous, rows 16-byte aligned); lse and
// delta contiguous [B, H, Sq] f32; dq [B, Sq, H, D] and dk, dv
// [B, Sk, H, D] written contiguous in the input dtype.
//
// Design. The TPU kernels carry their f32 accumulators in VMEM across a
// sequential grid axis; here blocks run in no order, so each block owns a
// tile of rows and loops over the other operand's 64-row tiles itself,
// holding its outputs in registers. Ragged edges are masked. Tiles with no
// visible entry are skipped before they are read: causal tiles past the
// diagonal, and tiles whose segment-id range cannot meet the block's
// (_tile_live's range test). Two designs, chosen by the variant code:
//
// - flash_bwd_dq_mma_kernel (bf16 dQ): one block of four warps owns 64
//   query rows, 16 per warp. Q and dO pass once through shared memory
//   (the second K/V buffers, before the loop) into A fragments that stay
//   in registers, beside each row's lse and delta; K and V tiles of 64
//   rows (with their ids) are double-buffered with cp.async. Per 32 keys,
//   S = Q K^T and dP = dO V^T run on the tensor cores (mma.sync m16n8k16,
//   bf16 operands through ldmatrix, f32 accumulators; K and V rows are
//   the columns of B as stored), dS = exp(S - lse) (dP - delta) scale is
//   rounded to bf16 (the TPU point) and repacked from the accumulators
//   into A fragments in registers, and dQ += dS K reads K through
//   ldmatrix.trans. dQ stays in f32 registers and is written once, staged
//   through shared memory so each lane stores 16 contiguous bytes. Keys
//   past the edge or above the diagonal of all the warp's rows are skipped
//   32 at a time; only passes at an edge, with ids or on the diagonal are
//   masked, and the scale is folded into the exponent; four blocks share
//   an SM.
// - flash_bwd_dkdv_mma_kernel (bf16 dK/dV): one block of four warps owns
//   64 key rows, 16 per warp; K and V load once as bf16, Q and dO tiles of
//   64 rows (with their lse, delta and ids) are double-buffered with
//   cp.async. With the keys as the M dimension, S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q all run on the
//   tensor cores; P and dS are rounded to bf16 (the TPU points) and
//   repacked from the accumulators into A fragments in registers, and dO
//   and Q serve as B both as stored and through ldmatrix.trans. dK and dV
//   stay in f32 registers and are written once. Masks and the exponent as
//   in dQ; three blocks share an SM.
// - flash_bwd_dq_kernel and flash_bwd_dkdv_kernel (f32): scalar FMA over
//   tiles staged in shared memory with a padded leading dimension; a block
//   owns 16 rows (four warps, four rows each), each lane two score and two
//   output columns. f32 stays here: on the tensor cores f32 operands would
//   be TF32, about three digits, and the f32 paths are held to 2e-5.
//
// Bound. At lm1b training ([64, 128, 16, 64] bf16, causal) both kernels are
// bound by bytes on this card (about 85 MB for dQ and 102 MB for dK/dV,
// each input read once and each output written once, 0.025 and 0.030 ms
// at 3.35 TB/s, against 3.3 and 4.4 GFLOP over the live causal half). The
// tensor-core designs remove what held the scalar ones back (shared-memory
// operand loads for every FMA, f32 staging, dS through shared memory,
// 16-row tiles that re-read the looped operand eight times at S = 128,
// loads not overlapped with compute). What still holds them above the
// byte bound: at S = 128 a block lives for one or two tiles of the looped
// operand, so the first tile's load latency is exposed and is hidden only
// by the other blocks of its SM, which the registers limit (dQ 128 a
// thread, four blocks; dK/dV 168, three); and each score element costs an
// exp2 and a handful of instructions beside the three or four products.
// Launching dQ's later (heavier, under the causal mask) query blocks first
// measured no faster than launch order. wgmma and TMA would raise the
// product rate, which is not the limit here. Times are in PERF.md.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;            // head dim the kernels are compiled for
constexpr int kLD = kD + 1;       // padded leading dim of the looped tiles
constexpr int kTile = 64;         // rows of the looped-over operand a tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* q_seg;
  const int* kv_seg;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale;
};

// Stage `rows` rows of kD f32 (row r at base + r * row_stride, its
// elements contiguous and 16-byte aligned) into shared memory with leading
// dimension LD; rows >= valid are zero-filled.
template <int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int rows,
                                          int valid) {
  constexpr int kChunks = kD / 4;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const float4 vals =
        r < valid ? *reinterpret_cast<const float4*>(base + r * row_stride +
                                                     col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[r * LD + col] = vals.x;
    dst[r * LD + col + 1] = vals.y;
    dst[r * LD + col + 2] = vals.z;
    dst[r * LD + col + 3] = vals.w;
  }
}

// Warp 0 stages the segment ids of a 64-row tile (zero past `valid`) and
// publishes whether their range meets [lo, hi] (the block's own range);
// the caller syncs and reads *live.
__device__ __forceinline__ void tile_segments(const int* seg, int valid,
                                              int lo, int hi, int* seg_s,
                                              int* live) {
  const int lane = threadIdx.x % 32;
  int t_lo = INT_MAX, t_hi = INT_MIN;
  for (int j = lane; j < kTile; j += 32) {
    int s = 0;
    if (j < valid) {
      s = seg[j];
      t_lo = min(t_lo, s);
      t_hi = max(t_hi, s);
    }
    seg_s[j] = s;
  }
  t_lo = __reduce_min_sync(0xffffffffu, t_lo);
  t_hi = __reduce_max_sync(0xffffffffu, t_hi);
  if (lane == 0) *live = (hi >= t_lo) && (lo <= t_hi);
}

// the segment-id range of the block's own `valid` rows
__device__ __forceinline__ void row_range(const int* seg_s, int valid,
                                          int* lo, int* hi) {
  *lo = INT_MAX;
  *hi = INT_MIN;
  for (int r = 0; r < valid; ++r) {
    *lo = min(*lo, seg_s[r]);
    *hi = max(*hi, seg_s[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  __shared__ float q_s[kRows * kD];
  __shared__ float do_s[kRows * kD];
  __shared__ float k_s[kTile * kLD];
  __shared__ float v_s[kTile * kLD];
  __shared__ float ds_s[kWarps][kTile];
  __shared__ float lse_s[kRows];
  __shared__ float delta_s[kRows];
  __shared__ int qseg_s[kRows];
  __shared__ int kseg_s[kTile];
  __shared__ int live_s;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_valid = min(kRows, a.Sq - q0);
  const bool has_seg = a.q_seg != nullptr;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb +
                    static_cast<long long>(q0) * a.q_ss + h * a.q_sh;
  const float* ob = static_cast<const float*>(a.dout) + b * a.o_sb +
                    static_cast<long long>(q0) * a.o_ss + h * a.o_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_tile<kD>(q_s, qb, a.q_ss, kRows, q_valid);
  load_tile<kD>(do_s, ob, a.o_ss, kRows, q_valid);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    const bool ok = r < q_valid;
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + q0 + r;
    lse_s[r] = ok ? a.lse[row] : 0.f;
    delta_s[r] = ok ? a.delta[row] : 0.f;
    qseg_s[r] = (has_seg && ok)
                    ? a.q_seg[static_cast<long long>(b) * a.Sq + q0 + r]
                    : 0;
  }
  __syncthreads();

  int q_min = 0, q_max = 0;
  if (has_seg) row_range(qseg_s, q_valid, &q_min, &q_max);

  float acc0[kRowsPerWarp], acc1[kRowsPerWarp];  // dQ columns lane, lane+32
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }

  const int q_last = q0 + q_valid - 1;
  for (int k0 = 0; k0 < a.Sk; k0 += kTile) {
    // causal: this tile and every later one lie above the diagonal
    if (a.causal && q_last < k0) break;
    const int k_valid = min(kTile, a.Sk - k0);

    if (has_seg) {
      if (warp == 0)
        tile_segments(a.kv_seg + static_cast<long long>(b) * a.Sk + k0,
                      k_valid, q_min, q_max, kseg_s, &live_s);
      __syncthreads();
      const int live = live_s;
      if (!live) {
        __syncthreads();  // every thread has read live_s before its rewrite
        continue;
      }
    }

    load_tile<kLD>(k_s, kb + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                   kTile, k_valid);
    load_tile<kLD>(v_s, vb + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                   kTile, k_valid);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r < q_valid) {  // uniform across the warp
        const int row = q0 + r;
        const float* qr = q_s + r * kD;
        const float* dr = do_s + r * kD;
        const float* kr0 = k_s + lane * kLD;
        const float* kr1 = k_s + (lane + 32) * kLD;
        const float* vr0 = v_s + lane * kLD;
        const float* vr1 = v_s + (lane + 32) * kLD;
        float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) {
          const float qd = qr[d];
          const float od = dr[d];
          s0 = fmaf(qd, kr0[d], s0);
          s1 = fmaf(qd, kr1[d], s1);
          dp0 = fmaf(od, vr0[d], dp0);
          dp1 = fmaf(od, vr1[d], dp1);
        }
        s0 *= a.scale;
        s1 *= a.scale;
        const int c0 = k0 + lane, c1 = k0 + lane + 32;
        bool ok0 = lane < k_valid, ok1 = lane + 32 < k_valid;
        if (a.causal) {
          ok0 = ok0 && row >= c0;
          ok1 = ok1 && row >= c1;
        }
        if (has_seg) {
          const int qs = qseg_s[r];
          ok0 = ok0 && qs == kseg_s[lane];
          ok1 = ok1 && qs == kseg_s[lane + 32];
        }
        if (!ok0) s0 = kNegInf;
        if (!ok1) s1 = kNegInf;
        const float lse = lse_s[r], delta = delta_s[r];
        const float p0 = expf(s0 - lse), p1 = expf(s1 - lse);
        // _dq_kernel: ds = (p * (dp - delta) * scale).astype(k.dtype),
        // exact in f32
        ds_s[warp][lane] = p0 * (dp0 - delta) * a.scale;
        ds_s[warp][lane + 32] = p1 * (dp1 - delta) * a.scale;
        __syncwarp();
        float a0 = acc0[i], a1 = acc1[i];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) {
          const float dsj = ds_s[warp][j];
          a0 = fmaf(dsj, k_s[j * kLD + lane], a0);
          a1 = fmaf(dsj, k_s[j * kLD + lane + 32], a1);
        }
        acc0[i] = a0;
        acc1[i] = a1;
        __syncwarp();  // ds_s is rewritten by the next row
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s, kseg_s, live_s
  }

  float* out = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r < q_valid) {
      float* orow =
          out + ((static_cast<long long>(b) * a.Sq + q0 + r) * a.H + h) * kD;
      orow[lane] = acc0[i];
      orow[lane + 32] = acc1[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Args a) {
  __shared__ float k_s[kRows * kD];
  __shared__ float v_s[kRows * kD];
  __shared__ float q_s[kTile * kLD];
  __shared__ float do_s[kTile * kLD];
  __shared__ float p_s[kWarps][kTile];
  __shared__ float ds_s[kWarps][kTile];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  __shared__ int kseg_s[kRows];
  __shared__ int qseg_s[kTile];
  __shared__ int live_s;

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k_valid = min(kRows, a.Sk - k0);
  const bool has_seg = a.q_seg != nullptr;

  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb +
                    static_cast<long long>(k0) * a.k_ss + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb +
                    static_cast<long long>(k0) * a.v_ss + h * a.v_sh;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* ob =
      static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_tile<kD>(k_s, kb, a.k_ss, kRows, k_valid);
  load_tile<kD>(v_s, vb, a.v_ss, kRows, k_valid);
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    kseg_s[r] = (has_seg && r < k_valid)
                    ? a.kv_seg[static_cast<long long>(b) * a.Sk + k0 + r]
                    : 0;
  }
  __syncthreads();

  int k_min = 0, k_max = 0;
  if (has_seg) row_range(kseg_s, k_valid, &k_min, &k_max);

  // dK, dV columns lane and lane + 32 of each of the warp's kv rows
  float dk0[kRowsPerWarp], dk1[kRowsPerWarp];
  float dv0[kRowsPerWarp], dv1[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    dk0[i] = 0.f;
    dk1[i] = 0.f;
    dv0[i] = 0.f;
    dv1[i] = 0.f;
  }

  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  // causal: query rows before k0 see none of this block's keys, so the
  // loop starts at the tile holding row k0
  const int q_start = a.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_start; q0 < a.Sq; q0 += kTile) {
    const int q_valid = min(kTile, a.Sq - q0);
    if (a.causal && q0 + q_valid - 1 < k0) continue;  // uniform

    if (has_seg) {
      if (warp == 0)
        tile_segments(a.q_seg + static_cast<long long>(b) * a.Sq + q0,
                      q_valid, k_min, k_max, qseg_s, &live_s);
      __syncthreads();
      const int live = live_s;
      if (!live) {
        __syncthreads();
        continue;
      }
    }

    load_tile<kLD>(q_s, qb + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                   kTile, q_valid);
    load_tile<kLD>(do_s, ob + static_cast<long long>(q0) * a.o_ss, a.o_ss,
                   kTile, q_valid);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      lse_s[j] = j < q_valid ? a.lse[row_base + q0 + j] : 0.f;
      delta_s[j] = j < q_valid ? a.delta[row_base + q0 + j] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int c = warp * kRowsPerWarp + i;
      if (c < k_valid) {  // uniform across the warp
        const int col = k0 + c;
        const float* kr = k_s + c * kD;
        const float* vr = v_s + c * kD;
        const float* qr0 = q_s + lane * kLD;
        const float* qr1 = q_s + (lane + 32) * kLD;
        const float* dr0 = do_s + lane * kLD;
        const float* dr1 = do_s + (lane + 32) * kLD;
        float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) {
          const float kd = kr[d];
          const float vd = vr[d];
          s0 = fmaf(qr0[d], kd, s0);
          s1 = fmaf(qr1[d], kd, s1);
          dp0 = fmaf(dr0[d], vd, dp0);
          dp1 = fmaf(dr1[d], vd, dp1);
        }
        s0 *= a.scale;
        s1 *= a.scale;
        const int r0 = q0 + lane, r1 = q0 + lane + 32;
        bool ok0 = lane < q_valid, ok1 = lane + 32 < q_valid;
        if (a.causal) {
          ok0 = ok0 && r0 >= col;
          ok1 = ok1 && r1 >= col;
        }
        if (has_seg) {
          const int ks = kseg_s[c];
          ok0 = ok0 && qseg_s[lane] == ks;
          ok1 = ok1 && qseg_s[lane + 32] == ks;
        }
        if (!ok0) s0 = kNegInf;
        if (!ok1) s1 = kNegInf;
        const float e0 = expf(s0 - lse_s[lane]);
        const float e1 = expf(s1 - lse_s[lane + 32]);
        // _dkdv_kernel: p = exp(s - lse).astype(do.dtype) for dV, and
        // ds = (exp(s - lse) * (dp - delta) * scale).astype(q.dtype), both
        // exact in f32
        p_s[warp][lane] = e0;
        p_s[warp][lane + 32] = e1;
        ds_s[warp][lane] = e0 * (dp0 - delta_s[lane]) * a.scale;
        ds_s[warp][lane + 32] = e1 * (dp1 - delta_s[lane + 32]) * a.scale;
        __syncwarp();
        float gk0 = dk0[i], gk1 = dk1[i], gv0 = dv0[i], gv1 = dv1[i];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) {
          const float pj = p_s[warp][j];
          const float dsj = ds_s[warp][j];
          gv0 = fmaf(pj, do_s[j * kLD + lane], gv0);
          gv1 = fmaf(pj, do_s[j * kLD + lane + 32], gv1);
          gk0 = fmaf(dsj, q_s[j * kLD + lane], gk0);
          gk1 = fmaf(dsj, q_s[j * kLD + lane + 32], gk1);
        }
        dk0[i] = gk0;
        dk1[i] = gk1;
        dv0[i] = gv0;
        dv1[i] = gv1;
        __syncwarp();  // p_s, ds_s are rewritten by the next row
      }
    }
    __syncthreads();  // the next tile overwrites q_s, do_s, lse_s, qseg_s
  }

  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int c = warp * kRowsPerWarp + i;
    if (c < k_valid) {
      const long long off =
          ((static_cast<long long>(b) * a.Sk + k0 + c) * a.H + h) * kD;
      dk[off + lane] = dk0[i];
      dk[off + lane + 32] = dk1[i];
      dv[off + lane] = dv0[i];
      dv[off + lane + 32] = dv1[i];
    }
  }
}

// ------------------------------------------- bf16 tensor-core dK/dV design

constexpr int kKM = 64;  // key rows per block of the mma kernel, 16 a warp
constexpr int kMmaThreads = (kKM / 16) * 32;
constexpr float kLog2e = 1.4426950408889634f;
using adt_mma::kLDS;
using bf16 = __nv_bfloat16;

struct __align__(16) DkdvSmem {
  bf16 k[kKM * kLDS];        // K once; the dK rows on the way out
  bf16 v[kKM * kLDS];        // V once; the dV rows on the way out
  bf16 q[2][kTile * kLDS];   // double-buffered Q tiles
  bf16 o[2][kTile * kLDS];   // double-buffered dO tiles
  float lse[2][kTile];       // their lse, delta and segment ids
  float delta[2][kTile];
  int qseg[2][kTile];
};

// The first query tile at or after q that sees a key of the block (rows
// from k0, ids in [k_lo, k_hi]), or Sq when none is left. Warp-uniform:
// each warp reduces the ids itself.
__device__ __forceinline__ int next_q_tile(const Args& a, const int* q_seg,
                                           int q, int k0, int k_lo,
                                           int k_hi) {
  for (; q < a.Sq; q += kTile) {
    const int q_valid = min(kTile, a.Sq - q);
    if (a.causal && q + q_valid - 1 < k0) continue;
    if (q_seg == nullptr) return q;
    int lo, hi;
    adt_mma::warp_id_range(q_seg + q, q_valid, &lo, &hi);
    if (k_hi >= lo && k_lo <= hi) return q;
  }
  return a.Sq;
}

// Start the copies of query tile q0 (Q, dO rows, their lse, delta and
// segment ids) into buffer buf; rows past Sq are zeroed.
__device__ __forceinline__ void load_q_tile(DkdvSmem& sm, const Args& a,
                                            const bf16* qb, const bf16* ob,
                                            long long row_base,
                                            const int* q_seg, int q0,
                                            int buf) {
  using adt_mma::cp_async_4;
  const int q_valid = min(kTile, a.Sq - q0);
  adt_mma::load_rows_async<kTile, kMmaThreads>(
      sm.q[buf], qb + static_cast<long long>(q0) * a.q_ss, a.q_ss, q_valid);
  adt_mma::load_rows_async<kTile, kMmaThreads>(
      sm.o[buf], ob + static_cast<long long>(q0) * a.o_ss, a.o_ss, q_valid);
  if (threadIdx.x < kTile) {
    const int j = threadIdx.x;
    const bool ok = j < q_valid;
    const long long row = row_base + q0 + (ok ? j : 0);
    cp_async_4(&sm.lse[buf][j], a.lse + row, ok);
    cp_async_4(&sm.delta[buf][j], a.delta + row, ok);
    if (q_seg != nullptr)
      cp_async_4(&sm.qseg[buf][j], q_seg + q0 + (ok ? j : 0), ok);
  }
}

// dK and dV for 64 key rows a block, 16 a warp, with the keys as the M
// dimension of every product: per query tile S^T = K Q^T and
// dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q, each 32 query
// columns at a time so the score accumulators stay small.
// Three blocks an SM: capped so (168 registers, no spills) it ran faster
// at the lm1b training shape than uncapped (two blocks an SM) or capped
// for four blocks (spills).
__global__ void __launch_bounds__(kMmaThreads, 3)
    flash_bwd_dkdv_mma_kernel(const Args a) {
  using namespace adt_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(smem_raw);

  const int k0 = blockIdx.x * kKM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row, column pair
  const int k_valid = min(kKM, a.Sk - k0);
  const int wrow = warp * 16;           // the warp's first key in the block
  const bool active = wrow < k_valid;   // uniform across the warp

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb +
                   static_cast<long long>(k0) * a.k_ss + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb +
                   static_cast<long long>(k0) * a.v_ss + h * a.v_sh;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const int* q_seg = a.q_seg == nullptr
                         ? nullptr
                         : a.q_seg + static_cast<long long>(b) * a.Sq;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;

  // the block's key id range, and the ids of this lane's two key rows
  int k_lo = 0, k_hi = 0, ks_row[2] = {0, 0};
  if (q_seg != nullptr) {
    const int* ks = a.kv_seg + static_cast<long long>(b) * a.Sk + k0;
    warp_id_range(ks, k_valid, &k_lo, &k_hi);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow + g + 8 * i;
      ks_row[i] = r < k_valid ? ks[r] : 0;
    }
  }

  load_rows_async<kKM, kMmaThreads>(sm.k, kb, a.k_ss, k_valid);
  load_rows_async<kKM, kMmaThreads>(sm.v, vb, a.v_ss, k_valid);
  cp_async_commit();
  // causal: query rows before k0 see none of this block's keys, so the
  // loop starts at the tile holding row k0
  int qt = next_q_tile(a, q_seg, a.causal ? (k0 / kTile) * kTile : 0, k0,
                       k_lo, k_hi);
  if (qt < a.Sq) load_q_tile(sm, a, qb, ob, row_base, q_seg, qt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed; the first q tile may not
  __syncthreads();

  uint32_t kf[kD / 16][4], vf[kD / 16][4];  // the warp's K, V rows
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      load_a(kf[kk], sm.k, wrow, kk * 16);
      load_a(vf[kk], sm.v, wrow, kk * 16);
    }
  }
  const float sl2 = a.scale * kLog2e;  // exp(scale * x) = exp2(sl2 * x)
  // key rows g and g + 8 of the warp, columns 8 * j + 2 * t (+1)
  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }

  int buf = 0;
  while (qt < a.Sq) {
    const int qn = next_q_tile(a, q_seg, qt + kTile, k0, k_lo, k_hi);
    // in flight while this tile computes
    if (qn < a.Sq) load_q_tile(sm, a, qb, ob, row_base, q_seg, qn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const bf16* qs = sm.q[buf];
      const bf16* os = sm.o[buf];
      const int q_valid = min(kTile, a.Sq - qt);
#pragma unroll
      for (int hq = 0; hq < kTile / 32; ++hq) {
        const int c0 = hq * 32;  // the 32 query columns of this pass
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = 0.f;
            dpt[j][e] = 0.f;
          }
        // S^T = K Q^T and dP^T = V dO^T: Q and dO rows are the columns of
        // B, read as stored
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bq[4], bo[4];
            load_b_nk(bq, qs, c0 + jp * 16, kk * 16);
            load_b_nk(bo, os, c0 + jp * 16, kk * 16);
            mma_16816(st[2 * jp], kf[kk], bq[0], bq[1]);
            mma_16816(st[2 * jp + 1], kf[kk], bq[2], bq[3]);
            mma_16816(dpt[2 * jp], vf[kk], bo[0], bo[1]);
            mma_16816(dpt[2 * jp + 1], vf[kk], bo[2], bo[3]);
          }
        }
        // mask in the accumulator layout (keys are rows, queries columns),
        // only where the pass needs it: at a ragged edge, with segment ids,
        // or where it crosses the causal diagonal of the warp's keys.
        // Column c of row i is visible iff lo[i] <= c <= hi (and the ids
        // match), c counted from c0 + 2 * t.
        const int cb = c0 + 2 * t;
        if (q_valid < kTile || k_valid < kKM || q_seg != nullptr ||
            (a.causal && qt + c0 < k0 + wrow + 15)) {
          const int hi = q_valid - 1 - cb;
          int lo[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = k0 + wrow + g + 8 * i;
            lo[i] = key >= a.Sk ? INT_MAX
                                : (a.causal ? key - qt : 0) - cb;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + (e & 1);
              bool ok = c >= lo[e >> 1] && c <= hi;
              if (q_seg != nullptr)
                ok = ok && sm.qseg[buf][cb + c] == ks_row[e >> 1];
              if (!ok) st[j][e] = kNegInf;
            }
          }
        }
        // st becomes e = exp(scale * s - lse), computed as
        // exp2(sl2 * s - lse2) with lse2 = lse * log2(e), and dpt becomes
        // dS = e * (dP - delta) * scale, lse and delta per column
        // (_dkdv_kernel's points: P is e rounded to dO's dtype, dS is
        // rounded to q's dtype, both bf16 here and rounded at the repack
        // below)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int b2 = 0; b2 < 2; ++b2) {
            const int c = cb + 8 * j + b2;
            const float lse2 = sm.lse[buf][c] * kLog2e;
            const float delta = sm.delta[buf][c];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 2 * i + b2;
              const float ex = exp2f(fmaf(st[j][e], sl2, -lse2));
              st[j][e] = ex;
              dpt[j][e] = ex * (dpt[j][e] - delta) * a.scale;
            }
          }
        }
        // dV += P^T dO and dK += dS^T Q: the queries are the k dimension,
        // P and dS come from the accumulators in registers, dO and Q rows
        // through ldmatrix.trans
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t pa[4], da[4];
          acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
          acc_to_a(da, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
          for (int dp = 0; dp < kD / 16; ++dp) {
            uint32_t bo[4], bq[4];
            load_b_kn(bo, os, c0 + kq * 16, dp * 16);
            load_b_kn(bq, qs, c0 + kq * 16, dp * 16);
            mma_16816(dv[2 * dp], pa, bo[0], bo[1]);
            mma_16816(dv[2 * dp + 1], pa, bo[2], bo[3]);
            mma_16816(dk[2 * dp], da, bq[0], bq[1]);
            mma_16816(dk[2 * dp + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
    qt = qn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  if (!active) return;
  // dK, dV rounded to bf16, staged in the warp's own K and V rows (no
  // other warp reads them) so each lane stores 16 contiguous bytes
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int off = (wrow + g + 8 * i) * kLDS + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(sm.k + off) =
          pack_bf16(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(sm.v + off) =
          pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  __syncwarp();
  bf16* dko = static_cast<bf16*>(a.dk);
  bf16* dvo = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = lane + 32 * it;
    const int r = wrow + (c >> 3);
    const int col = (c & 7) * 8;
    if (r < k_valid) {
      const long long off =
          ((static_cast<long long>(b) * a.Sk + k0 + r) * a.H + h) * kD + col;
      *reinterpret_cast<uint4*>(dko + off) =
          *reinterpret_cast<const uint4*>(sm.k + r * kLDS + col);
      *reinterpret_cast<uint4*>(dvo + off) =
          *reinterpret_cast<const uint4*>(sm.v + r * kLDS + col);
    }
  }
}

// ---------------------------------------------- bf16 tensor-core dQ design

constexpr int kQM = 64;  // query rows per block of the dQ kernel, 16 a warp

struct __align__(16) DqSmem {
  // double-buffered K and V tiles; before the loop the second pair holds
  // the block's Q and dO rows on their way into registers, and after it
  // the first K buffer holds the dQ rows on their way out
  bf16 k[2][kTile * kLDS];
  bf16 v[2][kTile * kLDS];
  int kseg[2][kTile];  // the tiles' segment ids
};
static_assert(kTile == adt_mma::kKvRows, "load_kv_async fills kTile rows");

// dQ for 64 query rows a block, 16 a warp: per kv tile, each 32 keys at a
// time, S = Q K^T and dP = dO V^T, then dQ += dS K with dS repacked from
// the dP accumulators into A fragments.
// Four blocks an SM: capped so (128 registers, no spills) it ran faster at
// the lm1b training shape than uncapped or capped for three (154
// registers, three blocks an SM).
__global__ void __launch_bounds__(kMmaThreads, 4)
    flash_bwd_dq_mma_kernel(const Args a) {
  using namespace adt_mma;
  __shared__ DqSmem sm;

  const int q0 = blockIdx.x * kQM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row, column pair
  const int q_valid = min(kQM, a.Sq - q0);
  const int q_last = q0 + q_valid - 1;
  const int wrow = warp * 16;           // the warp's first row in the block
  const bool active = wrow < q_valid;   // uniform across the warp

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb +
                   static_cast<long long>(q0) * a.q_ss + h * a.q_sh;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.o_sb +
                   static_cast<long long>(q0) * a.o_ss + h * a.o_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* kv_seg = a.kv_seg == nullptr
                          ? nullptr
                          : a.kv_seg + static_cast<long long>(b) * a.Sk;

  // the block's query id range, and the ids of this lane's two rows
  int q_lo = 0, q_hi = 0, qs_row[2] = {0, 0};
  if (kv_seg != nullptr) {
    const int* qs = a.q_seg + static_cast<long long>(b) * a.Sq + q0;
    warp_id_range(qs, q_valid, &q_lo, &q_hi);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow + g + 8 * i;
      qs_row[i] = r < q_valid ? qs[r] : 0;
    }
  }
  // lse (times log2 e) and delta of the lane's rows g and g + 8; rows past
  // Sq get 0 and 0, and with their zero Q and dO a zero dS
  float lse2[2], dlt[2];
  const long long row_base =
      (static_cast<long long>(b) * a.H + h) * a.Sq + q0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    lse2[i] = r < q_valid ? a.lse[row_base + r] * kLog2e : 0.f;
    dlt[i] = r < q_valid ? a.delta[row_base + r] : 0.f;
  }

  // the next kv tile with a visible entry at or after k, and the start of
  // the copies of tile k0 into buffer buf
  auto next_kv = [&](int k) {
    return next_kv_tile(k, a.Sk, a.causal, q_last, kv_seg, q_lo, q_hi);
  };
  auto load_kv = [&](int k0, int buf) {
    load_kv_async<kMmaThreads>(sm.k[buf], sm.v[buf], sm.kseg[buf], kb, a.k_ss,
                               vb, a.v_ss, kv_seg, k0, a.Sk);
  };

  load_rows_async<kQM, kMmaThreads>(sm.k[1], qb, a.q_ss, q_valid);
  load_rows_async<kQM, kMmaThreads>(sm.v[1], ob, a.o_ss, q_valid);
  cp_async_commit();
  int kt = next_kv(0);
  if (kt < a.Sk) load_kv(kt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed; the first kv tile may not
  __syncthreads();

  uint32_t qf[kD / 16][4], of[kD / 16][4];  // the warp's Q, dO rows
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      load_a(qf[kk], sm.k[1], wrow, kk * 16);
      load_a(of[kk], sm.v[1], wrow, kk * 16);
    }
  }
  __syncthreads();  // the loop's first prefetch overwrites buffer 1

  const float sl2 = a.scale * kLog2e;  // exp(scale * x) = exp2(sl2 * x)
  // rows g and g + 8 of the warp, dQ columns 8 * j + 2 * t (+1)
  float dq[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int buf = 0;
  while (kt < a.Sk) {
    const int kn = next_kv(kt + kTile);
    // in flight while this tile computes
    if (kn < a.Sk) load_kv(kn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const bf16* ks = sm.k[buf];
      const bf16* vs = sm.v[buf];
      const int k_valid = min(kTile, a.Sk - kt);
#pragma unroll
      for (int hk = 0; hk < kTile / 32; ++hk) {
        const int c0 = hk * 32;  // the 32 keys of this pass
        // keys past the ragged edge, or above the causal diagonal of all
        // the warp's rows, add nothing: p = 0 there
        if (c0 >= k_valid || (a.causal && kt + c0 > q0 + wrow + 15)) continue;
        float s[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = 0.f;
            dp[j][e] = 0.f;
          }
        // S = Q K^T and dP = dO V^T: K and V rows are the columns of B,
        // read as stored
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bk[4], bv[4];
            load_b_nk(bk, ks, c0 + jp * 16, kk * 16);
            load_b_nk(bv, vs, c0 + jp * 16, kk * 16);
            mma_16816(s[2 * jp], qf[kk], bk[0], bk[1]);
            mma_16816(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
            mma_16816(dp[2 * jp], of[kk], bv[0], bv[1]);
            mma_16816(dp[2 * jp + 1], of[kk], bv[2], bv[3]);
          }
        }
        // mask in the accumulator layout, only where the pass needs it: at
        // the ragged edge, with segment ids, or where it crosses the causal
        // diagonal of the warp's rows. Column c of row i is visible iff
        // c <= lim[i] (and the ids match), c counted from c0 + 2 * t.
        const int cb = c0 + 2 * t;
        if (c0 + 32 > k_valid || kv_seg != nullptr ||
            (a.causal && kt + c0 + 31 > q0 + wrow)) {
          int lim[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            lim[i] = min(k_valid - 1,
                         a.causal ? q0 + wrow + g + 8 * i - kt : kTile) -
                     cb;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + (e & 1);
              bool ok = c <= lim[e >> 1];
              if (kv_seg != nullptr)
                ok = ok && qs_row[e >> 1] == sm.kseg[buf][cb + c];
              if (!ok) s[j][e] = kNegInf;
            }
          }
        }
        // p = exp(scale * s - lse) = exp2(sl2 * s - lse2), and dp becomes
        // dS = p * (dP - delta) * scale (_dq_kernel's dS, rounded to k's
        // dtype, bf16, at the repack below). An empty row has lse 0 and
        // every s NEG_INF, so exp2 gets a huge negative argument and its p
        // is exactly 0 with no select.
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p = exp2f(fmaf(s[j][e], sl2, -lse2[i]));
            dp[j][e] = p * (dp[j][e] - dlt[i]) * a.scale;
          }
        // dQ += dS K: the keys are the k dimension, dS comes from the
        // accumulators in registers, K rows through ldmatrix.trans
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          uint32_t da[4];
          acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
          for (int dd = 0; dd < kD / 16; ++dd) {
            uint32_t bk[4];
            load_b_kn(bk, ks, c0 + kq * 16, dd * 16);
            mma_16816(dq[2 * dd], da, bk[0], bk[1]);
            mma_16816(dq[2 * dd + 1], da, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
    kt = kn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  if (!active) return;
  // dQ rounded to bf16, staged in the warp's own rows of the first K
  // buffer (every warp is past the loop's last barrier, and no copy is in
  // flight) so each lane stores 16 contiguous bytes
  bf16* st = sm.k[0];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(st + (wrow + g + 8 * i) * kLDS + 8 * j +
                                   2 * t) =
          pack_bf16(dq[j][2 * i], dq[j][2 * i + 1]);
  __syncwarp();
  bf16* dqo = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = lane + 32 * it;
    const int r = wrow + (c >> 3);
    const int col = (c & 7) * 8;
    if (r < q_valid)
      *reinterpret_cast<uint4*>(
          dqo + ((static_cast<long long>(b) * a.Sq + q0 + r) * a.H + h) * kD +
          col) = *reinterpret_cast<const uint4*>(st + r * kLDS + col);
  }
}

constexpr int kMaxDevices = 64;

// variant: 0 = scalar f32, 2 = mma.sync bf16
int launch(bool dq, int variant, const Args& a, int D, int rows,
           void* stream) {
  if (D != kD || a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 ||
      a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kRows - 1) / kRows, a.H, a.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (dq)
      flash_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(a);
    else
      flash_bwd_dkdv_kernel<<<grid, kThreads, 0, s>>>(a);
  } else if (variant == 2 && dq) {
    const dim3 mma_grid((rows + kQM - 1) / kQM, a.H, a.B);
    flash_bwd_dq_mma_kernel<<<mma_grid, kMmaThreads, 0, s>>>(a);
  } else if (variant == 2) {
    // above 48 KB, dynamic shared memory needs the kernel's consent; the
    // attribute belongs to the current device, so it is set at the first
    // launch on each device (a launch captured into a CUDA graph comes
    // after its warm-up launch, so the capture never sets it)
    static bool consented[kMaxDevices] = {};
    int dev = 0;
    const cudaError_t got = cudaGetDevice(&dev);
    if (got != cudaSuccess) return static_cast<int>(got);
    if (dev >= kMaxDevices || !consented[dev]) {
      const cudaError_t attr = cudaFuncSetAttribute(
          flash_bwd_dkdv_mma_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(DkdvSmem)));
      if (attr != cudaSuccess) return static_cast<int>(attr);
      if (dev < kMaxDevices) consented[dev] = true;
    }
    const dim3 mma_grid((rows + kKM - 1) / kKM, a.H, a.B);
    flash_bwd_dkdv_mma_kernel<<<mma_grid, kMmaThreads, sizeof(DkdvSmem), s>>>(
        a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 = scalar f32, 2 = mma.sync bf16 (the wrapper's _dq_variant
// and _dkdv_variant pick it); any other code is refused. Strides are in
// elements (q, k, v, then dout, each b, s, h).
// q_seg and kv_seg are both null or both [B, Sq] / [B, Sk] contiguous
// int32. Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int adt_flash_bwd_dq(
    int variant, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const int* q_seg,
    const int* kv_seg, void* dq, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, float scale, void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, q_seg, kv_seg,
               dq,   nullptr, nullptr, B, H, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               o_sb, o_ss, o_sh, causal, scale};
  return launch(true, variant, a, D, Sq, stream);
}

extern "C" int adt_flash_bwd_dkdv(
    int variant, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, const int* q_seg,
    const int* kv_seg, void* dk, void* dv, int B, int H, int Sq, int Sk,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, float scale, void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, q_seg, kv_seg,
               nullptr, dk, dv, B, H, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               o_sb, o_ss, o_sh, causal, scale};
  return launch(false, variant, a, D, Sk, stream);
}
