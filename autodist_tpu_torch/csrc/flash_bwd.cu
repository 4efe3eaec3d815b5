// flash_bwd.cu — FlashAttention backward for NVIDIA Hopper (sm_90a).
//
// Two kernels, one per TPU kernel of autodist_tpu/ops/flash_attention.py's
// backward (both launched by _bwd through pl.pallas_call):
//
// - flash_bwd_dq_kernel replaces _dq_kernel: for a tile of query rows it
//   recomputes P = exp(S - lse) tile by tile over the keys, forms
//   dP = dO V^T and dS = P * (dP - delta) * scale rounded to k's dtype, and
//   accumulates dQ += dS K in f32.
// - flash_bwd_dkdv_kernel replaces _dkdv_kernel: for a tile of key rows it
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
// tile of 16 rows (four warps, four rows each) and loops over the other
// operand's 64-row tiles itself, staged in shared memory as f32 with a
// padded leading dimension (lane j reads row j without bank conflicts).
// Each lane owns score columns j and j + 32 of its row and output columns
// d and d + 32, kept in registers across the loop. Ragged edges are
// masked. Tiles with no visible entry are skipped before they are read:
// causal tiles past the diagonal, and tiles whose segment-id range cannot
// meet the block's (_tile_live's range test).
//
// Bound. At lm1b training ([64, 128, 16, 64] bf16, causal) both kernels are
// bound by bytes on this card (about 85 MB for dQ and 102 MB for dK/dV,
// each input read once and each output written once, against 3.3 and
// 4.4 GFLOP over the live causal half). This first version is scalar FMA
// on f32 tiles; tensor cores (wgmma), TMA and a fused single-pass
// backward are later work. Its times are in PERF.md.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T, as the TPU kernels' .astype(dtype) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Stage `rows` rows of kD elements (row r at base + r * row_stride, its
// elements contiguous and 16-byte aligned) into shared memory as f32 with
// leading dimension LD; rows >= valid are zero-filled.
template <typename T, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long row_stride, int rows,
                                          int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kD / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    float vals[kVec];
    if (r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + r * row_stride + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = to_float(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * LD + col + i] = vals[i];
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

template <typename T>
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

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb +
                static_cast<long long>(q0) * a.q_ss + h * a.q_sh;
  const T* ob = static_cast<const T*>(a.dout) + b * a.o_sb +
                static_cast<long long>(q0) * a.o_ss + h * a.o_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_tile<T, kD>(q_s, qb, a.q_ss, kRows, q_valid);
  load_tile<T, kD>(do_s, ob, a.o_ss, kRows, q_valid);
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

    load_tile<T, kLD>(k_s, kb + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                      kTile, k_valid);
    load_tile<T, kLD>(v_s, vb + static_cast<long long>(k0) * a.v_ss, a.v_ss,
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
        // _dq_kernel: ds = (p * (dp - delta) * scale).astype(k.dtype)
        ds_s[warp][lane] = round_to<T>(p0 * (dp0 - delta) * a.scale);
        ds_s[warp][lane + 32] = round_to<T>(p1 * (dp1 - delta) * a.scale);
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

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r < q_valid) {
      T* orow =
          out + ((static_cast<long long>(b) * a.Sq + q0 + r) * a.H + h) * kD;
      orow[lane] = from_float<T>(acc0[i]);
      orow[lane + 32] = from_float<T>(acc1[i]);
    }
  }
}

template <typename T>
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

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb +
                static_cast<long long>(k0) * a.k_ss + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb +
                static_cast<long long>(k0) * a.v_ss + h * a.v_sh;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* ob = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_tile<T, kD>(k_s, kb, a.k_ss, kRows, k_valid);
  load_tile<T, kD>(v_s, vb, a.v_ss, kRows, k_valid);
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

    load_tile<T, kLD>(q_s, qb + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                      kTile, q_valid);
    load_tile<T, kLD>(do_s, ob + static_cast<long long>(q0) * a.o_ss, a.o_ss,
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
        // ds = (exp(s - lse) * (dp - delta) * scale).astype(q.dtype)
        p_s[warp][lane] = round_to<T>(e0);
        p_s[warp][lane + 32] = round_to<T>(e1);
        ds_s[warp][lane] = round_to<T>(e0 * (dp0 - delta_s[lane]) * a.scale);
        ds_s[warp][lane + 32] =
            round_to<T>(e1 * (dp1 - delta_s[lane + 32]) * a.scale);
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

  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int c = warp * kRowsPerWarp + i;
    if (c < k_valid) {
      const long long off =
          ((static_cast<long long>(b) * a.Sk + k0 + c) * a.H + h) * kD;
      dk[off + lane] = from_float<T>(dk0[i]);
      dk[off + lane + 32] = from_float<T>(dk1[i]);
      dv[off + lane] = from_float<T>(dv0[i]);
      dv[off + lane + 32] = from_float<T>(dv1[i]);
    }
  }
}

int launch(bool dq, int dtype, const Args& a, int D, int rows,
           void* stream) {
  if (D != kD || a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 ||
      a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kRows - 1) / kRows, a.H, a.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (dq)
      flash_bwd_dq_kernel<float><<<grid, kThreads, 0, s>>>(a);
    else
      flash_bwd_dkdv_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    if (dq)
      flash_bwd_dq_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
    else
      flash_bwd_dkdv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements (q, k, v, then
// dout, each b, s, h). q_seg and kv_seg are both null or both [B, Sq] /
// [B, Sk] contiguous int32. Each returns cudaGetLastError() after its
// launch (0 = launched).
extern "C" int adt_flash_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* q_seg, const int* kv_seg,
    void* dq, int B, int H, int Sq, int Sk, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale,
    void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, q_seg, kv_seg,
               dq,   nullptr, nullptr, B, H, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               o_sb, o_ss, o_sh, causal, scale};
  return launch(true, dtype, a, D, Sq, stream);
}

extern "C" int adt_flash_bwd_dkdv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* q_seg, const int* kv_seg,
    void* dk, void* dv, int B, int H, int Sq, int Sk, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale,
    void* stream) {
  const Args a{q,    k,    v,    dout, lse,  delta, q_seg, kv_seg,
               nullptr, dk, dv, B, H, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               o_sb, o_ss, o_sh, causal, scale};
  return launch(false, dtype, a, D, Sk, stream);
}
