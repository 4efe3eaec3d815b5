// flash_fwd.cu — FlashAttention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel autodist_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd through pl.pallas_call). It computes the same function:
// O = softmax(Q K^T * scale, masked) V and the per-row log-sum-exp, with a
// causal flag and optional (q_seg, kv_seg) segment ids (attention allowed
// iff the ids are equal), f32 accumulation, NEG_INF = -1e30 as the masked
// score, and the TPU kernel's empty-row rule: a query row with no visible
// key gets O = 0 and lse = 0. As on the TPU, p is rounded to the value
// dtype before the P.V product (p.astype(v.dtype)).
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, H, D] at the API, read through
// element strides for b, s and h (d contiguous), so a decode step reads a
// layer's slice of the [slots, layers, T, H, D] cache in place; o is a
// contiguous [B, Sq, H, D], lse a contiguous [B, H, Sq] f32.
//
// Both designs loop over kv tiles of 64 rows inside the block, carrying m,
// l and the output accumulator in registers (the TPU kernel carries them
// in VMEM scratch across a sequential grid axis instead). Ragged edges are
// masked here, so Sq and Sk need not divide the tiles and a decode step
// passes its one query as Sq = 1. Tiles with no visible entry are skipped
// before their K/V are read: causal tiles above the diagonal end the loop,
// and with segment ids a tile whose id range cannot meet the query tile's
// (_tile_live's range test) is skipped — in decode this is every tile past
// the slot's cursor, so a slot reads only its live prefix.
//
// Two designs, chosen by the caller through the variant code:
//
// - flash_fwd_mma_kernel (bf16): one block of four warps owns 64 query
//   rows, 16 per warp. Q is staged once in shared memory as bf16; K/V
//   tiles of 64 rows are double-buffered with cp.async, so tile j + 1
//   loads while tile j computes. S = Q K^T and O += P V run on the tensor
//   cores (mma.sync m16n8k16, bf16 operands through ldmatrix, f32
//   accumulators); P is rounded to bf16 (the TPU rounding point) and
//   repacked from the S accumulators into the A fragment of P V in
//   registers; row max and sum reduce over a quad of lanes. Shared memory
//   rows are padded to 72 elements, so ldmatrix is free of bank conflicts.
//   Past the products the kernel is bound by its per-element instructions,
//   so it masks only tiles at the ragged edge, with segment ids or on the
//   causal diagonal (one compare a element against a per-row limit),
//   folds the scale into the exponent (one FFMA and one exp2 a element),
//   and skips the 16-column slices of a diagonal tile that none of a
//   warp's rows can see.
// - flash_fwd_kernel (f32): scalar FMA over tiles in shared memory, one
//   block per 16 query rows. f32 stays here: on the tensor cores f32
//   operands would be TF32, about three digits, and the f32 paths are held
//   to 2e-5.
//
// Bound. The forward is bound by bytes on this card at both main-path
// shapes. Training [64, 128, 16, 64] bf16 causal: q, k, v read once and
// out, lse written once are 67.6 MB, 0.0202 ms at 3.35 TB/s, against
// 2.16 GFLOP over the live causal half (0.0022 ms at the 989 TFLOP/s bf16
// peak). Decode (32 slots, T 256, H 16, D 64, bf16): each live K and V row
// read once, at most 33.5 MB a layer, against 34 MFLOP. The tensor-core
// design removes what held the scalar design back in bf16 (shared-memory
// operand loads for every FMA, f32 staging, 16-row tiles that re-read K/V
// eight times at S = 128, loads not overlapped with compute). What still holds
// it above the byte bound is the short life of a block at S = 128 (one or
// two kv tiles) against the latency of its first loads, and the softmax's
// instructions beside the products; 128-row blocks and a persistent grid
// were measured no faster (PERF.md). wgmma and TMA would raise the product
// rate, which is not the limit here.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;            // head dim the kernel is compiled for
constexpr int kBK = 64;           // kv rows per tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_seg;
  const int* kv_seg;
  void* o;
  float* lse;
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage `rows` rows of kD floats (row r at base + r * row_stride, its
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
    float4 vals = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      vals = *reinterpret_cast<const float4*>(base + r * row_stride + col);
    float* d = dst + r * LD + col;
    d[0] = vals.x;
    d[1] = vals.y;
    d[2] = vals.z;
    d[3] = vals.w;
  }
}

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  __shared__ float q_s[kBQ * kD];
  __shared__ float k_s[kBK * (kD + 1)];  // +1: lane j reads row j, no conflicts
  __shared__ float v_s[kBK * kD];
  __shared__ float p_s[kWarps][kBK];
  __shared__ int qseg_s[kBQ];
  __shared__ int kseg_s[kBK];
  __shared__ int live_s;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_valid = min(kBQ, a.Sq - q0);
  const bool has_seg = a.q_seg != nullptr;

  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb +
                    static_cast<long long>(q0) * a.q_ss + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_tile<kD>(q_s, qb, a.q_ss, kBQ, q_valid);
  if (threadIdx.x < kBQ) {
    const int r = threadIdx.x;
    qseg_s[r] = (has_seg && r < q_valid)
                    ? a.q_seg[static_cast<long long>(b) * a.Sq + q0 + r]
                    : 0;
  }
  __syncthreads();

  // the query tile's segment-id range over its valid rows
  int q_min = INT_MAX, q_max = INT_MIN;
  if (has_seg) {
    for (int r = 0; r < q_valid; ++r) {
      q_min = min(q_min, qseg_s[r]);
      q_max = max(q_max, qseg_s[r]);
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc0[kRowsPerWarp], acc1[kRowsPerWarp];  // columns lane, lane + 32
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }

  const int q_last = q0 + q_valid - 1;
  for (int k0 = 0; k0 < a.Sk; k0 += kBK) {
    // causal: this tile and every later one lie above the diagonal
    if (a.causal && q_last < k0) break;
    const int k_valid = min(kBK, a.Sk - k0);

    if (has_seg) {
      if (warp == 0) {
        int lo = INT_MAX, hi = INT_MIN;
        for (int j = lane; j < kBK; j += 32) {
          int s = 0;
          if (j < k_valid) {
            s = a.kv_seg[static_cast<long long>(b) * a.Sk + k0 + j];
            lo = min(lo, s);
            hi = max(hi, s);
          }
          kseg_s[j] = s;
        }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane == 0) live_s = (q_max >= lo) && (q_min <= hi);
      }
      __syncthreads();
      const int live = live_s;
      if (!live) {
        __syncthreads();  // every thread has read live_s before its rewrite
        continue;
      }
    }

    load_tile<kD + 1>(k_s, kb + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                      kBK, k_valid);
    load_tile<kD>(v_s, vb + static_cast<long long>(k0) * a.v_ss, a.v_ss, kBK,
                  k_valid);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r < q_valid) {  // uniform across the warp
        const int row = q0 + r;
        const float* qr = q_s + r * kD;
        const float* kr0 = k_s + lane * (kD + 1);
        const float* kr1 = k_s + (lane + 32) * (kD + 1);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) {
          const float qd = qr[d];
          s0 = fmaf(qd, kr0[d], s0);
          s1 = fmaf(qd, kr1[d], s1);
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

        const float m_new = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
        float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        // no visible key so far: exp(NEG_INF - NEG_INF) = 1 would average
        // garbage into the row, so its contribution is zeroed (empty rows
        // emit 0, as on the TPU)
        if (!(m_new > kNegInf * 0.5f)) {
          p0 = 0.f;
          p1 = 0.f;
        }
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p0 + p1);
        p_s[warp][lane] = p0;  // p.astype(v.dtype) is exact in f32
        p_s[warp][lane + 32] = p1;
        __syncwarp();
        float a0 = acc0[i] * corr, a1 = acc1[i] * corr;
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) {
          const float pj = p_s[warp][j];
          a0 = fmaf(pj, v_s[j * kD + lane], a0);
          a1 = fmaf(pj, v_s[j * kD + lane + 32], a1);
        }
        acc0[i] = a0;
        acc1[i] = a1;
        m[i] = m_new;
        __syncwarp();  // p_s is rewritten by the next row
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s, kseg_s, live_s
  }

  float* ob = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r < q_valid) {
      const int row = q0 + r;
      const float denom = fmaxf(l[i], 1e-30f);
      float* orow =
          ob + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * kD;
      orow[lane] = acc0[i] / denom;
      orow[lane + 32] = acc1[i] / denom;
      if (lane == 0) {
        // empty rows record lse = 0 (the TPU kernel's rule: the backward
        // recomputes p = exp(s - lse), which must vanish for them)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] =
            l[i] > 0.f ? m[i] + logf(denom) : 0.f;
      }
    }
  }
}

// ------------------------------------------------- bf16 tensor-core design

constexpr int kBM = 64;   // query rows per block of the mma kernel
constexpr int kMmaWarps = kBM / 16;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
using adt_mma::kLDS;
using bf16 = __nv_bfloat16;

struct __align__(16) MmaSmem {
  bf16 q[kBM * kLDS];       // Q once; the output rows on the way out
  bf16 k[2][kBK * kLDS];    // double-buffered K tiles
  bf16 v[2][kBK * kLDS];    // double-buffered V tiles
  int kseg[2][kBK];         // their segment ids
};
static_assert(kBK == adt_mma::kKvRows, "load_kv_async fills kBK rows");

__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const Args a) {
  using namespace adt_mma;
  __shared__ MmaSmem sm;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row, column pair
  const int q_valid = min(kBM, a.Sq - q0);
  const int q_last = q0 + q_valid - 1;
  const int wrow = warp * 16;           // the warp's first row in the block
  const bool active = wrow < q_valid;   // uniform across the warp

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb +
                   static_cast<long long>(q0) * a.q_ss + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* kv_seg = a.kv_seg == nullptr
                          ? nullptr
                          : a.kv_seg + static_cast<long long>(b) * a.Sk;

  // the query tile's id range, and the ids of this lane's two rows
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

  // the next kv tile with a visible entry at or after k, and the start of
  // the copies of tile k0 into buffer buf
  auto next_kv = [&](int k) {
    return next_kv_tile(k, a.Sk, a.causal, q_last, kv_seg, q_lo, q_hi);
  };
  auto load_kv = [&](int k0, int buf) {
    load_kv_async<kMmaThreads>(sm.k[buf], sm.v[buf], sm.kseg[buf], kb, a.k_ss,
                               vb, a.v_ss, kv_seg, k0, a.Sk);
  };

  load_rows_async<kBM, kMmaThreads>(sm.q, qb, a.q_ss, q_valid);
  cp_async_commit();
  int kt = next_kv(0);
  if (kt < a.Sk) load_kv(kt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first kv tile may be in flight
  __syncthreads();

  uint32_t qf[kD / 16][4];  // the warp's 16 Q rows as A fragments
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) load_a(qf[kk], sm.q, wrow, kk * 16);
  }

  // rows g and g + 8 of the warp: running max of the unscaled scores,
  // this lane's share of the row sum, and O columns 8 * j + 2 * t (+1)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;  // exp(scale * x) = exp2(sl2 * x)
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  int buf = 0;
  while (kt < a.Sk) {
    const int kn = next_kv(kt + kBK);
    // in flight while this tile computes
    if (kn < a.Sk) load_kv(kn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // the columns of this tile that any of the warp's rows can see by
    // position; 16-column slices at or past it hold no visible entry, so
    // their products are skipped (the mask below zeroes their p)
    const int k_valid = min(kBK, a.Sk - kt);
    const int ncols = min(k_valid, a.causal ? q0 + wrow + 16 - kt : kBK);
    if (active && ncols > 0) {
      const bf16* ks = sm.k[buf];
      const bf16* vs = sm.v[buf];
      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T: K rows are the columns of B, read as stored
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < kBK / 16; ++jp) {
          if (jp * 16 >= ncols) continue;
          uint32_t bk[4];
          load_b_nk(bk, ks, jp * 16, kk * 16);
          mma_16816(s[2 * jp], qf[kk], bk[0], bk[1]);
          mma_16816(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // mask in the accumulator layout, only where a tile needs it: at
      // the ragged edge, with segment ids, or where it crosses the causal
      // diagonal of the warp's rows. Column c of row i is visible iff
      // c <= lim[i] (and the ids match).
      const bool crosses = a.causal && kt + kBK - 1 > q0 + wrow;
      if (k_valid < kBK || kv_seg != nullptr || crosses) {
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          lim[i] = min(k_valid - 1,
                       a.causal ? q0 + wrow + g + 8 * i - kt : kBK) -
                   2 * t;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool ok = 8 * j + (e & 1) <= lim[e >> 1];
            if (kv_seg != nullptr)
              ok = ok && qs_row[e >> 1] ==
                             sm.kseg[buf][8 * j + 2 * t + (e & 1)];
            if (!ok) s[j][e] = kNegInf;
          }
        }
      }
      // the online softmax on unscaled scores, the scale folded into the
      // exponent: p = exp(scale * (s - m)) = exp2(sl2 * s - sl2 * m)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float corr[2], msl[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        corr[i] = exp2f((m[i] - m_new) * sl2);
        m[i] = m_new;
        // no visible key so far: exp(NEG_INF - NEG_INF) = 1 would average
        // garbage into the row, so its p must be 0 (empty rows emit 0);
        // every score of such a row is NEG_INF, and a huge subtrahend
        // sends exp2 to 0
        msl[i] = m_new > kNegInf * 0.5f ? m_new * sl2 : -kNegInf;
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[j][e], sl2, -msl[e >> 1]));
          s[j][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];

      // O += P V: P (rounded to bf16) from the S accumulators, V rows are
      // the k dimension of B, read through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk * 16 >= ncols) continue;
        uint32_t pa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kD / 16; ++dp) {
          uint32_t bv[4];
          load_b_kn(bv, vs, kk * 16, dp * 16);
          mma_16816(o[2 * dp], pa, bv[0], bv[1]);
          mma_16816(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
    kt = kn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  if (!active) return;
  // O / l rounded to bf16, staged in the warp's own Q rows (no other warp
  // reads them) so each lane stores 16 contiguous bytes
  float denom[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    denom[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / denom[i];
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(sm.q + (wrow + g + 8 * i) * kLDS + 8 * j +
                                   2 * t) =
          pack_bf16(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.o);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int c = lane + 32 * it;
    const int r = wrow + (c >> 3);
    const int col = (c & 7) * 8;
    if (r < q_valid)
      *reinterpret_cast<uint4*>(
          ob + ((static_cast<long long>(b) * a.Sq + q0 + r) * a.H + h) * kD +
          col) = *reinterpret_cast<const uint4*>(sm.q + r * kLDS + col);
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow + g + 8 * i;
      // empty rows record lse = 0 (the TPU kernel's rule: the backward
      // recomputes p = exp(s - lse), which must vanish for them)
      if (r < q_valid)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + q0 + r] =
            l[i] > 0.f ? m[i] * a.scale + logf(denom[i]) : 0.f;
    }
  }
}

}  // namespace

// variant: 0 = scalar f32, 2 = mma.sync bf16 (the wrapper's _fwd_variant
// picks it); any other code is refused. Strides are in elements. q_seg
// and kv_seg are both null or both [B, Sq] / [B, Sk] contiguous int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int adt_flash_fwd(int variant, const void* q, const void* k,
                             const void* v, const int* q_seg,
                             const int* kv_seg, void* o, float* lse, int B,
                             int H, int Sq, int Sk, int D, long long q_sb,
                             long long q_ss, long long q_sh, long long k_sb,
                             long long k_ss, long long k_sh, long long v_sb,
                             long long v_ss, long long v_sh, int causal,
                             float scale, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,    k,    v,    q_seg, kv_seg, o,    lse,  B,      H,
         Sq,   Sk,   q_sb, q_ss,  q_sh,   k_sb, k_ss, k_sh,   v_sb,
         v_ss, v_sh, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  if (variant == 0) {
    flash_fwd_kernel<<<grid, kThreads, 0, s>>>(a);
  } else if (variant == 2) {
    const dim3 mma_grid((Sq + kBM - 1) / kBM, H, B);
    flash_fwd_mma_kernel<<<mma_grid, kMmaThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
