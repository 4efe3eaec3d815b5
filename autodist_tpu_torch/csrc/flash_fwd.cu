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
// Design. One thread block per (q tile of 16 rows, head, batch): four
// warps, four query rows each. The block loops over kv tiles of 64 rows,
// staged in shared memory as f32; m, l and the two output columns each
// lane owns stay in registers across the loop (the TPU kernel carries
// them in VMEM scratch across a sequential grid axis instead). Ragged
// edges are masked here, so Sq and Sk need not divide the tiles and a
// decode step passes its one query as Sq = 1. Tiles with no visible entry
// are skipped before their K/V are read: causal tiles above the diagonal
// end the loop, and with segment ids a tile whose id range cannot meet
// the query tile's (_tile_live's range test) is skipped — in decode this
// is every tile past the slot's cursor, so a slot reads only its live
// prefix.
//
// Bound. Decode is bound by bytes: it must read each live K and V row once
// (2 * slots * T * H * D * 2 B = 33.5 MB a layer at slots 32, T 256, H 16,
// D 64 in bf16, about 10 us at 3.35 TB/s, less where cursors are short);
// its operations are 4 * slots * T * H * D = 34 MFLOP, far below the
// compute bound. This first kernel is scalar FMA on f32 tiles; tensor
// cores (wgmma), TMA and a split-KV decode grid are later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// p rounded to the value dtype, as the TPU kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

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

template <typename T>
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

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb +
                static_cast<long long>(q0) * a.q_ss + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_tile<T, kD>(q_s, qb, a.q_ss, kBQ, q_valid);
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

    load_tile<T, kD + 1>(k_s, kb + static_cast<long long>(k0) * a.k_ss,
                         a.k_ss, kBK, k_valid);
    load_tile<T, kD>(v_s, vb + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                     kBK, k_valid);
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
        p_s[warp][lane] = round_to<T>(p0);
        p_s[warp][lane + 32] = round_to<T>(p1);
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

  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r < q_valid) {
      const int row = q0 + r;
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = ob + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * kD;
      orow[lane] = from_float<T>(acc0[i] / denom);
      orow[lane + 32] = from_float<T>(acc1[i] / denom);
      if (lane == 0) {
        // empty rows record lse = 0 (the TPU kernel's rule: the backward
        // recomputes p = exp(s - lse), which must vanish for them)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] =
            l[i] > 0.f ? m[i] + logf(denom) : 0.f;
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. q_seg and
// kv_seg are both null or both [B, Sq] / [B, Sk] contiguous int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int adt_flash_fwd(int dtype, const void* q, const void* k,
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
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    flash_fwd_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    flash_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
