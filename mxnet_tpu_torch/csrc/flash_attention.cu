// Flash attention forward and backward for Hopper (sm_90a): the training
// kernels of the transformer, over q [BH, Tq, D] and k / v [BH, Tk, D].
//
//   flash_fwd      replaces mxnet_tpu/kernels/flash_attention.py::_fwd_kernel:
//                  blocked softmax(Q K^T / sqrt(D)) V with an online
//                  (o, m, l) carried across key tiles; returns o in the
//                  input dtype and the fp32 row log-sum-exp
//                  lse = m + log(max(l, 1e-30)).
//   flash_bwd_dq   replaces flash_attention.py::_dq_kernel:
//                  dQ = scale * sum_k dS K, P = exp(S - lse),
//                  dS = P * (dO V^T - delta).
//   flash_bwd_dkv  replaces flash_attention.py::_dkv_kernel:
//                  dV = sum_q P^T dO, dK = sum_q dS^T (scale * Q).
//   flash_carry    replaces flash_attention.py::_carry_kernel (reached via
//                  flash_carry_block), one step of ring attention: folds a
//                  K/V shard into an unnormalised fp32 (o, m, l) carry,
//                  with the causal mask taken at global positions
//                  (q_offset + i >= kv_offset + j).
//
// Two routes. bfloat16 runs the tensor-core templates (wgmma, TMA loads
// into a ring of shared-memory stages, P kept in registers), which say
// there what bounds them and what their design does about it:
// flash_fwd and flash_carry run flash_fwd_sm90 (flash_fwd_sm90.cuh),
// flash_bwd_dq and flash_bwd_dkv run flash_bwd_dq_sm90 and
// flash_bwd_dkv_sm90 (flash_bwd_sm90.cuh); both include the primitives of
// sm90_common.cuh. float32 runs the CUDA-core kernels below, whose every
// dot is in fp32 (TF32 would not hold the fp32 gates).
//
// delta = rowsum(dO * O) is computed by the caller (a torch expression),
// as the JAX package computes it outside its kernels.
//
// The CUDA-core kernels' decomposition, as the TPU kernels: one CTA per
// (bh, 64-row query tile) for the forward, the carry step and dQ, looping
// over key tiles; one CTA per (bh, 64-row key tile) for dK/dV, looping
// over query tiles. Causal
// masking is top-left aligned (query i attends key j iff i >= j; the
// carry step shifts both by their global offsets); tiles wholly above
// the diagonal are skipped, and masked scores inside a live tile take the
// finite -1e30 of the reference. Unlike the TPU kernels, whose tiles must
// divide T, the last tile of either axis is bounds-masked, so any Tq and
// Tk work.
//
// CUDA-core arithmetic: everything in fp32, as the reference upcasts every
// tile to fp32 and dots in fp32. q is pre-scaled by 1/sqrt(D) in fp32
// when its tile is staged. Tiles are staged in shared memory as fp32 rows
// padded to D+1 floats (no bank conflicts for the row-wise dots), so a CTA
// needs 116 KB (forward), 149 KB (dQ) or 166 KB (dK/dV) at D=128, beyond
// the 48 KB default: each launch opts in with
// cudaFuncAttributeMaxDynamicSharedMemorySize. 256 threads form a 16 x 16
// grid; each thread owns a 4 x 4 block of a 64 x 64 score tile (rows
// ty + 16 i, columns tx + 16 j) and 4 x D/16 outputs, and row statistics
// are reduced across the 16 lanes that share a row by warp shuffles.
//
// Bound on an H100 SXM (its published 700 W peaks: 3.35 TB/s, 989 TFLOP/s
// bf16, 67 TFLOP/s fp32 off the tensor cores): at the training shape (BH
// 64, T 1024, D 128, causal) the bytes (q, k, v, o once: 67 MB in bf16,
// 20 us) and the tensor-core flops (17 GFLOP forward, 17 us) are both
// near 20 us; the CUDA-core kernels, with shared-memory reads as their
// limit (8 loads per 16 FMAs in the score dots), sit far above that
// (PERF.md has their times). flash_carry does the forward's work and
// moves the fp32 carry besides (o read and written: 8 D bytes a row
// against the 2 D of a bf16 q), so its bound is the bytes wherever a step
// is short or mostly masked.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*, every entry returns cudaGetLastError() (or the error of the
// shared-memory opt-in, or cudaErrorInvalidValue when a TMA map cannot be
// made) after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // finite mask value, as the reference
constexpr int kThreads = 256;       // a 16 x 16 thread grid
constexpr int kTile = 64;           // query and key rows of a tile
constexpr int kPS = kTile + 1;      // padded row of a score tile

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Stage rows [row0, row0 + kTile) of a [rows, D] matrix into dst as fp32
// rows of D+1 floats, times `mul`; rows past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int rows, float mul) {
  constexpr int V = Vec<T>::N;
  constexpr int VPR = D / V;   // vectors per row
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kThreads) {
    const int r = idx / VPR, cv = idx % VPR;
    float vals[V];
    if (row0 + r < rows) {
      load_vec(src + (size_t)(row0 + r) * D + cv * V, vals);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * (D + 1) + cv * V + e] = vals[e] * mul;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over staged tiles.
template <int D>
__device__ __forceinline__ void row_dots(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// Reductions over the 16 lanes that hold one row (lanes of one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Number of key tiles query tile `qt` attends (all of them unless causal).
__device__ __forceinline__ int live_key_tiles(int qt, int tk, int causal) {
  const int n = (tk + kTile - 1) / kTile;
  return causal ? min(n, qt + 1) : n;   // query tile qt ends at row 64 qt + 63
}

// ----------------------------------------------------------------------
// flash_fwd: grid (BH, ceil(Tq / 64)); the heaviest (last) query tiles of
// a causal grid are issued first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int causal,
                 float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [64][D+1], pre-scaled
  float* k_s = q_s + kTile * (D + 1);     // [64][D+1]
  float* v_s = k_s + kTile * (D + 1);     // [64][D+1]
  float* p_s = v_s + kTile * (D + 1);     // [64][65]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;
  stage_rows<T, D>(q_s, qb, q0, tq, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = live_key_tiles(qt, tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                      // the last tile's reads are done
    stage_rows<T, D>(k_s, kb, k0, tk, 1.f);
    stage_rows<T, D>(v_s, vb, k0, tk, 1.f);
    __syncthreads();
    float s[4][4];
    row_dots<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= tk) s[i][j] = -INFINITY;          // past the keys: p = 0
        else if (causal && qp < kp) s[i][j] = kNegInf;
      }
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(ps);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kPS + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * tq + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] / ll);
    if (tx == 0) lse[(size_t)bh * tq + row] = m[i] + logf(ll);
  }
}

// ----------------------------------------------------------------------
// flash_carry: grid (BH, ceil(Tq / 64)), as flash_fwd, but the online
// (o, m, l) starts from the carry (o_in, m_in, l_in) and is written back
// unnormalised in fp32: no lse, no floor on l. Causal liveness is taken at
// global positions: key tile kt is live iff kv_offset + 64 kt <= q_offset +
// q0 + 63 (_carry_kernel's test), and a masked score inside a live tile is
// -1e30, so a row that has seen no unmasked key gets p = exp(0) = 1 for
// each masked key, as the reference computes it. A query tile with no live
// key tile writes its carry through bitwise (the whole call, when the K/V
// shard lies past the diagonal).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_carry_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* o_in,
                   const float* m_in, const float* l_in, float* o_out,
                   float* m_out, float* l_out, int tq, int tk, int q_offset,
                   int kv_offset, int causal, float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [64][D+1], pre-scaled
  float* k_s = q_s + kTile * (D + 1);     // [64][D+1]
  float* v_s = k_s + kTile * (D + 1);     // [64][D+1]
  float* p_s = v_s + kTile * (D + 1);     // [64][65]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < tq;
    const size_t r = (size_t)bh * tq + row;
    m[i] = in ? m_in[r] : kNegInf;
    l[i] = in ? l_in[r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[i][c] = in ? o_in[r * D + tx + 16 * c] : 0.f;
  }
  int n_kt = (tk + kTile - 1) / kTile;
  if (causal) {
    // the last global query position of this tile, less the first key's
    const long long reach = (long long)q_offset + q0 + kTile - 1 - kv_offset;
    n_kt = reach < 0 ? 0 : (int)min((long long)n_kt, reach / kTile + 1);
  }
  if (n_kt > 0) stage_rows<T, D>(q_s, q + (size_t)bh * tq * D, q0, tq, scale);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                      // the last tile's reads are done
    stage_rows<T, D>(k_s, kb, k0, tk, 1.f);
    stage_rows<T, D>(v_s, vb, k0, tk, 1.f);
    __syncthreads();
    float s[4][4];
    row_dots<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qp = (long long)q_offset + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        if (kc >= tk) s[i][j] = -INFINITY;          // past the keys: p = 0
        else if (causal && qp < (long long)kv_offset + kc) s[i][j] = kNegInf;
      }
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(ps);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kPS + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const size_t r = (size_t)bh * tq + row;
#pragma unroll
    for (int c = 0; c < NC; ++c) o_out[r * D + tx + 16 * c] = acc[i][c];
    if (tx == 0) {
      m_out[r] = m[i];
      l_out[r] = l[i];
    }
  }
}

// ----------------------------------------------------------------------
// flash_bwd_dq: grid (BH, ceil(Tq / 64)), heaviest query tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int tq, int tk, int causal, float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [64][D+1], pre-scaled
  float* do_s = q_s + kTile * (D + 1);    // [64][D+1]
  float* k_s = do_s + kTile * (D + 1);    // [64][D+1]
  float* v_s = k_s + kTile * (D + 1);     // [64][D+1]
  float* ds_s = v_s + kTile * (D + 1);    // [64][65]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = (size_t)bh * tq * D, koff = (size_t)bh * tk * D;
  stage_rows<T, D>(q_s, q + qoff, q0, tq, scale);
  stage_rows<T, D>(do_s, dout + qoff, q0, tq, 1.f);
  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < tq ? lse[(size_t)bh * tq + row] : 0.f;
    row_delta[i] = row < tq ? delta[(size_t)bh * tq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = live_key_tiles(qt, tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage_rows<T, D>(k_s, k + koff, k0, tk, 1.f);
    stage_rows<T, D>(v_s, v + koff, k0, tk, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    row_dots<D>(s, q_s, k_s, ty, tx);
    row_dots<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        // a masked score is -1e30 in the reference, whose exp is 0
        const bool live = kp < tk && !(causal && qp < kp);
        const float p = live ? expf(s[i][j] - row_lse[i]) : 0.f;
        ds_s[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = k_s[kk * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = ds_s[(ty + 16 * i) * kPS + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(d, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    T* out = dq + qoff + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) out[tx + 16 * c] = from_float<T>(scale * acc[i][c]);
  }
}

// ----------------------------------------------------------------------
// flash_bwd_dkv: grid (BH, ceil(Tk / 64)). Key tile kt needs the query
// tiles from kt on when causal (the first tiles carry the most work and
// are issued first).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int tq, int tk, int causal,
                     float scale) {
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [64][D+1]
  float* v_s = k_s + kTile * (D + 1);     // [64][D+1]
  float* q_s = v_s + kTile * (D + 1);     // [64][D+1], pre-scaled
  float* do_s = q_s + kTile * (D + 1);    // [64][D+1]
  float* p_s = do_s + kTile * (D + 1);    // [64 q][65]
  float* ds_s = p_s + kTile * kPS;        // [64 q][65]
  float* lse_s = ds_s + kTile * kPS;      // [64]
  float* delta_s = lse_s + kTile;         // [64]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = (size_t)bh * tq * D, koff = (size_t)bh * tk * D;
  stage_rows<T, D>(k_s, k + koff, k0, tk, 1.f);
  stage_rows<T, D>(v_s, v + koff, k0, tk, 1.f);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (tq + kTile - 1) / kTile;
  // query tile qt is live iff it ends at or after the tile's first key
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage_rows<T, D>(q_s, q + qoff, q0, tq, scale);
    stage_rows<T, D>(do_s, dout + qoff, q0, tq, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < tq ? lse[(size_t)bh * tq + row] : 0.f;
      delta_s[threadIdx.x] = row < tq ? delta[(size_t)bh * tq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    row_dots<D>(s, q_s, k_s, ty, tx);     // rows: queries, columns: keys
    row_dots<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        const bool live = qp < tq && kp < tk && !(causal && qp < kp);
        const float p = live ? expf(s[i][j] - lse_s[r]) : 0.f;
        p_s[r * kPS + c] = p;
        ds_s[r * kPS + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int rr = 0; rr < kTile; ++rr) {
      float qv[NC], dov[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qv[c] = q_s[rr * (D + 1) + tx + 16 * c];
        dov[c] = do_s[rr * (D + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[rr * kPS + ty + 16 * i];
        const float d = ds_s[rr * kPS + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(p, dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(d, qv[c], dk_acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= tk) continue;
    T* dkr = dk + koff + (size_t)row * D;
    T* dvr = dv + koff + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkr[tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dvr[tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

constexpr size_t tiles_bytes(int d, int row_tiles, int score_tiles) {
  return sizeof(float) * ((size_t)row_tiles * kTile * (d + 1) +
                          (size_t)score_tiles * kTile * kPS + 2 * kTile);
}

// Launch `kernel` after opting in to the shared memory it needs.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int bh, int tq, int tk, int causal, float scale, cudaStream_t s) {
  return launch(flash_fwd_kernel<T, D>,
                dim3(bh, (tq + kTile - 1) / kTile), tiles_bytes(D, 3, 1), s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o),
                static_cast<float*>(lse), tq, tk, causal, scale);
}

template <typename T, int D>
int carry(const void* q, const void* k, const void* v, const void* o_in,
          const void* m_in, const void* l_in, void* o_out, void* m_out,
          void* l_out, int bh, int tq, int tk, int q_offset, int kv_offset,
          int causal, float scale, cudaStream_t s) {
  return launch(flash_carry_kernel<T, D>,
                dim3(bh, (tq + kTile - 1) / kTile), tiles_bytes(D, 3, 1), s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const float*>(o_in),
                static_cast<const float*>(m_in),
                static_cast<const float*>(l_in), static_cast<float*>(o_out),
                static_cast<float*>(m_out), static_cast<float*>(l_out), tq, tk,
                q_offset, kv_offset, causal, scale);
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int tq,
           int tk, int causal, float scale, cudaStream_t s) {
  return launch(flash_bwd_dq_kernel<T, D>,
                dim3(bh, (tq + kTile - 1) / kTile), tiles_bytes(D, 4, 1), s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), tq,
                tk, causal, scale);
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh,
            int tq, int tk, int causal, float scale, cudaStream_t s) {
  return launch(flash_bwd_dkv_kernel<T, D>,
                dim3(bh, (tk + kTile - 1) / kTile), tiles_bytes(D, 4, 2), s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), tq, tk, causal, scale);
}

bool args_ok(int dtype, int d, int bh, int tq, int tk) {
  return (dtype == 0 || dtype == 1) && (d == 64 || d == 128) && bh >= 1 &&
         tq >= 1 && tk >= 1 && (tq + kTile - 1) / kTile <= 65535 &&
         (tk + kTile - 1) / kTile <= 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients
// share it); lse and delta are float32 [BH, Tq].
int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              void* o, void* lse, int bh, int tq, int tk, int d, int causal,
              float scale, void* stream) {
  if (!args_ok(dtype, d, bh, tq, tk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d == 64
               ? fwd<float, 64>(q, k, v, o, lse, bh, tq, tk, causal, scale, s)
               : fwd<float, 128>(q, k, v, o, lse, bh, tq, tk, causal, scale,
                                 s);
  sm90::FwdArgs a = {};
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.tq = tq, a.tk = tk, a.causal = causal, a.scale = scale;
  return d == 64 ? sm90::launch<64, false>(q, k, v, a, bh, s)
                 : sm90::launch<128, false>(q, k, v, a, bh, s);
}

// One ring step: q, k, v in `dtype`; the carry o [BH, Tq, D], m and l
// [BH, Tq] are float32, read from *_in and written to *_out. q_offset and
// kv_offset are the global positions of q's and k's first rows.
int flash_carry(int dtype, const void* q, const void* k, const void* v,
                const void* o_in, const void* m_in, const void* l_in,
                void* o_out, void* m_out, void* l_out, int bh, int tq, int tk,
                int d, int q_offset, int kv_offset, int causal, float scale,
                void* stream) {
  if (!args_ok(dtype, d, bh, tq, tk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d == 64 ? carry<float, 64>(q, k, v, o_in, m_in, l_in, o_out, m_out,
                                      l_out, bh, tq, tk, q_offset, kv_offset,
                                      causal, scale, s)
                   : carry<float, 128>(q, k, v, o_in, m_in, l_in, o_out,
                                       m_out, l_out, bh, tq, tk, q_offset,
                                       kv_offset, causal, scale, s);
  sm90::FwdArgs a = {};
  a.o_in = static_cast<const float*>(o_in);
  a.m_in = static_cast<const float*>(m_in);
  a.l_in = static_cast<const float*>(l_in);
  a.o_out = static_cast<float*>(o_out);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.tq = tq, a.tk = tk, a.q_offset = q_offset, a.kv_offset = kv_offset;
  a.causal = causal, a.scale = scale;
  return d == 64 ? sm90::launch<64, true>(q, k, v, a, bh, s)
                 : sm90::launch<128, true>(q, k, v, a, bh, s);
}

int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int tq, int tk, int d, int causal,
                 float scale, void* stream) {
  if (!args_ok(dtype, d, bh, tq, tk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d == 64 ? bwd_dq<float, 64>(q, k, v, dout, lse, delta, dq, bh, tq,
                                       tk, causal, scale, s)
                   : bwd_dq<float, 128>(q, k, v, dout, lse, delta, dq, bh,
                                        tq, tk, causal, scale, s);
  sm90::BwdArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.tq = tq, a.tk = tk, a.causal = causal, a.scale = scale;
  return d == 64 ? sm90::launch_bwd<64>(true, q, k, v, dout, a, bh, s)
                 : sm90::launch_bwd<128>(true, q, k, v, dout, a, bh, s);
}

int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int tq, int tk, int d,
                  int causal, float scale, void* stream) {
  if (!args_ok(dtype, d, bh, tq, tk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d == 64 ? bwd_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv,
                                        bh, tq, tk, causal, scale, s)
                   : bwd_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv,
                                         bh, tq, tk, causal, scale, s);
  sm90::BwdArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.tq = tq, a.tk = tk, a.causal = causal, a.scale = scale;
  return d == 64 ? sm90::launch_bwd<64>(false, q, k, v, dout, a, bh, s)
                 : sm90::launch_bwd<128>(false, q, k, v, dout, a, bh, s);
}

}  // extern "C"
