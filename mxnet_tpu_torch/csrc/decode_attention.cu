// Decode attention kernels for Hopper (sm_90a): one query step (or a
// short verify window) per lane against a long KV cache.
//
//   paged_decode   replaces mxnet_tpu/kernels/paged_decode.py::_paged_kernel
//                  (fp32/bf16 mode, any span): attention read straight
//                  from the block pool through per-lane block tables.
//   paged_decode_int8
//                  replaces the same kernel's int8 mode: the pool holds
//                  int8 codes with fp32 scales per (position, KV head).
//   flash_decode   replaces mxnet_tpu/kernels/flash_attention.py::_decode_kernel:
//                  T_q=1 GQA attention against a dense [B, Tmax, KVH, D]
//                  cache with per-lane lengths, returning (o, lse).
//
// Bound on an H100: the kernels do about G flops per byte of bf16 cache
// (G query rows per KV head; 2G integer operations per byte of int8
// codes), far below the ~295 flop/byte ridge, so the bytes of live K/V
// read from HBM are the bound (live bytes / 3.35 TB/s; an int8 pool
// holds 2D + 8 bytes per position and KV head against 4D in bf16). The
// design keeps every other byte off HBM: one CTA per (lane, KV head)
// reads each live cache row once per pass for all of its G (or span*G)
// query rows, the query rows and the cross-warp partials live in shared
// memory, and each thread loads one 16-byte vector of a float key row (8
// bytes of an int8 one). Positions past a lane's length are never read,
// so a short lane costs its live length and not the table capacity. The
// paged kernels make two passes over K (statistics, then normalised
// probabilities x V) because the reference quantises the NORMALISED
// probabilities before PV (to the cache dtype, or to int8 codes with the
// row's own scale); a single-pass online softmax would change the
// numbers. Not done yet: split-K over the sequence (B*KVH CTAs under-fill
// 132 SMs at small batch), TMA / cp.async staging, and tensor-core dots
// (bf16, and s8 MMA for the int8 mode).
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive
// as void*, every entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // finite mask value, as the reference
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;        // query rows per CTA (span * G)
constexpr int kMaxDim = 128;        // head dim

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round to the cache dtype and back: the reference casts the normalised
// probabilities to the cache dtype before the PV product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Sum over the `tpk` lanes that share one key (aligned lane groups).
template <typename A>
__device__ __forceinline__ A key_group_sum(A x, int tpk) {
  for (int off = tpk >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The int8 code of x (already divided by its row's scale): round half to
// even (rintf, as torch.round and jnp.round), then clip to +-127.
__device__ __forceinline__ int quant_code(float x) {
  return (int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

// ----------------------------------------------------------------------
// paged_decode: grid (KVH, B), kThreads threads.
// q / out: [B, span, H, D] with H = KVH * G; packed row r = c * G + g
// reads q[b, c, h * G + g]. pools: [NB, bs, KVH, D]. tables: [B, nbl].
// Row r attends key positions t <= pos[b] + r / G.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ pos, T* __restrict__ out,
                    int kvh, int d, int bs, int nbl, int span, int g) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [ROWS, d]
  float* red = q_s + ROWS * d;                // [kWarps, ROWS, d]
  float* st_m = red + kWarps * ROWS * d;      // [kWarps, ROWS]
  float* st_l = st_m + kWarps * ROWS;         // [kWarps, ROWS]
  float* m_g = st_l + kWarps * ROWS;          // [ROWS]
  float* l_g = m_g + ROWS;                    // [ROWS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int rows = span * g;
  const int heads = kvh * g;
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    q_s[i] = to_float(
        q[((size_t)(b * span + r / g) * heads + h * g + r % g) * d + j]);
  }
  __syncthreads();

  const int tpk = d / V;             // threads per key row
  const int kpw = 32 / tpk;          // key rows per warp step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane % tpk, sub = lane / tpk;
  const int p0 = pos[b];
  const int last = min(p0 + span - 1, nbl * bs - 1);
  const float sqrt_d = sqrtf((float)d);
  const int32_t* table = tables + (size_t)b * nbl;
  const size_t head_off = (size_t)h * d + part * V;
  const int key_step = kWarps * kpw;

  // ---- pass 1: row max and sum over the live positions
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { m[r] = kNegInf; l[r] = 0.f; }
  for (int tb = warp * kpw; tb <= last; tb += key_step) {
    const int t = tb + sub;
    const bool live = t <= last;
    float kv[V];
    if (live) {
      const size_t cell = (size_t)table[t / bs] * bs + t % bs;
      load_vec(kpool + cell * kvh * d + head_off, kv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) kv[j] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) dot += q_s[r * d + part * V + j] * kv[j];
      const float s = key_group_sum(dot, tpk) / sqrt_d;
      if (live && t <= p0 + r / g) {
        const float mn = fmaxf(m[r], s);
        l[r] = l[r] * expf(m[r] - mn) + expf(s - mn);
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
    for (int off = tpk; off < 32; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], om);
      l[r] = l[r] * expf(m[r] - mn) + ol * expf(om - mn);
      m[r] = mn;
    }
    if (lane == 0) {
      st_m[warp * ROWS + r] = m[r];
      st_l[warp * ROWS + r] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mm = kNegInf, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float om = st_m[w * ROWS + r], ol = st_l[w * ROWS + r];
      const float mn = fmaxf(mm, om);
      ll = ll * expf(mm - mn) + ol * expf(om - mn);
      mm = mn;
    }
    m_g[r] = mm;
    l_g[r] = ll;
  }
  __syncthreads();

  // ---- pass 2: normalised probabilities, rounded to T, times V
  float acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  for (int tb = warp * kpw; tb <= last; tb += key_step) {
    const int t = tb + sub;
    const bool live = t <= last;
    float kv[V], vv[V];
    if (live) {
      const size_t cell = (size_t)table[t / bs] * bs + t % bs;
      load_vec(kpool + cell * kvh * d + head_off, kv);
      load_vec(vpool + cell * kvh * d + head_off, vv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) kv[j] = vv[j] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) dot += q_s[r * d + part * V + j] * kv[j];
      const float s = key_group_sum(dot, tpk) / sqrt_d;
      if (live && t <= p0 + r / g) {
        const float p = round_to<T>(expf(s - m_g[r]) / l_g[r]);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] += p * vv[j];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float a = acc[r][j];
      for (int off = tpk; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (sub == 0) red[(warp * ROWS + r) * d + part * V + j] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += red[(w * ROWS + r) * d + j];
    out[((size_t)(b * span + r / g) * heads + h * g + r % g) * d + j] =
        from_float<T>(o);
  }
}

// ----------------------------------------------------------------------
// paged_decode_int8: grid (KVH, B), kThreads threads; paged_decode's
// layout and walk on an int8 pool. kpool / vpool: [NB, bs, KVH, D] int8
// codes; ks / vs: [NB, bs, KVH] fp32 scales. q / out: float or bf16.
//
// The op order of the reference (_int8_cache_attention), step for step:
// each packed q row is quantised once (qs = max(max|q|, 1e-8) / 127,
// codes rint(q / qs) clipped to +-127); the score of key t is the exact
// integer dot of the codes, then ((s * qs) * ks[t]) / sqrt(D), so the
// scores are bitwise the reference's; pass 1 carries the row max m, sum l
// and amax = max over t of exp(s - m) * vs[t] online (the TPU kernel's
// amax = max(amax * alpha, ...)); pass 2 forms a = exp(s - m) / l, the
// re-quantised code rint(a * vs[t] / as) with as = max(amax / l, 1e-8)
// / 127, and sums code * v-code in int32 (exact, in any order: at most
// 127^2 per key, < 2^31 for 130k keys); the output is (float)sum * as in
// q's dtype. Each thread loads 8 codes (8 bytes) of a key row.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ kpool,
                         const int8_t* __restrict__ vpool,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int32_t* __restrict__ tables,
                         const int32_t* __restrict__ pos,
                         T* __restrict__ out, int kvh, int d, int bs,
                         int nbl, int span, int g) {
  constexpr int V = 8;
  extern __shared__ float smem[];
  float* q_f = smem;                                   // [ROWS, d]
  int* red = reinterpret_cast<int*>(q_f + ROWS * d);   // [kWarps, ROWS, d]
  float* st_m = reinterpret_cast<float*>(red + kWarps * ROWS * d);
  float* st_l = st_m + kWarps * ROWS;                  // [kWarps, ROWS]
  float* st_a = st_l + kWarps * ROWS;                  // [kWarps, ROWS]
  float* qs = st_a + kWarps * ROWS;                    // [ROWS]
  float* m_g = qs + ROWS;                              // [ROWS]
  float* l_g = m_g + ROWS;                             // [ROWS]
  float* as_g = l_g + ROWS;                            // [ROWS]
  // [ROWS, d] q codes; 16-byte aligned (every region above holds a
  // multiple of 4 floats)
  int8_t* q8 = reinterpret_cast<int8_t*>(as_g + ROWS);

  const int h = blockIdx.x, b = blockIdx.y;
  const int rows = span * g;
  const int heads = kvh * g;
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    q_f[i] = to_float(
        q[((size_t)(b * span + r / g) * heads + h * g + r % g) * d + j]);
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float amax = 0.f;
    for (int j = 0; j < d; ++j) amax = fmaxf(amax, fabsf(q_f[r * d + j]));
    qs[r] = fmaxf(amax, 1e-8f) / 127.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kThreads)
    q8[i] = (int8_t)quant_code(q_f[i] / qs[i / d]);
  __syncthreads();

  const int tpk = d / V;             // threads per key row
  const int kpw = 32 / tpk;          // key rows per warp step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane % tpk, sub = lane / tpk;
  const int p0 = pos[b];
  const int last = min(p0 + span - 1, nbl * bs - 1);
  const float sqrt_d = sqrtf((float)d);
  const int32_t* table = tables + (size_t)b * nbl;
  const size_t head_off = (size_t)h * d + part * V;
  const int key_step = kWarps * kpw;

  // ---- pass 1: row max, sum and amax over the live positions
  float m[ROWS], l[ROWS], amax[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    amax[r] = 0.f;
  }
  for (int tb = warp * kpw; tb <= last; tb += key_step) {
    const int t = tb + sub;
    const bool live = t <= last;
    int2 kw = make_int2(0, 0);
    float k_scale = 0.f, v_scale = 0.f;
    if (live) {
      const size_t cell = (size_t)table[t / bs] * bs + t % bs;
      kw = *reinterpret_cast<const int2*>(kpool + cell * kvh * d + head_off);
      k_scale = ks[cell * kvh + h];
      v_scale = vs[cell * kvh + h];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      const int2 qw = *reinterpret_cast<const int2*>(q8 + r * d + part * V);
      const int si =
          key_group_sum(__dp4a(qw.y, kw.y, __dp4a(qw.x, kw.x, 0)), tpk);
      if (live && t <= p0 + r / g) {
        const float s = (float)si * qs[r] * k_scale / sqrt_d;
        const float mn = fmaxf(m[r], s);
        const float alpha = expf(m[r] - mn);
        const float p = expf(s - mn);
        l[r] = l[r] * alpha + p;
        amax[r] = fmaxf(amax[r] * alpha, p * v_scale);
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
    for (int off = tpk; off < 32; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float oa = __shfl_xor_sync(0xffffffffu, amax[r], off);
      const float mn = fmaxf(m[r], om);
      const float a_self = expf(m[r] - mn), a_other = expf(om - mn);
      l[r] = l[r] * a_self + ol * a_other;
      amax[r] = fmaxf(amax[r] * a_self, oa * a_other);
      m[r] = mn;
    }
    if (lane == 0) {
      st_m[warp * ROWS + r] = m[r];
      st_l[warp * ROWS + r] = l[r];
      st_a[warp * ROWS + r] = amax[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mm = kNegInf, ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float om = st_m[w * ROWS + r];
      const float mn = fmaxf(mm, om);
      const float a_self = expf(mm - mn), a_other = expf(om - mn);
      ll = ll * a_self + st_l[w * ROWS + r] * a_other;
      aa = fmaxf(aa * a_self, st_a[w * ROWS + r] * a_other);
      mm = mn;
    }
    m_g[r] = mm;
    l_g[r] = ll;
    as_g[r] = fmaxf(aa / ll, 1e-8f) / 127.0f;
  }
  __syncthreads();

  // ---- pass 2: re-quantised probabilities times the V codes, in int32
  int acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0;
  for (int tb = warp * kpw; tb <= last; tb += key_step) {
    const int t = tb + sub;
    const bool live = t <= last;
    int2 kw = make_int2(0, 0), vw = make_int2(0, 0);
    float k_scale = 0.f, v_scale = 0.f;
    if (live) {
      const size_t cell = (size_t)table[t / bs] * bs + t % bs;
      kw = *reinterpret_cast<const int2*>(kpool + cell * kvh * d + head_off);
      vw = *reinterpret_cast<const int2*>(vpool + cell * kvh * d + head_off);
      k_scale = ks[cell * kvh + h];
      v_scale = vs[cell * kvh + h];
    }
    int vv[V];              // the 8 V codes, sign-extended
#pragma unroll
    for (int j = 0; j < V; ++j)
      vv[j] = (int)((unsigned)(j < 4 ? vw.x : vw.y) << (24 - 8 * (j % 4)))
              >> 24;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      const int2 qw = *reinterpret_cast<const int2*>(q8 + r * d + part * V);
      const int si =
          key_group_sum(__dp4a(qw.y, kw.y, __dp4a(qw.x, kw.x, 0)), tpk);
      if (live && t <= p0 + r / g) {
        const float s = (float)si * qs[r] * k_scale / sqrt_d;
        const float a = expf(s - m_g[r]) / l_g[r];
        const int c = quant_code(a * v_scale / as_g[r]);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] += c * vv[j];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      int a = acc[r][j];
      for (int off = tpk; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (sub == 0) red[(warp * ROWS + r) * d + part * V + j] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    int o = 0;
    for (int w = 0; w < kWarps; ++w) o += red[(w * ROWS + r) * d + j];
    out[((size_t)(b * span + r / g) * heads + h * g + r % g) * d + j] =
        from_float<T>((float)o * as_g[r]);
  }
}

// ----------------------------------------------------------------------
// flash_decode: grid (KVH, B), kThreads threads.
// q / out: [B, H, D] with H = KVH * G; lse: [B, H] fp32.
// k / v: [B, tmax, KVH, D]; row b attends positions t < lengths[b].
// Single pass: q is pre-scaled by 1/sqrt(D) in fp32, online softmax.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ lse, int kvh, int tmax, int d,
                    int g, float scale) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [ROWS, d]
  float* red = q_s + ROWS * d;                // [kWarps, ROWS, d]
  float* st_m = red + kWarps * ROWS * d;      // [kWarps, ROWS]
  float* st_l = st_m + kWarps * ROWS;         // [kWarps, ROWS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int heads = kvh * g;
  const size_t q_base = ((size_t)b * heads + h * g) * d;
  for (int i = threadIdx.x; i < g * d; i += kThreads)
    q_s[i] = to_float(q[q_base + i]) * scale;
  __syncthreads();

  const int tpk = d / V;
  const int kpw = 32 / tpk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane % tpk, sub = lane / tpk;
  const int len = min(lengths[b], tmax);
  const size_t head_off = (size_t)h * d + part * V;
  const T* kb = kc + (size_t)b * tmax * kvh * d;
  const T* vb = vc + (size_t)b * tmax * kvh * d;

  float m[ROWS], l[ROWS], acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  }
  for (int tb = warp * kpw; tb < len; tb += kWarps * kpw) {
    const int t = tb + sub;
    const bool live = t < len;
    float kv[V], vv[V];
    if (live) {
      load_vec(kb + (size_t)t * kvh * d + head_off, kv);
      load_vec(vb + (size_t)t * kvh * d + head_off, vv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) kv[j] = vv[j] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= g) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) dot += q_s[r * d + part * V + j] * kv[j];
      const float s = key_group_sum(dot, tpk);
      if (live) {
        const float mn = fmaxf(m[r], s);
        const float alpha = expf(m[r] - mn);
        const float p = expf(s - mn);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = acc[r][j] * alpha + p * vv[j];
        m[r] = mn;
      }
    }
  }
  // merge the key groups of each warp, then the warps
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= g) break;
    for (int off = tpk; off < 32; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float ol = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], om);
      const float a_self = expf(m[r] - mn), a_other = expf(om - mn);
      l[r] = l[r] * a_self + ol * a_other;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[r][j], off);
        acc[r][j] = acc[r][j] * a_self + oa * a_other;
      }
      m[r] = mn;
    }
    if (lane == 0) {
      st_m[warp * ROWS + r] = m[r];
      st_l[warp * ROWS + r] = l[r];
    }
    if (sub == 0) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        red[(warp * ROWS + r) * d + part * V + j] = acc[r][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const int r = i / d, j = i % d;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, st_m[w * ROWS + r]);
    float ll = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(st_m[w * ROWS + r] - mm);
      ll += st_l[w * ROWS + r] * a;
      o += red[(w * ROWS + r) * d + j] * a;
    }
    ll = fmaxf(ll, 1e-30f);
    out[q_base + i] = from_float<T>(o / ll);
    if (j == 0) lse[(size_t)b * heads + h * g + r] = mm + logf(ll);
  }
}

template <int ROWS>
size_t smem_bytes(int d, bool stats_g) {
  return sizeof(float) *
         ((size_t)ROWS * d + (size_t)kWarps * ROWS * d + 2 * kWarps * ROWS +
          (stats_g ? 2 * ROWS : 0));
}

template <typename T, int ROWS>
void launch_paged(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* pos, void* out, int b,
                  int kvh, int d, int bs, int nbl, int span, int g,
                  cudaStream_t stream) {
  paged_decode_kernel<T, ROWS>
      <<<dim3(kvh, b), kThreads, smem_bytes<ROWS>(d, true), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), static_cast<const int32_t*>(tables),
          static_cast<const int32_t*>(pos), static_cast<T*>(out), kvh, d,
          bs, nbl, span, g);
}

template <typename T, int ROWS>
void launch_paged_int8(const void* q, const void* kp, const void* vp,
                       const void* ks, const void* vs, const void* tables,
                       const void* pos, void* out, int b, int kvh, int d,
                       int bs, int nbl, int span, int g, cudaStream_t stream) {
  // q_f, red, three [kWarps, ROWS] and four [ROWS] statistics (4 bytes
  // each), then the [ROWS, d] int8 q codes
  const size_t smem = sizeof(float) * ((size_t)ROWS * d * (1 + kWarps) +
                                       3 * kWarps * ROWS + 4 * ROWS) +
                      (size_t)ROWS * d;
  paged_decode_int8_kernel<T, ROWS><<<dim3(kvh, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), kvh, d, bs,
      nbl, span, g);
}

template <typename T, int ROWS>
void launch_flash(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* lse, int b, int kvh,
                  int tmax, int d, int g, cudaStream_t stream) {
  flash_decode_kernel<T, ROWS>
      <<<dim3(kvh, b), kThreads, smem_bytes<ROWS>(d, false), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
          static_cast<T*>(out), static_cast<float*>(lse), kvh, tmax, d, g,
          1.0f / sqrtf((float)d));
}

// Smallest instantiated row count that holds `rows`, or 0.
int row_bucket(int rows) {
  if (rows <= 1) return 1;
  if (rows <= 2) return 2;
  if (rows <= 4) return 4;
  if (rows <= 8) return 8;
  if (rows <= kMaxRows) return kMaxRows;
  return 0;
}

bool shape_ok(int dtype, int d) {
  const int v = dtype == 0 ? 4 : 8;
  if (d % v || d > kMaxDim) return false;
  const int tpk = d / v;
  return tpk > 0 && tpk <= 32 && (tpk & (tpk - 1)) == 0;
}

#define DISPATCH_ROWS(LAUNCH, T, ROWS_RUNTIME, ...)          \
  switch (row_bucket(ROWS_RUNTIME)) {                        \
    case 1: LAUNCH<T, 1>(__VA_ARGS__); break;                \
    case 2: LAUNCH<T, 2>(__VA_ARGS__); break;                \
    case 4: LAUNCH<T, 4>(__VA_ARGS__); break;                \
    case 8: LAUNCH<T, 8>(__VA_ARGS__); break;                \
    default: LAUNCH<T, kMaxRows>(__VA_ARGS__); break;        \
  }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
int paged_decode(int dtype, const void* q, const void* kpool,
                 const void* vpool, const void* tables, const void* pos,
                 void* out, int b, int kvh, int d, int bs, int nbl, int span,
                 int g, void* stream) {
  if (!shape_ok(dtype, d) || row_bucket(span * g) == 0 || b < 1 ||
      kvh < 1 || span < 1 || g < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_ROWS(launch_paged, float, span * g, q, kpool, vpool, tables,
                  pos, out, b, kvh, d, bs, nbl, span, g, s)
  } else {
    DISPATCH_ROWS(launch_paged, __nv_bfloat16, span * g, q, kpool, vpool,
                  tables, pos, out, b, kvh, d, bs, nbl, span, g, s)
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q and out); pools int8, scales fp32.
int paged_decode_int8(int dtype, const void* q, const void* kpool,
                      const void* vpool, const void* ks, const void* vs,
                      const void* tables, const void* pos, void* out, int b,
                      int kvh, int d, int bs, int nbl, int span, int g,
                      void* stream) {
  const int tpk = d / 8;   // threads per key row: 8 codes each
  if (d < 8 || d % 8 || d > kMaxDim || (tpk & (tpk - 1)) ||
      row_bucket(span * g) == 0 || b < 1 || kvh < 1 || span < 1 || g < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_ROWS(launch_paged_int8, float, span * g, q, kpool, vpool, ks,
                  vs, tables, pos, out, b, kvh, d, bs, nbl, span, g, s)
  } else {
    DISPATCH_ROWS(launch_paged_int8, __nv_bfloat16, span * g, q, kpool,
                  vpool, ks, vs, tables, pos, out, b, kvh, d, bs, nbl, span,
                  g, s)
  }
  return (int)cudaGetLastError();
}

int flash_decode(int dtype, const void* q, const void* k, const void* v,
                 const void* lengths, void* out, void* lse, int b, int kvh,
                 int tmax, int d, int g, void* stream) {
  if (!shape_ok(dtype, d) || row_bucket(g) == 0 || b < 1 || kvh < 1 ||
      tmax < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_ROWS(launch_flash, float, g, q, k, v, lengths, out, lse, b,
                  kvh, tmax, d, g, s)
  } else {
    DISPATCH_ROWS(launch_flash, __nv_bfloat16, g, q, k, v, lengths, out,
                  lse, b, kvh, tmax, d, g, s)
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
