// Decode attention kernels for Hopper (sm_90a): one query step (or a
// short verify window) per lane against a long KV cache.
//
//   paged_decode   replaces mxnet_tpu/kernels/paged_decode.py::_paged_kernel
//                  (fp32/bf16 mode, any span): attention read straight
//                  from the block pool through per-lane block tables.
//   flash_decode   replaces mxnet_tpu/kernels/flash_attention.py::_decode_kernel:
//                  T_q=1 GQA attention against a dense [B, Tmax, KVH, D]
//                  cache with per-lane lengths, returning (o, lse).
//
// Bound on an H100: both kernels do about G flops per byte of bf16 cache
// (G query rows per KV head), far below the ~295 flop/byte ridge, so the bytes of live K/V read from HBM are
// the bound (live bytes / 3.35 TB/s). The design keeps every other byte
// off HBM: one CTA per (lane, KV head) reads each live cache row once per
// pass for all of its G (or span*G) query rows, the query rows and the
// cross-warp partials live in shared memory, and each thread loads one
// 16-byte vector of a key row so a warp reads whole 128-byte lines.
// Positions past a lane's length are never read, so a short lane costs
// its live length and not the table capacity. paged_decode makes two
// passes over K (statistics, then normalised probabilities x V) because
// the reference rounds the NORMALISED probabilities to the cache dtype
// before PV; a single-pass online softmax would change the bf16 numbers.
// Not done yet: split-K over the sequence (B*KVH CTAs under-fill 132 SMs
// at small batch), TMA / cp.async staging, and tensor-core dots.
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
__device__ __forceinline__ float key_group_sum(float x, int tpk) {
  for (int off = tpk >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
