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
// holds 2D + 8 bytes per position and KV head against 4D in bf16). To
// reach it the card needs bytes in flight on every SM, and a serving
// batch has few (lane, KV head) pairs: 8 lanes x 8 heads is 64 CTAs for
// 132 SMs. So all three are split-K over the sequence: a grid of (splits, KVH, B) CTAs, the split count and the
// largest chunk chosen on the host from the shapes alone
// (kernels/common.py decode_splits; no device value is read back, so a
// decode step gains no sync). Served lanes are mostly far shorter than
// the cache's capacity, so each CTA sizes its lane's chunk from the
// length it reads anyway (lane_chunk: the live length over the splits,
// rounded up to a granule, at most the host's chunk; the granule is
// kFlashGranule positions for flash_decode and one block for both paged
// modes, so a paged CTA reads whole table entries), and CTA s walks
// [s * C, (s + 1) * C): a short lane spreads over the splits as a full
// one does, instead of leaving one CTA to walk it in series. A chunk at
// or past a lane's live length exits at once. Each CTA reads each of its
// cache rows once for all of its G (or span * G) query rows, keeps the
// query rows and the cross-warp partials in shared memory, and in the
// float kernels each thread loads one 16-byte vector of a key row; with
// the grid full, loading two keys a thread before using them measured no
// faster (PERF.md), so each takes one. The splits' partials go to one
// fp32 scratch buffer that the wrapper allocates (Partials, Int8Partials
// below) and are merged in a fixed order, with no atomics on floats, so
// two calls are bitwise equal:
//
//   flash_decode   flash_decode_split_kernel writes each row's (m, l,
//                  unnormalised acc) over its chunk (one pass, online
//                  softmax, q pre-scaled by 1/sqrt(D) in fp32);
//                  flash_decode_combine_kernel merges them into (o, lse).
//   paged_decode   the reference quantises the NORMALISED probabilities
//                  before PV (it rounds them to the cache dtype), which
//                  needs each row's global (m, l) before any probability
//                  exists, so it keeps two passes. paged_scores_kernel
//                  writes each split's (m, l) and every score to scratch
//                  (a row of the table capacity per query row, which
//                  stays in L2); paged_pv_kernel merges all splits'
//                  (m, l), forms p = round_to<T>(exp(s - m) / l) from the
//                  stored scores, bitwise the ones pass 1 computed, and
//                  writes its chunk's PV; paged_combine_kernel sums the
//                  splits. K is read once and V once.
//   paged_decode_int8
//                  the same two passes and combine on the int8 pool, its
//                  statistics (m, l, amax) and its PV sums exact int32
//                  (paged_int8_scores_kernel, paged_int8_pv_kernel,
//                  paged_int8_combine_kernel): small CTAs that stage their
//                  table entries once and their rows by cp.async, and
//                  dp4a for both integer dots (see the int8 section).
//
// tests/test_torch_decode_split.py and tests/test_torch_int8_split.py
// model the split arithmetic on the CPU and pin the lines they copy;
// chip_smoke.py holds every kernel against its plain version on the card.
//
// Not done yet: TMA / cp.async staging for the float kernels, and
// tensor-core dots for the bf16 decode kernels. The int8 dots on the s8
// tensor cores (mma.sync m16n8k32) measured slower than dp4a at one query
// row a KV head and faster at 16 (PERF.md), so dp4a stays.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive
// as void*, every entry checks cudaGetLastError() after each of its
// launches and returns the first error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // finite mask value, as the reference
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;        // query rows per CTA (span * G)
constexpr int kMaxDim = 128;        // head dim
constexpr int kMaxSplits = 64;      // splits of a split-K launch
constexpr int kFlashGranule = 32;   // flash_decode's lane chunks: multiples

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
// Split-K partials. Query rows are numbered (b * kvh + h) * rows + r for
// the r-th row of lane b and KV head h; the wrapper's fp32 scratch holds,
// in this order, m [R, splits], l [R, splits], `extra` floats per row
// (paged_decode's scores [R, cap]; none for flash_decode) and acc
// [R, splits, d]. A split that attends no position of a row leaves
// (m, l) = (-1e30, 0) there, and acc is then never read (taken as 0).
struct Partials {
  float* m;
  float* l;
  float* extra;
  float* acc;
  int splits;

  __device__ Partials(float* base, size_t nrows, int splits_, size_t per_row)
      : m(base),
        l(base + nrows * splits_),
        extra(base + 2 * nrows * splits_),
        acc(base + 2 * nrows * splits_ + nrows * per_row),
        splits(splits_) {}
  __device__ size_t at(size_t row, int split) const {
    return row * splits + split;
  }
  __device__ void empty(size_t row, int split) const {
    m[at(row, split)] = kNegInf;
    l[at(row, split)] = 0.f;
  }
};

// The chunk of a lane with `live` positions to attend: its live length
// spread evenly over the splits, rounded up to a multiple of `granule`,
// and at most the host's `chunk` (whose splits cover the capacity). A
// lane with nothing live gets 0, so every split of it is empty.
__device__ __forceinline__ int lane_chunk(int live, int splits, int chunk,
                                          int granule) {
  const int even = (max(live, 0) + splits - 1) / splits;
  return min(chunk, (even + granule - 1) / granule * granule);
}

// ----------------------------------------------------------------------
// paged_decode, pass 1: grid (splits, KVH, B), kThreads threads.
// q: [B, span, H, D] with H = KVH * G; packed row r = c * G + g reads
// q[b, c, h * G + g]. kpool: [NB, bs, KVH, D]. tables: [B, nbl].
// Row r attends key positions t <= pos[b] + r / G, and no position past
// the table's capacity nbl * bs. With C = lane_chunk(last + 1, ...), the
// CTA of split s covers positions [s * C, min((s + 1) * C, last + 1)); it
// writes every score of its positions (all rows, masked or not) and each
// row's (m, l).
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_scores_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ pos,
                    float* __restrict__ scratch, int kvh, int d, int bs,
                    int nbl, int span, int g, int chunk) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [ROWS, d]
  float* st_m = q_s + ROWS * d;               // [kWarps, ROWS]
  float* st_l = st_m + kWarps * ROWS;         // [kWarps, ROWS]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rows = span * g, heads = kvh * g, cap = nbl * bs;
  const Partials part(scratch, (size_t)gridDim.z * kvh * rows, gridDim.x,
                      cap);
  const size_t row0 = ((size_t)b * kvh + h) * rows;
  const int p0 = pos[b];
  const int last = min(p0 + span - 1, cap - 1);
  const int lane_c = lane_chunk(last + 1, gridDim.x, chunk, bs);
  const int start = split * lane_c;
  const int end = min(start + lane_c, last + 1);
  if (start >= end) {
    if (threadIdx.x < rows) part.empty(row0 + threadIdx.x, split);
    return;
  }
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    q_s[i] = to_float(
        q[((size_t)(b * span + r / g) * heads + h * g + r % g) * d + j]);
  }
  __syncthreads();

  const int tpk = d / V;             // threads per key row
  const int kpw = 32 / tpk;          // key rows per warp step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part_i = lane % tpk, sub = lane / tpk;
  const float sqrt_d = sqrtf((float)d);
  const int32_t* table = tables + (size_t)b * nbl;
  const size_t head_off = (size_t)h * d + part_i * V;
  const int key_step = kWarps * kpw;

  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { m[r] = kNegInf; l[r] = 0.f; }
  for (int tb = start + warp * kpw; tb < end; tb += key_step) {
    const int t = tb + sub;
    const bool live = t < end;
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
      for (int j = 0; j < V; ++j) dot += q_s[r * d + part_i * V + j] * kv[j];
      const float s = key_group_sum(dot, tpk) / sqrt_d;
      if (live) {
        if (part_i == 0) part.extra[(row0 + r) * cap + t] = s;
        if (t <= p0 + r / g) {
          const float mn = fmaxf(m[r], s);
          l[r] = l[r] * expf(m[r] - mn) + expf(s - mn);
          m[r] = mn;
        }
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
    part.m[part.at(row0 + r, split)] = mm;
    part.l[part.at(row0 + r, split)] = ll;
  }
}

// paged_decode, pass 2: grid (splits, KVH, B), kThreads threads; the
// layout of pass 1. Merges every split's (m, l) of its rows in split
// order (each CTA of a lane and head computes the same), then sums
// round_to<T>(exp(s - m) / l) * v over its chunk's attended positions
// from the stored scores, and writes that PV partial in fp32.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_pv_kernel(const T* __restrict__ vpool,
                const int32_t* __restrict__ tables,
                const int32_t* __restrict__ pos, float* __restrict__ scratch,
                int kvh, int d, int bs, int nbl, int span, int g,
                int chunk) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* red = smem;                          // [kWarps, ROWS, d]
  float* m_g = red + kWarps * ROWS * d;       // [ROWS]
  float* l_g = m_g + ROWS;                    // [ROWS]
  float* ml = l_g + ROWS;                     // [2, rows, splits]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rows = span * g, cap = nbl * bs;
  const Partials part(scratch, (size_t)gridDim.z * kvh * rows, splits, cap);
  const size_t row0 = ((size_t)b * kvh + h) * rows;
  const int p0 = pos[b];
  const int last = min(p0 + span - 1, cap - 1);
  const int lane_c = lane_chunk(last + 1, splits, chunk, bs);
  const int start = split * lane_c;
  const int end = min(start + lane_c, last + 1);
  if (start >= end) return;
  // every split's (m, l) of the CTA's rows, loaded at once, then merged
  // in split order by one thread a row
  for (int i = threadIdx.x; i < rows * splits; i += kThreads) {
    ml[i] = part.m[row0 * splits + i];
    ml[rows * splits + i] = part.l[row0 * splits + i];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const float* m_r = ml + threadIdx.x * splits;
    const float* l_r = m_r + rows * splits;
    float mm = kNegInf;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, m_r[s]);
    float ll = 0.f;
    for (int s = 0; s < splits; ++s) ll += l_r[s] * expf(m_r[s] - mm);
    m_g[threadIdx.x] = mm;
    l_g[threadIdx.x] = ll;
  }
  __syncthreads();

  const int tpk = d / V;
  const int kpw = 32 / tpk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part_i = lane % tpk, sub = lane / tpk;
  const int32_t* table = tables + (size_t)b * nbl;
  const size_t head_off = (size_t)h * d + part_i * V;
  const int key_step = kWarps * kpw;
  const float* scores = part.extra + row0 * cap;

  float acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  for (int tb = start + warp * kpw; tb < end; tb += key_step) {
    const int t = tb + sub;
    if (t >= end) continue;
    float vv[V];
    const size_t cell = (size_t)table[t / bs] * bs + t % bs;
    load_vec(vpool + cell * kvh * d + head_off, vv);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      if (t <= p0 + r / g) {
        const float p = round_to<T>(
            expf(scores[(size_t)r * cap + t] - m_g[r]) / l_g[r]);
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
      if (sub == 0) red[(warp * ROWS + r) * d + part_i * V + j] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += red[(w * ROWS + r) * d + j];
    part.acc[part.at(row0 + r, split) * d + j] = o;
  }
}

// paged_decode, combine: grid (KVH, B), kThreads threads, one thread a
// (row, d) element of the CTA's rows; the splits' PV partials summed in
// split order (a split whose l is 0 left no partial), cast to T and
// written to out [B, span, H, D]. The loads of all splits are issued
// before their sum, with no branch between them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(float* __restrict__ scratch, T* __restrict__ out,
                     int splits, int d, int cap, int span, int g) {
  extern __shared__ float live[];             // [rows, splits]: l > 0
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = gridDim.x, rows = span * g;
  const Partials part(scratch, (size_t)gridDim.y * kvh * rows, splits, cap);
  const size_t row0 = ((size_t)b * kvh + h) * rows;
  for (int i = threadIdx.x; i < rows * splits; i += kThreads)
    live[i] = part.l[row0 * splits + i] > 0.f ? 1.f : 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    const float* acc = part.acc + (row0 + r) * splits * d + j;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float a = acc[(size_t)s * d];
      o += live[r * splits + s] != 0.f ? a : 0.f;
    }
    out[((size_t)(b * span + r / g) * kvh * g + h * g + r % g) * d + j] =
        from_float<T>(o);
  }
}

// ----------------------------------------------------------------------
// paged_decode_int8: B3's int8 mode on paged_decode's (splits, KVH, B)
// grid and split plan. kpool / vpool: [NB, bs, KVH, D] int8 codes; ks /
// vs: [NB, bs, KVH] fp32 scales; q / out: float or bf16; D 32, 64 or 128.
//
// The op order of the reference (_int8_cache_attention), step for step:
// each packed q row is quantised once (qs = max(max|q|, 1e-8) / 127,
// codes rint(q / qs) clipped to +-127); the score of key t is the exact
// integer dot of the codes, then ((s * qs) * ks[t]) / sqrt(D), so the
// scores are bitwise the reference's; the row max m, sum l and amax = max
// over t of exp(s - m) * vs[t] are carried online (the TPU kernel's amax =
// max(amax * alpha, ...)); a = exp(s - m) / l is re-quantised to the code
// rint(a * vs[t] / as) with as = max(amax / l, 1e-8) / 127; code * v-code
// is summed in int32 (exact, in any order: at most 127^2 per key, < 2^31
// for 130k keys); the output is (float)sum * as in q's dtype.
//
// Split-K, as paged_decode: pass 1 (paged_int8_scores_kernel) writes each
// split's (m, l, amax) and every score to scratch (Int8Partials); pass 2
// (paged_int8_pv_kernel) merges all splits' statistics in split order,
// with amax_s carried to the global max as amax_s * exp(m_s - m), forms
// the codes from the stored scores and writes its chunk's int32 sums;
// paged_int8_combine_kernel adds the splits' sums and scales them. K is
// read once (pass 1) and V once (pass 2).
//
// The passes do a few integer operations per byte, so the bytes bound
// them; what keeps a pass from that bound is how soon a CTA has its rows:
// it reads pos, then its table entries, then the rows they point to. A
// CTA copies its chunk's table entries to
// shared memory once, then streams its rows through a ring of kStages
// slots of kTile positions with cp.async (each position's D code bytes of
// its head, a stride of KVH * D apart in the pool, and its scales), all
// slots issued at once, so the wait for an entry and then for its row is
// paid once per chunk, not once per key. CTAs are small (kI8Threads, one
// position a thread per tile, ~12 KB of shared memory at D = 64) so that
// the whole served-pool grid (2304 CTAs) is resident in one wave; three
// ring slots, or rows without padding, measured slower there (PERF.md).

constexpr int kI8Threads = 64;     // threads of an int8 pass CTA
constexpr int kI8Warps = kI8Threads / 32;
constexpr int kTile = kI8Threads;  // positions per ring slot: one a thread
constexpr int kStages = 2;         // ring slots
constexpr int kRowPad = 16;        // bytes after each staged code row
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one CTA

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The int8 split partials. Rows are numbered as in Partials; the fp32
// scratch holds m, l and amax [R, splits], the scores [R, cap] and the
// int32 PV sums [R, splits, d]. A split that attends no position of a row
// leaves (m, l, amax) = (-1e30, 0, 0) there, and its sums are never read.
struct Int8Partials {
  float* m;
  float* l;
  float* amax;
  float* scores;
  int* acc;
  int splits;

  __device__ Int8Partials(float* base, size_t nrows, int splits_, int cap)
      : m(base),
        l(base + nrows * splits_),
        amax(base + 2 * nrows * splits_),
        scores(base + 3 * nrows * splits_),
        acc(reinterpret_cast<int*>(base + 3 * nrows * splits_ +
                                   nrows * cap)),
        splits(splits_) {}
  __device__ size_t at(size_t row, int split) const {
    return row * splits + split;
  }
  __device__ void empty(size_t row, int split) const {
    m[at(row, split)] = kNegInf;
    l[at(row, split)] = 0.f;
    amax[at(row, split)] = 0.f;
  }
};

// Regions of a dynamic shared-memory buffer, each 16-byte aligned.
struct Carve {
  size_t at = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = at;
    at += (bytes + 15) / 16 * 16;
    return o;
  }
};

// Shared memory of pass 1 for `rows` query rows, head dim d and a chunk
// of `ents` table entries, as byte offsets. A staged code row takes d +
// kRowPad bytes, so the 16-byte loads of 8 threads, each on its own row,
// fall in distinct banks.
struct Int8ScoresSmem {
  size_t codes, ks, vs, q8, qs, stats, tbl, bytes;
  __host__ __device__ Int8ScoresSmem(int rows, int d, int ents) {
    Carve c;
    codes = c.take((size_t)kStages * kTile * (d + kRowPad));
    ks = c.take(sizeof(float) * kStages * kTile);
    vs = c.take(sizeof(float) * kStages * kTile);
    q8 = c.take((size_t)rows * d);
    qs = c.take(sizeof(float) * rows);
    stats = c.take(sizeof(float) * 3 * kI8Warps * rows);
    tbl = c.take(sizeof(int) * ents);
    bytes = c.at;
  }
};

// Shared memory of pass 2; `red`, the cross-warp sums, reuses the ring
// once the last tile is used.
struct Int8PvSmem {
  size_t codes, vs, scores, red, pcode, stats, merged, tbl, bytes;
  __host__ __device__ Int8PvSmem(int rows, int d, int ents, int splits) {
    Carve ring;
    codes = ring.take((size_t)kStages * kTile * (d + kRowPad));
    vs = ring.take(sizeof(float) * kStages * kTile);
    scores = ring.take(sizeof(float) * kStages * rows * kTile);
    red = 0;
    const size_t red_bytes = sizeof(int) * kI8Warps * rows * d;
    Carve c;
    c.take(ring.at > red_bytes ? ring.at : red_bytes);
    pcode = c.take((size_t)rows * kTile);
    stats = c.take(sizeof(float) * 3 * rows * splits);
    merged = c.take(sizeof(float) * 3 * rows);
    tbl = c.take(sizeof(int) * ents);
    bytes = c.at;
  }
};

// A CTA's chunk of one lane and KV head in the pool: tbl holds the lane's
// table entries from `first` on, and position t's row of head h is row
// at(t) of a leaf of [NB * bs * KVH] rows.
struct ChunkRows {
  const int* tbl;
  int first, bs, kvh, h;
  __device__ size_t at(int t) const {
    return ((size_t)tbl[t / bs - first] * bs + t % bs) * kvh + h;
  }
};

// Copy the table entries of positions [start, end) (start a multiple of
// bs) to tbl; returns the chunk's rows.
__device__ __forceinline__ ChunkRows stage_table(int* tbl,
                                                 const int32_t* table,
                                                 int start, int end, int bs,
                                                 int kvh, int h) {
  const int first = start / bs, n = (end - 1) / bs - first + 1;
  for (int i = threadIdx.x; i < n; i += kI8Threads)
    tbl[i] = table[first + i];
  return ChunkRows{tbl, first, bs, kvh, h};
}

// Issue the copy of one position's d code bytes, in 16-byte pieces.
__device__ __forceinline__ void stage_row(int8_t* dst, const int8_t* src,
                                          int d) {
  for (int c = 0; c < d; c += 16) cp_async16(dst + c, src + c);
}

// Quantise the CTA's packed q rows (row r = c * G + g reads q[b, c,
// h * G + g]) into int8 codes q8 [rows, d] and scales qs [rows]: one warp
// a row, its max found with shuffles (a max is exact in any order).
template <typename T>
__device__ __forceinline__ void quantise_rows(const T* q, int b, int h,
                                              int kvh, int span, int g,
                                              int d, int8_t* q8, float* qs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < span * g; r += kI8Warps) {
    const T* qr = q + ((size_t)(b * span + r / g) * kvh * g + h * g + r % g) *
                          d;
    float x[kMaxDim / 32];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDim / 32; ++i) {
      const int j = lane + 32 * i;
      x[i] = j < d ? to_float(qr[j]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
    for (int i = 0; i < kMaxDim / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < d) q8[r * d + j] = (int8_t)quant_code(x[i] / scale);
    }
    if (lane == 0) qs[r] = scale;
  }
}

// Add score s of key t (its V scale vs) to a row's online (m, l, amax):
// one exp, since one of exp(m - max) and exp(s - max) is exp(0) = 1.
__device__ __forceinline__ void online_add(float s, float vs, float& m,
                                           float& l, float& amax) {
  if (s > m) {
    const float alpha = expf(m - s);
    l = l * alpha + 1.f;
    amax = fmaxf(amax * alpha, vs);
    m = s;
  } else {
    const float p = expf(s - m);
    l += p;
    amax = fmaxf(amax, p * vs);
  }
}

// Merge (om, ol, oa) into (m, l, amax), two rows' online statistics.
__device__ __forceinline__ void online_merge(float om, float ol, float oa,
                                             float& m, float& l,
                                             float& amax) {
  const float mn = fmaxf(m, om);
  const float a_self = expf(m - mn), a_other = expf(om - mn);
  l = l * a_self + ol * a_other;
  amax = fmaxf(amax * a_self, oa * a_other);
  m = mn;
}

// Merge every split's (m, l, amax) of one row in split order: the row's
// max m, its sum l and its probability scale as = max(amax / l, 1e-8) /
// 127, each split's amax carried to the row's max. A split that attended
// nothing of the row, (-1e30, 0, 0), adds nothing.
__device__ __forceinline__ void merge_int8_stats(const float* m_r,
                                                 const float* l_r,
                                                 const float* a_r,
                                                 int splits, float& mm,
                                                 float& ll, float& as) {
  mm = kNegInf;
  for (int s = 0; s < splits; ++s) mm = fmaxf(mm, m_r[s]);
  ll = 0.f;
  float aa = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(m_r[s] - mm);
    ll += l_r[s] * w;
    aa = fmaxf(aa, a_r[s] * w);
  }
  as = fmaxf(aa / ll, 1e-8f) / 127.0f;
}

// The 4 x 4 bytes of w[0..3] transposed: byte i of t[j] is byte j of w[i].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&t)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// CTAs of an int8 pass an SM should hold, for the registers: 18 at up to
// 2 rows (the served pool's 2304 CTAs in one wave), fewer above.
#define I8_BOUNDS(ROWS) \
  __launch_bounds__(kI8Threads, (ROWS) <= 2 ? 18 : (ROWS) <= 4 ? 12 : 8)

// paged_decode_int8, pass 1: grid (splits, KVH, B), kI8Threads threads.
// As paged_scores_kernel, on the int8 pool: the CTA of split s covers
// positions [s * C, min((s + 1) * C, last + 1)) with C = lane_chunk(last
// + 1, ...), streams their K codes and both scales, writes every score of
// its positions and each row's (m, l, amax). Thread i takes position i of
// each tile: each 16 bytes of its code row dotted with each q row's by
// dp4a.
template <typename T, int ROWS>
__global__ void I8_BOUNDS(ROWS)
paged_int8_scores_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ kpool,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int32_t* __restrict__ tables,
                         const int32_t* __restrict__ pos,
                         float* __restrict__ scratch, int kvh, int d, int bs,
                         int nbl, int span, int g, int chunk) {
  extern __shared__ __align__(16) unsigned char smem8[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int rows = span * g, cap = nbl * bs;
  const Int8Partials part(scratch, (size_t)gridDim.z * kvh * rows,
                          gridDim.x, cap);
  const size_t row0 = ((size_t)b * kvh + h) * rows;
  const int p0 = pos[b];
  const int last = min(p0 + span - 1, cap - 1);
  const int lane_c = lane_chunk(last + 1, gridDim.x, chunk, bs);
  const int start = split * lane_c;
  const int end = min(start + lane_c, last + 1);
  if (start >= end) {
    if (threadIdx.x < rows) part.empty(row0 + threadIdx.x, split);
    return;
  }
  const Int8ScoresSmem lay(ROWS, d, chunk / bs);
  int8_t* codes = reinterpret_cast<int8_t*>(smem8 + lay.codes);
  float* ks_s = reinterpret_cast<float*>(smem8 + lay.ks);
  float* vs_s = reinterpret_cast<float*>(smem8 + lay.vs);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem8 + lay.q8);
  float* qs = reinterpret_cast<float*>(smem8 + lay.qs);
  float* st_m = reinterpret_cast<float*>(smem8 + lay.stats);
  float* st_l = st_m + kI8Warps * ROWS;
  float* st_a = st_l + kI8Warps * ROWS;
  const ChunkRows cr =
      stage_table(reinterpret_cast<int*>(smem8 + lay.tbl),
                  tables + (size_t)b * nbl, start, end, bs, kvh, h);
  __syncthreads();
  const int stride = d + kRowPad;
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int i_slot = threadIdx.x;      // this thread's position in a tile
  auto stage = [&](int i) {
    const int slot = i % kStages, t = start + i * kTile + i_slot;
    if (t < end) {
      const size_t row = cr.at(t);
      stage_row(codes + (slot * kTile + i_slot) * stride, kpool + row * d, d);
      cp_async4(ks_s + slot * kTile + i_slot, ks + row);
      cp_async4(vs_s + slot * kTile + i_slot, vs + row);
    }
  };
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }
  quantise_rows(q, b, h, kvh, span, g, d, q8, qs);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float sqrt_d = sqrtf((float)d);
  float m[ROWS], l[ROWS], amax[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    amax[r] = 0.f;
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int slot = i % kStages, t = start + i * kTile + i_slot;
    if (t < end) {
      const int8_t* kr = codes + (slot * kTile + i_slot) * stride;
      int si[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) si[r] = 0;
#pragma unroll
      for (int j = 0; j < kMaxDim / 16; ++j) {
        if (16 * j >= d) break;
        const int4 kw = *reinterpret_cast<const int4*>(kr + 16 * j);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= rows) break;
          const int4 qw =
              *reinterpret_cast<const int4*>(q8 + r * d + 16 * j);
          si[r] = __dp4a(qw.x, kw.x, si[r]);
          si[r] = __dp4a(qw.y, kw.y, si[r]);
          si[r] = __dp4a(qw.z, kw.z, si[r]);
          si[r] = __dp4a(qw.w, kw.w, si[r]);
        }
      }
      const float k_scale = ks_s[slot * kTile + i_slot];
      const float v_scale = vs_s[slot * kTile + i_slot];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) break;
        const float s = (float)si[r] * qs[r] * k_scale / sqrt_d;
        part.scores[(row0 + r) * cap + t] = s;
        if (t <= p0 + r / g) online_add(s, v_scale, m[r], l[r], amax[r]);
      }
    }
    __syncthreads();                   // the slot is free again
    if (i + kStages < n_tiles) stage(i + kStages);
    cp_async_commit();
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
    for (int off = 1; off < 32; off <<= 1)
      online_merge(__shfl_xor_sync(0xffffffffu, m[r], off),
                   __shfl_xor_sync(0xffffffffu, l[r], off),
                   __shfl_xor_sync(0xffffffffu, amax[r], off), m[r], l[r],
                   amax[r]);
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
    for (int w = 0; w < kI8Warps; ++w)
      online_merge(st_m[w * ROWS + r], st_l[w * ROWS + r],
                   st_a[w * ROWS + r], mm, ll, aa);
    const size_t at = part.at(row0 + r, split);
    part.m[at] = mm;
    part.l[at] = ll;
    part.amax[at] = aa;
  }
}

// paged_decode_int8, pass 2: grid (splits, KVH, B), kI8Threads threads;
// the chunk of pass 1. Merges every split's (m, l, amax) of its rows in
// split order (each CTA of a lane and head computes the same), then
// streams the chunk's V codes, vs and stored scores. Per tile, thread i
// forms position i's probability code of each row, then each thread sums
// code * v-code over 4 dims of a group of 4 positions at a time: the 4 x 4
// V bytes transposed (transpose4), one dp4a a row and dim. Writes its
// chunk's int32 sums.
template <int ROWS>
__global__ void I8_BOUNDS(ROWS)
paged_int8_pv_kernel(const int8_t* __restrict__ vpool,
                     const float* __restrict__ vs,
                     const int32_t* __restrict__ tables,
                     const int32_t* __restrict__ pos,
                     float* __restrict__ scratch, int kvh, int d, int bs,
                     int nbl, int span, int g, int chunk) {
  extern __shared__ __align__(16) unsigned char smem8[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rows = span * g, cap = nbl * bs;
  const Int8Partials part(scratch, (size_t)gridDim.z * kvh * rows, splits,
                          cap);
  const size_t row0 = ((size_t)b * kvh + h) * rows;
  const int p0 = pos[b];
  const int last = min(p0 + span - 1, cap - 1);
  const int lane_c = lane_chunk(last + 1, splits, chunk, bs);
  const int start = split * lane_c;
  const int end = min(start + lane_c, last + 1);
  if (start >= end) return;
  const Int8PvSmem lay(ROWS, d, chunk / bs, splits);
  int8_t* codes = reinterpret_cast<int8_t*>(smem8 + lay.codes);
  float* vs_s = reinterpret_cast<float*>(smem8 + lay.vs);
  float* sc_s = reinterpret_cast<float*>(smem8 + lay.scores);
  int* red = reinterpret_cast<int*>(smem8 + lay.red);
  int8_t* pc = reinterpret_cast<int8_t*>(smem8 + lay.pcode);  // [ROWS, kTile]
  float* ml = reinterpret_cast<float*>(smem8 + lay.stats);
  float* m_g = reinterpret_cast<float*>(smem8 + lay.merged);
  float* l_g = m_g + ROWS;
  float* as_g = l_g + ROWS;
  const ChunkRows cr =
      stage_table(reinterpret_cast<int*>(smem8 + lay.tbl),
                  tables + (size_t)b * nbl, start, end, bs, kvh, h);
  __syncthreads();
  const int stride = d + kRowPad;
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int i_slot = threadIdx.x;
  auto stage = [&](int i) {
    const int slot = i % kStages, t = start + i * kTile + i_slot;
    if (t < end) {
      const size_t row = cr.at(t);
      stage_row(codes + (slot * kTile + i_slot) * stride, vpool + row * d, d);
      cp_async4(vs_s + slot * kTile + i_slot, vs + row);
      for (int r = 0; r < rows; ++r)
        cp_async4(sc_s + (slot * ROWS + r) * kTile + i_slot,
                  part.scores + (row0 + r) * cap + t);
    }
  };
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) stage(i);
    cp_async_commit();
  }
  // every split's (m, l, amax) of the CTA's rows, loaded at once, then
  // merged in split order by one thread a row
  const int n_ml = rows * splits;
  for (int i = threadIdx.x; i < n_ml; i += kI8Threads) {
    ml[i] = part.m[row0 * splits + i];
    ml[n_ml + i] = part.l[row0 * splits + i];
    ml[2 * n_ml + i] = part.amax[row0 * splits + i];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    merge_int8_stats(ml + r * splits, ml + n_ml + r * splits,
                     ml + 2 * n_ml + r * splits, splits, m_g[r], l_g[r],
                     as_g[r]);
  }

  // thread: dims [4 dg, 4 dg + 4), position groups kg0, kg0 + kg_step, ...
  const int n_dg = d / 4, dg = threadIdx.x % n_dg;
  const int kg0 = threadIdx.x / n_dg, kg_step = kI8Threads / n_dg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int slot = i % kStages, t = start + i * kTile + i_slot;
    // the tile's probability codes, 0 where a row does not attend
    for (int r = 0; r < rows; ++r) {
      int c = 0;
      if (t < end && t <= p0 + r / g) {
        const float a =
            expf(sc_s[(slot * ROWS + r) * kTile + i_slot] - m_g[r]) / l_g[r];
        c = quant_code(a * vs_s[slot * kTile + i_slot] / as_g[r]);
      }
      pc[r * kTile + i_slot] = (int8_t)c;
    }
    __syncthreads();
    const int8_t* vt = codes + slot * kTile * stride + 4 * dg;
    for (int kg = kg0; kg < kTile / 4; kg += kg_step) {
      uint32_t w[4], vt4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = *reinterpret_cast<const uint32_t*>(vt + (4 * kg + k) * stride);
      transpose4(w, vt4);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) break;
        const int cw = *reinterpret_cast<const int*>(pc + r * kTile + 4 * kg);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(cw, (int)vt4[j], acc[r][j]);
      }
    }
    __syncthreads();                   // the slot is free again
    if (i + kStages < n_tiles) stage(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free: red reuses it
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int a = acc[r][j];
      for (int off = n_dg; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane < n_dg) red[(warp * ROWS + r) * d + 4 * dg + j] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kI8Threads) {
    const int r = i / d, j = i % d;
    int o = 0;
    for (int w = 0; w < kI8Warps; ++w) o += red[(w * ROWS + r) * d + j];
    part.acc[part.at(row0 + r, split) * d + j] = o;
  }
}

// paged_decode_int8, combine: grid (KVH, B), kThreads threads. Merges the
// rows' statistics as pass 2 does (the same as), then one thread a (row,
// d) element adds the splits' int32 sums in split order (a split whose l
// is 0 left none) and writes (float)sum * as in T to out [B, span, H, D].
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_int8_combine_kernel(float* __restrict__ scratch, T* __restrict__ out,
                          int splits, int d, int cap, int span, int g) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = gridDim.x, rows = span * g;
  const Int8Partials part(scratch, (size_t)gridDim.y * kvh * rows, splits,
                          cap);
  const size_t row0 = ((size_t)b * kvh + h) * rows;
  const int n_ml = rows * splits;
  float* ml = smem;                           // [3, rows, splits]
  float* as_s = ml + 3 * n_ml;                // [rows]
  for (int i = threadIdx.x; i < n_ml; i += kThreads) {
    ml[i] = part.m[row0 * splits + i];
    ml[n_ml + i] = part.l[row0 * splits + i];
    ml[2 * n_ml + i] = part.amax[row0 * splits + i];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mm, ll;
    merge_int8_stats(ml + r * splits, ml + n_ml + r * splits,
                     ml + 2 * n_ml + r * splits, splits, mm, ll, as_s[r]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += kThreads) {
    const int r = i / d, j = i % d;
    const int* acc = part.acc + (row0 + r) * splits * d + j;
    const float* l_r = ml + n_ml + r * splits;
    int o = 0;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const int a = acc[(size_t)s * d];
      o += l_r[s] > 0.f ? a : 0;
    }
    out[((size_t)(b * span + r / g) * kvh * g + h * g + r % g) * d + j] =
        from_float<T>((float)o * as_s[r]);
  }
}

// ----------------------------------------------------------------------
// flash_decode, split pass: grid (splits, KVH, B), kThreads threads.
// q: [B, H, D] with H = KVH * G; k / v: [B, tmax, KVH, D]; row b attends
// positions t < len = lengths[b]. With C = lane_chunk(len, ...), the CTA
// of split s covers positions [s * C, min((s + 1) * C, len)) in one
// pass (q pre-scaled by 1/sqrt(D) in fp32, an online softmax) and writes
// each of its G rows' (m, l, unnormalised acc).
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int32_t* __restrict__ lengths,
                          float* __restrict__ scratch, int kvh, int tmax,
                          int d, int g, int chunk, float scale) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [ROWS, d]
  float* red = q_s + ROWS * d;                // [kWarps, ROWS, d]
  float* st_m = red + kWarps * ROWS * d;      // [kWarps, ROWS]
  float* st_l = st_m + kWarps * ROWS;         // [kWarps, ROWS]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int heads = kvh * g;
  const Partials part(scratch, (size_t)gridDim.z * heads, gridDim.x, 0);
  const size_t row0 = (size_t)b * heads + h * g;
  const int len = min(lengths[b], tmax);
  const int lane_c = lane_chunk(len, gridDim.x, chunk, kFlashGranule);
  const int start = split * lane_c;
  const int end = min(start + lane_c, len);
  if (start >= end) {         // the chunk starts at or past the length
    if (threadIdx.x < g) part.empty(row0 + threadIdx.x, split);
    return;
  }
  for (int i = threadIdx.x; i < g * d; i += kThreads)
    q_s[i] = to_float(q[row0 * d + i]) * scale;
  __syncthreads();

  const int tpk = d / V;
  const int kpw = 32 / tpk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part_i = lane % tpk, sub = lane / tpk;
  const size_t head_off = (size_t)h * d + part_i * V;
  const size_t t_stride = (size_t)kvh * d;
  const T* kb = kc + (size_t)b * tmax * t_stride;
  const T* vb = vc + (size_t)b * tmax * t_stride;
  const int key_step = kWarps * kpw;

  float m[ROWS], l[ROWS], acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  }
  for (int tb = start + warp * kpw; tb < end; tb += key_step) {
    const int t = tb + sub;
    const bool live = t < end;
    float kv[V], vv[V];
    if (live) {
      load_vec(kb + t * t_stride + head_off, kv);
      load_vec(vb + t * t_stride + head_off, vv);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) kv[j] = vv[j] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= g) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) dot += q_s[r * d + part_i * V + j] * kv[j];
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
        red[(warp * ROWS + r) * d + part_i * V + j] = acc[r][j];
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
    const size_t at = part.at(row0 + r, split);
    part.acc[at * d + j] = o;
    if (j == 0) {
      part.m[at] = mm;
      part.l[at] = ll;
    }
  }
}

// flash_decode, combine: grid (KVH, B), kThreads threads. Each of the
// CTA's G rows merges its splits' (m, l, acc) in split order into o (in
// T) and lse = m + log(max(l, 1e-30)) (fp32); a row with no valid key
// gets o = 0 and lse ~ -1e30. The splits' (m, l) are loaded at once and
// turned into weights (0 for a split that attended nothing, whose acc is
// never used) before the acc loads, which are issued with no branch
// between them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(float* __restrict__ scratch, T* __restrict__ out,
                            float* __restrict__ lse, int splits, int d,
                            int g) {
  extern __shared__ float smem[];
  float* w = smem;                            // [g, splits]: m, then weights
  float* l_s = w + g * splits;                // [g, splits]
  float* l_sum = l_s + g * splits;            // [g]
  const int h = blockIdx.x, b = blockIdx.y;
  const int heads = gridDim.x * g;
  const Partials part(scratch, (size_t)gridDim.y * heads, splits, 0);
  const size_t row0 = (size_t)b * heads + h * g;
  for (int i = threadIdx.x; i < g * splits; i += kThreads) {
    w[i] = part.m[row0 * splits + i];
    l_s[i] = part.l[row0 * splits + i];
  }
  __syncthreads();
  if (threadIdx.x < g) {
    const int r = threadIdx.x;
    const float* l_r = l_s + r * splits;
    float mm = kNegInf;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, w[r * splits + s]);
    float ll = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float ls = l_r[s];
      const float a = ls > 0.f ? expf(w[r * splits + s] - mm) : 0.f;
      ll += ls * a;
      w[r * splits + s] = a;
    }
    ll = fmaxf(ll, 1e-30f);
    l_sum[r] = ll;
    lse[row0 + r] = mm + logf(ll);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * d; i += kThreads) {
    const int r = i / d, j = i % d;
    const float* acc = part.acc + (row0 + r) * splits * d + j;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float a = acc[(size_t)s * d], ws = w[r * splits + s];
      o += ws != 0.f ? a * ws : 0.f;
    }
    out[(row0 + r) * d + j] = from_float<T>(o / l_sum[r]);
  }
}

template <typename T, int ROWS>
int launch_paged(const void* q, const void* kp, const void* vp,
                 const void* tables, const void* pos, void* out,
                 void* scratch, int b, int kvh, int d, int bs, int nbl,
                 int span, int g, int splits, int chunk,
                 cudaStream_t stream) {
  const dim3 grid(splits, kvh, b);
  const size_t smem1 = sizeof(float) * ((size_t)ROWS * d + 2 * kWarps * ROWS);
  const size_t smem2 = sizeof(float) * ((size_t)kWarps * ROWS * d + 2 * ROWS +
                                        2 * ROWS * splits);
  const T* qt = static_cast<const T*>(q);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  float* sc = static_cast<float*>(scratch);
  paged_scores_kernel<T, ROWS><<<grid, kThreads, smem1, stream>>>(
      qt, static_cast<const T*>(kp), tb, ps, sc, kvh, d, bs, nbl, span, g,
      chunk);
  int status = (int)cudaGetLastError();
  if (status) return status;
  paged_pv_kernel<T, ROWS><<<grid, kThreads, smem2, stream>>>(
      static_cast<const T*>(vp), tb, ps, sc, kvh, d, bs, nbl, span, g, chunk);
  status = (int)cudaGetLastError();
  if (status) return status;
  paged_combine_kernel<T><<<dim3(kvh, b), kThreads,
                            sizeof(float) * span * g * splits, stream>>>(
      sc, static_cast<T*>(out), splits, d, nbl * bs, span, g);
  return (int)cudaGetLastError();
}

// Let `kernel` take `bytes` of dynamic shared memory; a CUDA status.
template <typename K>
int allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int ROWS>
int launch_paged_int8(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* tables,
                      const void* pos, void* out, void* scratch, int b,
                      int kvh, int d, int bs, int nbl, int span, int g,
                      int splits, int chunk, cudaStream_t stream) {
  const dim3 grid(splits, kvh, b);
  const size_t smem1 = Int8ScoresSmem(ROWS, d, chunk / bs).bytes;
  const size_t smem2 = Int8PvSmem(ROWS, d, chunk / bs, splits).bytes;
  int status = allow_smem(paged_int8_scores_kernel<T, ROWS>, smem1);
  if (status) return status;
  status = allow_smem(paged_int8_pv_kernel<ROWS>, smem2);
  if (status) return status;
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  float* sc = static_cast<float*>(scratch);
  paged_int8_scores_kernel<T, ROWS><<<grid, kI8Threads, smem1, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const float*>(ks), static_cast<const float*>(vs), tb, ps,
      sc, kvh, d, bs, nbl, span, g, chunk);
  status = (int)cudaGetLastError();
  if (status) return status;
  paged_int8_pv_kernel<ROWS><<<grid, kI8Threads, smem2, stream>>>(
      static_cast<const int8_t*>(vp), static_cast<const float*>(vs), tb, ps,
      sc, kvh, d, bs, nbl, span, g, chunk);
  status = (int)cudaGetLastError();
  if (status) return status;
  paged_int8_combine_kernel<T><<<dim3(kvh, b), kThreads,
                                 sizeof(float) * span * g * (3 * splits + 1),
                                 stream>>>(
      sc, static_cast<T*>(out), splits, d, nbl * bs, span, g);
  return (int)cudaGetLastError();
}

template <typename T, int ROWS>
int launch_flash(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, void* lse, void* scratch,
                 int b, int kvh, int tmax, int d, int g, int splits,
                 int chunk, cudaStream_t stream) {
  const dim3 grid(splits, kvh, b);
  const size_t smem = sizeof(float) * ((size_t)ROWS * d * (1 + kWarps) +
                                       2 * kWarps * ROWS);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int32_t* lens = static_cast<const int32_t*>(lengths);
  float* sc = static_cast<float*>(scratch);
  const float scale = 1.0f / sqrtf((float)d);
  flash_decode_split_kernel<T, ROWS><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, lens, sc, kvh, tmax, d, g, chunk, scale);
  const int status = (int)cudaGetLastError();
  if (status) return status;
  flash_decode_combine_kernel<T><<<dim3(kvh, b), kThreads,
                                   sizeof(float) * g * (2 * splits + 1),
                                   stream>>>(
      sc, static_cast<T*>(out), static_cast<float*>(lse), splits, d, g);
  return (int)cudaGetLastError();
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

// Call LAUNCH<T, bucket> for the smallest instantiated row count that
// holds ROWS_RUNTIME, storing its CUDA status in STATUS.
#define DISPATCH_ROWS_STATUS(STATUS, LAUNCH, T, ROWS_RUNTIME, ...)  \
  switch (row_bucket(ROWS_RUNTIME)) {                               \
    case 1: STATUS = LAUNCH<T, 1>(__VA_ARGS__); break;              \
    case 2: STATUS = LAUNCH<T, 2>(__VA_ARGS__); break;              \
    case 4: STATUS = LAUNCH<T, 4>(__VA_ARGS__); break;              \
    case 8: STATUS = LAUNCH<T, 8>(__VA_ARGS__); break;              \
    default: STATUS = LAUNCH<T, kMaxRows>(__VA_ARGS__); break;      \
  }

// A split plan the kernels can run: its chunks cover [0, capacity).
bool splits_ok(int splits, int chunk, int capacity) {
  return splits >= 1 && splits <= kMaxSplits && chunk >= 1 &&
         (long long)splits * chunk >= capacity &&
         (long long)(splits - 1) * chunk < capacity;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// scratch: fp32, b * kvh * span * g * (splits * (d + 2) + nbl * bs)
// floats (Partials). Launches pass 1, pass 2 and the combine.
int paged_decode(int dtype, const void* q, const void* kpool,
                 const void* vpool, const void* tables, const void* pos,
                 void* out, void* scratch, int b, int kvh, int d, int bs,
                 int nbl, int span, int g, int splits, int chunk,
                 void* stream) {
  if (!shape_ok(dtype, d) || row_bucket(span * g) == 0 || b < 1 ||
      kvh < 1 || span < 1 || g < 1 || bs < 1 || nbl < 1 ||
      !splits_ok(splits, chunk, nbl * bs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status = 0;
  if (dtype == 0) {
    DISPATCH_ROWS_STATUS(status, launch_paged, float, span * g, q, kpool,
                         vpool, tables, pos, out, scratch, b, kvh, d, bs,
                         nbl, span, g, splits, chunk, s)
  } else {
    DISPATCH_ROWS_STATUS(status, launch_paged, __nv_bfloat16, span * g, q,
                         kpool, vpool, tables, pos, out, scratch, b, kvh, d,
                         bs, nbl, span, g, splits, chunk, s)
  }
  return status;
}

// dtype: 0 = float32, 1 = bfloat16 (q and out); pools int8, scales fp32.
// scratch: fp32, b * kvh * span * g * (splits * (d + 3) + nbl * bs)
// floats (Int8Partials). Launches pass 1, pass 2 and the combine.
int paged_decode_int8(int dtype, const void* q, const void* kpool,
                      const void* vpool, const void* ks, const void* vs,
                      const void* tables, const void* pos, void* out,
                      void* scratch, int b, int kvh, int d, int bs, int nbl,
                      int span, int g, int splits, int chunk, void* stream) {
  if ((d != 32 && d != 64 && d != 128) || row_bucket(span * g) == 0 || b < 1 || kvh < 1 || span < 1 || g < 1 ||
      bs < 1 || nbl < 1 || chunk % bs || !splits_ok(splits, chunk, nbl * bs) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status = 0;
  if (dtype == 0) {
    DISPATCH_ROWS_STATUS(status, launch_paged_int8, float, span * g, q,
                         kpool, vpool, ks, vs, tables, pos, out, scratch, b,
                         kvh, d, bs, nbl, span, g, splits, chunk, s)
  } else {
    DISPATCH_ROWS_STATUS(status, launch_paged_int8, __nv_bfloat16, span * g,
                         q, kpool, vpool, ks, vs, tables, pos, out, scratch,
                         b, kvh, d, bs, nbl, span, g, splits, chunk, s)
  }
  return status;
}

// scratch: fp32, b * kvh * g * splits * (d + 2) floats (Partials).
// Launches the split pass and the combine.
int flash_decode(int dtype, const void* q, const void* k, const void* v,
                 const void* lengths, void* out, void* lse, void* scratch,
                 int b, int kvh, int tmax, int d, int g, int splits,
                 int chunk, void* stream) {
  if (!shape_ok(dtype, d) || row_bucket(g) == 0 || b < 1 || kvh < 1 ||
      tmax < 1 || !splits_ok(splits, chunk, tmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status = 0;
  if (dtype == 0) {
    DISPATCH_ROWS_STATUS(status, launch_flash, float, g, q, k, v, lengths,
                         out, lse, scratch, b, kvh, tmax, d, g, splits,
                         chunk, s)
  } else {
    DISPATCH_ROWS_STATUS(status, launch_flash, __nv_bfloat16, g, q, k, v,
                         lengths, out, lse, scratch, b, kvh, tmax, d, g,
                         splits, chunk, s)
  }
  return status;
}

}  // extern "C"
