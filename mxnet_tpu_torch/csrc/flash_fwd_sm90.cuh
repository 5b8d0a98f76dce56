// flash_fwd_sm90: the bf16 flash forward (B1) and ring-carry step (B5) as
// one Hopper kernel template, included by flash_attention.cu.
//
//   flash_fwd_sm90<D, false>  replaces mxnet_tpu/kernels/flash_attention.py
//                             ::_fwd_kernel for bfloat16 q / k / v: writes o
//                             (bf16) and the fp32 lse = m + log(max(l, 1e-30)).
//   flash_fwd_sm90<D, true>   replaces flash_attention.py::_carry_kernel for
//                             bfloat16 q / k / v: starts from the fp32 carry
//                             (o, m, l) and writes it back unnormalised.
//
// Both are one tile loop over [BH, T, D] (D = 64 or 128): kCarry only
// changes where (o, m, l) come from and what the epilogue writes.
//
// What bounds it on an H100 SXM (700 W peaks, 3.35 TB/s and 989 TFLOP/s
// bf16): at the training shape (BH 64, T 1024, D 128, causal) the bytes
// (q, k, v and o once, 67 MB: 20 us) and the forward's products (17 GFLOP:
// 17 us) are both near 20 us, so the kernel must run its products on the
// tensor cores and keep its loads off the critical path. The fp32 kernels
// of flash_attention.cu dot on CUDA cores from fp32 rows staged
// synchronously in shared memory, and sit 50x above that bound.
//
// Design (one CTA = two consumer warpgroups of 64 query rows each + one
// producer warpgroup; 384 threads, one CTA per SM):
//   - one thread of the producer warpgroup loads the two Q tiles once
//     and the K / V tiles into a ring of kStages shared-memory stages
//     with TMA (cp.async.bulk.tensor over 3-D [BH, T, D] maps: rows past
//     T are zero-filled, never read from the next head), signalling
//     full / empty mbarriers; both consumer warpgroups read every stage;
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//     (128-byte swizzle; a D = 128 row is two 64-column boxes), bf16 in,
//     fp32 out; S is multiplied by 1/sqrt(D) in fp32 after the product
//     (bf16 products are exact in fp32, so only the summation order
//     differs from the plain version, which pre-scales q in fp32);
//   - the online softmax runs on the accumulator fragments in registers
//     (row reductions over the 4 lanes of a quad); l sums the fp32 p;
//   - P never leaves the registers: the S accumulator layout is wgmma's
//     A-register layout, and V is the MN-major B operand. Each tile's PV
//     starts from zero and is added to o in fp32 (see the loop). P is
//     split into two bf16 parts, P_hi = bf16(p) and P_lo =
//     bf16(p - P_hi), and both are multiplied by the same V tile: a
//     single bf16 P moves o by up to 2^-9 of each p, which the bf16 gate
//     (2^-7 of a value) and the carry's fp32 gate (1e-4) would not hold;
//     the split leaves ~2^-17. The cost is 1.5x the forward's products,
//     still far under the bytes;
//   - masking as the fp32 kernels: keys past Tk get -inf (p = 0), causal
//     masked scores the finite -1e30, key tiles wholly past the diagonal
//     are skipped (the reach taken at 64-bit global offsets), and a carry
//     step with no live tile writes its carry back bitwise.
// Each consumer warpgroup pipelines its own tiles (tile kt + 1's softmax
// runs while the tensor cores compute tile kt's P V), and the two run
// independently, so one's softmax also overlaps the other's products.
// The producer warpgroup hands its
// registers to them (setmaxnreg: 24 and 240 a thread), room for o, the
// tile's pv and both parts of P without spilling. (A lone producer warp
// cannot do that: each SM sub-partition keeps its own registers, and the
// freed ones would sit in one of the four.)

namespace sm90 {

constexpr int kRows = 64;                 // rows of a group's and a K/V tile
constexpr int kGroups = 2;                // consumer warpgroups of a CTA
constexpr int kCtaRows = kGroups * kRows; // query rows of a CTA
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 128; // and the producer warpgroup
// registers a thread of each role keeps (setmaxnreg): 3 warpgroups start
// at 168 each (16384 per SM sub-partition over its 3 warps); the
// producer gives back all but 24, which lets each consumer hold 240
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64;                  // bf16 columns of a TMA box (128 B)
constexpr int kBoxBytes = kRows * kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;         // finite mask value, as the reference

template <int D> struct Cfg {
  static constexpr int kBoxes = D / kBox;             // boxes of a tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStages = D == 128 ? 3 : 4;    // K/V ring depth
  // kGroups Q tiles, kStages K tiles, kStages V tiles, after 1 KB of
  // alignment: 129 KB at D = 128, 81 KB at D = 64
  static constexpr int kSmem =
      1024 + kTileBytes * (kGroups + 2 * kStages);
};

// ---------------------------------------------------------------- PTX ---
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 3-D map to shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(row), "r"(head) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (start
// address, leading and stride byte offsets; layout type 1 = SWIZZLE_128B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------------------------- wgmma ---
// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers (the
// accumulator layout of a score tile), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A in registers (the
// accumulator layout of a score tile), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db, int acc) {
  if constexpr (D == 128) wgmma_rs_n128(o, a, db, acc);
  else wgmma_rs_n64(o, a, db, acc);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

struct FwdArgs {
  __nv_bfloat16* o;          // !kCarry: o [BH, Tq, D] and lse [BH, Tq]
  float* lse;
  const float* o_in;         // kCarry: the fp32 carry in and out
  const float* m_in;
  const float* l_in;
  float* o_out;
  float* m_out;
  float* l_out;
  int tq, tk, q_offset, kv_offset, causal;
  float scale;
};

// ------------------------------------------------------------- kernel ---
// Key tiles a 64-row query tile starting at q0 must visit: all of them
// unless causal; else those up to the diagonal at global positions (the
// last query position of the tile less the first key's, in 64 bits).
__device__ __forceinline__ int live_tiles(const FwdArgs& a, int q0) {
  const int n = (a.tk + kRows - 1) / kRows;
  if (!a.causal) return n;
  const long long reach = (long long)a.q_offset + q0 + kRows - 1 - a.kv_offset;
  return reach < 0 ? 0 : (int)min((long long)n, reach / kRows + 1);
}

// grid (BH, ceil(Tq / 128)); the heaviest (last) query tiles go first.
// Warpgroup g of a CTA owns query rows q0 + 64 g .. q0 + 64 g + 63; both
// read the same K / V stages, so the ring holds the tiles of the later
// (longer) warpgroup, and the other one releases the tiles past its own
// diagonal without reading them.
// Fragment layout of a wgmma accumulator (m64nN, fp32): thread t of a
// warpgroup holds, for each 8-column chunk j, the elements at row
// 16 (t / 32) + (t % 32) / 4 + 8 h and columns 8 j + 2 (t % 4) + e as
// register 4 j + 2 h + e (h, e in {0, 1}).
template <int D, bool kCarry>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const FwdArgs a) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  constexpr int NO = D / 2;               // o registers of a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];

  // swizzled tiles want 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto q_s = [&](int g) { return base + g * C::kTileBytes; };
  auto k_s = [&](int s) { return base + (kGroups + s) * C::kTileBytes; };
  auto v_s = [&](int s) {
    return base + (kGroups + S + s) * C::kTileBytes;
  };
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + S + s]); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kCtaRows;
  const int n_kt = live_tiles(a, q0 + kCtaRows - kRows);  // the last group's

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------- producer warpgroup ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers && n_kt > 0) {
      mbar_expect_tx(q_bar, kGroups * C::kTileBytes);
      for (int g = 0; g < kGroups; ++g)
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load(q_s(g) + b * kBoxBytes, &qmap, q_bar, b * kBox,
                   q0 + g * kRows, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        mbar_wait(empty(s), ((kt / S) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::kTileBytes);
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load(k_s(s) + b * kBoxBytes, &kmap, full(s), b * kBox,
                   kt * kRows, bh);
          tma_load(v_s(s) + b * kBoxBytes, &vmap, full(s), b * kBox,
                   kt * kRows, bh);
        }
      }
    }
    return;
  }

  // ----------------------------------------------- consumer warpgroups ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = threadIdx.x / 128;
  const int qg = q0 + g * kRows;          // this warpgroup's first row
  const int my_kt = live_tiles(a, qg);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;    // tile row of h = 0 (h = 1: +8)
  const int c0 = 2 * (lane % 4);          // column of e = 0 in a chunk
  float o[NO], m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qg + r0 + 8 * h;
    const bool in = kCarry && row < a.tq;
    const size_t r = (size_t)bh * a.tq + row;
    m[h] = in ? a.m_in[r] : kMasked;
    l[h] = in ? a.l_in[r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = in ? *reinterpret_cast<const float2*>(
                                a.o_in + r * D + 8 * j + c0)
                          : make_float2(0.f, 0.f);
      o[4 * j + 2 * h] = v.x;
      o[4 * j + 2 * h + 1] = v.y;
    }
  }

  if (n_kt > 0) mbar_wait(q_bar, 0);
  // key column kc of this shard is causally masked from tile row r iff
  // q_offset + qg + r < kv_offset + kc, i.e. qg + r + shift < kc
  const long long shift = (long long)a.q_offset - a.kv_offset;
  float sc[32];                           // S of a tile, then its fp32 p
  uint32_t p_hi[16], p_lo[16];            // P as wgmma A fragments
  float pv[NO];                           // one tile's P V
  float alpha[2], alpha_next[2];

  // S = Q K^T of tile kt into sc: D / 16 steps of k16; a step advances 32
  // bytes inside a 128-byte swizzled row, and the fifth starts the second
  // box. The first step overwrites sc.
  auto issue_qk = [&](int kt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_sw128(q_s(g) + off, 16, 1024),
                   desc_sw128(k_s(kt % S) + off, 16, 1024), kk > 0);
    }
  };
  // pv = P_hi V + P_lo V of tile kt alone (a k16 step is 16 rows of V,
  // 2048 bytes; the next 64 columns of V lie one box, 8 KB, further).
  auto issue_pv = [&](int kt) {
    const uint32_t vs = v_s(kt % S);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(pv, p_hi + 4 * kk,
                  desc_sw128(vs + kk * 2048, kBoxBytes, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(pv, p_lo + 4 * kk,
                  desc_sw128(vs + kk * 2048, kBoxBytes, 1024), 1);
  };
  // scale, mask and the online softmax of tile kt on the fragments: sc
  // becomes the fp32 p, (m, l) move on, and `al` gets the factor that
  // the o of the earlier tiles takes.
  auto softmax = [&](int kt, float (&al)[2]) {
    const int k0 = kt * kRows;
    const bool edge = k0 + kRows > a.tk ||
                      (a.causal && qg + shift < (long long)k0 + kRows - 1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      float x = sc[i] * a.scale;
      if (edge) {
        const int kc = k0 + 8 * (i / 4) + c0 + (i % 2);
        if (kc >= a.tk) x = -INFINITY;                 // past the keys: p = 0
        else if (a.causal && qg + r0 + 8 * h + shift < kc) x = kMasked;
      }
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      al[h] = exp2f((m[h] - m_new) * kLog2e);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = exp2f((sc[i] - m[h]) * kLog2e);
      ps[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] = al[h] * l[h] + ps[h];
    }
  };
  // P split in two bf16 parts: k16 step kk takes p registers 8 kk ..
  // 8 kk + 7 as four bf16 pairs.
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i] = bf16x2_bits(hi);
      p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * i] - hf.x,
                                                  sc[2 * i + 1] - hf.y));
    }
  };

  // Software pipeline over this group's live tiles: while the tensor
  // cores run tile kt's P V, the warpgroup runs tile kt + 1's softmax
  // (its Q K^T issued just before). The tensor cores truncate their fp32
  // sums, so a sum carried through every tile of a long row would drift
  // (by ~1e-3 of o over 8192 keys): each tile's P V starts from zero and
  // is added to o by an fp32 FMA.
  // (Every product is issued on a straight path: a branch around a
  // wgmma makes the compiler serialise them.)
  auto finish_pv = [&](int kt) {
    wgmma_wait<0>();                      // tile kt's P V is in
    fence_regs(pv);
    fence_regs(p_hi);
    fence_regs(p_lo);
    mbar_arrive(empty(kt % S));
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = fmaf(alpha[(i / 2) % 2], o[i], pv[i]);
  };
  if (my_kt > 0) {
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, alpha);
    pack();
    for (int kt = 0; kt + 1 < my_kt; ++kt) {
      mbar_wait(full((kt + 1) % S), ((kt + 1) / S) & 1);
      wgmma_fence();
      issue_qk(kt + 1);
      wgmma_commit();
      issue_pv(kt);
      wgmma_commit();
      wgmma_wait<1>();                    // tile kt + 1's S is in
      fence_regs(sc);
      softmax(kt + 1, alpha_next);
      finish_pv(kt);
      pack();
      alpha[0] = alpha_next[0];
      alpha[1] = alpha_next[1];
    }
    wgmma_fence();
    issue_pv(my_kt - 1);
    wgmma_commit();
    finish_pv(my_kt - 1);
  }
  // the tiles past this group's diagonal: released unread
  for (int kt = my_kt; kt < n_kt; ++kt) {
    mbar_wait(full(kt % S), (kt / S) & 1);
    mbar_arrive(empty(kt % S));
  }

  // ------------------------------------------------------- epilogue ---
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qg + r0 + 8 * h;
    if (row >= a.tq) continue;
    const size_t r = (size_t)bh * a.tq + row;
    if constexpr (kCarry) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(a.o_out + r * D + 8 * j + c0) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (lane % 4 == 0) {
        a.m_out[r] = m[h];
        a.l_out[r] = l[h];
      }
    } else {
      const float ll = fmaxf(l[h], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(a.o + r * D + 8 * j + c0) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / ll,
                                  o[4 * j + 2 * h + 1] / ll);
      if (lane % 4 == 0) a.lse[r] = m[h] + logf(ll);
    }
  }
}

// --------------------------------------------------------------- host ---
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 [bh, t, d] tensor with 64-row x
// 64-column boxes of one head, 128-byte swizzled; rows past t read zero.
inline bool make_map(CUtensorMap* map, const void* ptr, int bh, int t, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {kBox, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kCarry>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a,
           int bh, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, bh, a.tq, D) || !make_map(&km, k, bh, a.tk, D) ||
      !make_map(&vm, v, bh, a.tk, D))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_sm90<D, kCarry>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(bh, (a.tq + kCtaRows - 1) / kCtaRows), kThreads,
           Cfg<D>::kSmem, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

}  // namespace sm90
