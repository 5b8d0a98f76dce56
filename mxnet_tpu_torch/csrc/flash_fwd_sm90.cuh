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

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

template <int D> struct Cfg {
  static constexpr int kBoxes = D / kBox;             // boxes of a tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStages = D == 128 ? 3 : 4;    // K/V ring depth
  // kGroups Q tiles, kStages K tiles, kStages V tiles, after 1 KB of
  // alignment: 129 KB at D = 128, 81 KB at D = 64
  static constexpr int kSmem =
      1024 + kTileBytes * (kGroups + 2 * kStages);
};

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

  // S = Q K^T of tile kt into sc (the first step overwrites sc)
  auto issue_qk = [&](int kt) { product_ss<D>(sc, q_s(g), k_s(kt % S)); };
  // pv = P_hi V + P_lo V of tile kt alone
  auto issue_pv = [&](int kt) {
    product_rs<D>(pv, p_hi, p_lo, v_s(kt % S), 0);
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
    split_bf16(sc, p_hi, p_lo);
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
      split_bf16(sc, p_hi, p_lo);
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
