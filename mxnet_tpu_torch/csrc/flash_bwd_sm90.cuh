// flash_bwd_sm90: the bf16 flash backward (B2a dQ, B2b dK/dV) as two Hopper
// kernels on the CTA shape of flash_fwd_sm90.cuh, included by
// flash_attention.cu.
//
//   flash_bwd_dq_sm90<D>   replaces mxnet_tpu/kernels/flash_attention.py
//                          ::_dq_kernel for bfloat16 q / k / v / dO:
//                          dQ = scale sum_k dS K, P = exp(S scale - lse),
//                          dS = P (dO V^T - delta).
//   flash_bwd_dkv_sm90<D>  replaces flash_attention.py::_dkv_kernel:
//                          dV = sum_q P^T dO, dK = scale sum_q dS^T Q.
//
// Both over [BH, T, D] (D = 64 or 128), with lse and delta fp32 [BH, Tq]
// (delta = rowsum(dO O) comes from the caller, as in the JAX package). They
// stay two kernels, as the JAX package's two pallas_calls: dQ is not folded
// into the dK/dV kernel with fp32 atomics, so the result is deterministic
// and needs no dQ accumulation buffer or conversion pass.
//
// What bounds them on an H100 SXM (700 W peaks, 3.35 TB/s and 989 TFLOP/s
// bf16): at the training shape (BH 64, T 1024, D 128, causal) dQ needs 3
// products over the causal half (26 us at peak) and dK/dV 4 (35 us); their
// bytes (5 and 6 [BH, T, D] bf16 tensors, 42-50 MB: 13-15 us) are less.
// So the products run on the tensor cores, and every operand a CTA reads
// twice sits in shared memory: the CUDA-core kernels of flash_attention.cu
// dot in fp32 from rows staged synchronously in shared memory and sit 40-50x
// above that bound.
//
// Design (one CTA = two consumer warpgroups of 64 rows each + one producer
// warpgroup; 384 threads, one CTA per SM; setmaxnreg 24 / 240 as the
// forward):
//   - dQ: a CTA owns 128 query rows. The producer loads each group's Q and
//     dO tiles once and streams the K / V tiles through a ring of kStages
//     stages with TMA (3-D maps: rows past T read zero). Per key tile,
//     S = Q K^T and dP = dO V^T run on wgmma with both operands in shared
//     memory (K-major B); P = exp2(S scale log2e - lse log2e) and
//     dS = P (dP - delta) are formed on the accumulator fragments, which
//     are wgmma's A-register layout, and dQ += dS_hi K + dS_lo K takes K
//     as the MN-major B operand from the same swizzled stage, exactly as
//     the forward takes V. dQ is scaled by 1/sqrt(D) in fp32 once.
//   - dK/dV: a CTA owns 128 key rows. The producer loads each group's K
//     and V tiles once and streams Q / dO tiles, and the lse (times log2e)
//     and delta of their 64 rows, through the ring; the 32 lanes of the
//     producer's first warp stage those row statistics into the stage
//     with plain stores (zero past Tq, never read past it) and arrive on
//     its full barrier beside the TMA bytes. Everything is computed in the
//     transposed frame, so it stays in registers: S^T = K Q^T and
//     dP^T = V dO^T (shared-shared), then P^T and dS^T come out of the
//     accumulator already in the A-register layout, and dV += P^T_hi dO +
//     P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q take dO and Q as MN-major B
//     from the stage that fed the K-major products. lse and delta are per
//     column here. dK is scaled by 1/sqrt(D) at the end (the JAX kernel
//     pre-scales q; only the order of the fp32 sums differs).
//   - Rounding: bf16 products are exact in fp32; P and dS are each split
//     into two bf16 parts, X_hi = bf16(x) and X_lo = bf16(x - X_hi), both
//     multiplied by the same tile. In the CPU model of
//     tests/test_torch_flash_tc_rounding.py a single bf16 P and dS moves
//     dq, dk and dv by about 2-5x the bf16 gate (1e-3 + 2^-7 |x|) against
//     the plain version, and the split holds them under 0.8 of it; on the
//     card the split reads at most 0.88 of it. dQ, dK and dV are summed
//     across tiles inside the wgmma accumulators (the forward adds each
//     tile's PV to o in fp32 instead, which its carry's fp32 gate needs):
//     chip_smoke.py's long backward check (T = 8192, causal: a row sums
//     128 tiles) holds dq, dk and dv at 0.69, 0.87 and 0.85 of the bf16
//     gate on an H100, and a per-tile sum would need 64-128 more registers
//     a thread, past what a dK/dV consumer has.
//   - Masking, as the forward: rows past T are zero-filled by TMA and give
//     p = 0 (keys past Tk in dQ, query columns past Tq in dK/dV), never
//     exp(0 - lse), which may overflow; causal masked scores inside a live
//     tile give p = 0 (the reference's finite -1e30 has p = 0); tiles
//     wholly past the diagonal are skipped, in dQ the key tiles past it,
//     in dK/dV the query tiles before it, and the heaviest CTAs go first.
//   - Registers: a dK/dV consumer thread holds dK and dV (2 x D / 2 fp32),
//     S^T and dP^T (64), and the split parts of P and dS (64). The dV
//     products are issued as soon as P is split, and dS is split while
//     they run; dS overwrites dP in place. ptxas -v (CUDA 12.8) reports
//     168 registers at entry for all four instantiations (dQ and dK/dV at
//     D 64 and 128; setmaxnreg then gives 24 / 240), 0 bytes spilled, and
//     no wgmma serialisation warning.
// Each consumer warpgroup waits for its own products, and the two run
// independently, so one's elementwise work overlaps the other's products.
// (Every product is issued on a straight path: a branch around a wgmma
// makes the compiler serialise them.)

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

template <int D> struct BwdCfg {
  static constexpr int kBoxes = D / kBox;             // boxes of a tile
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStages = D == 128 ? 3 : 4;    // ring depth
  static constexpr int kStatBytes = 2 * kRows * 4;    // lse, delta of a tile
  // 2 kGroups fixed tiles, two streamed tiles a stage, the dK/dV kernel's
  // row statistics a stage, after 1 KB of alignment: 163 KB at D = 128,
  // 99 KB at D = 64
  static constexpr int kSmem = 1024 + kTileBytes * (2 * kGroups + 2 * kStages)
                               + kStages * kStatBytes;
};

struct BwdArgs {
  const float* lse;          // [BH, Tq]
  const float* delta;        // [BH, Tq]
  __nv_bfloat16* dq;         // [BH, Tq, D]
  __nv_bfloat16* dk;         // [BH, Tk, D]
  __nv_bfloat16* dv;
  int tq, tk, causal;
  float scale;
};

// Key tiles the 64 query rows from q0 visit: all unless causal, else
// those up to the diagonal (query i attends key j iff i >= j).
__device__ __forceinline__ int key_tiles(const BwdArgs& a, int q0) {
  const int n = (a.tk + kRows - 1) / kRows;
  return a.causal ? min(n, q0 / kRows + 1) : n;
}

// Fragment layout of a wgmma accumulator (m64nN, fp32): thread t of a
// warpgroup holds, for each 8-column chunk j, the elements at row
// 16 (t / 32) + (t % 32) / 4 + 8 h and columns 8 j + 2 (t % 4) + e as
// register 4 j + 2 h + e (h, e in {0, 1}).

// ------------------------------------------------------------------ dQ ---
// grid (BH, ceil(Tq / 128)); the heaviest (last) query tiles go first.
// Warpgroup g owns query rows q0 + 64 g .. + 63; both read the same K / V
// stages, so the ring holds the tiles of the later warpgroup, and the
// other one releases the tiles past its own diagonal without reading them.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap,
                  const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int S = C::kStages;
  constexpr int NO = D / 2;               // dq registers of a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t fixed_bar = smem_u32(&bars[0]);
  auto q_s = [&](int g) { return base + g * C::kTileBytes; };
  auto do_s = [&](int g) { return base + (kGroups + g) * C::kTileBytes; };
  auto k_s = [&](int s) { return base + (2 * kGroups + s) * C::kTileBytes; };
  auto v_s = [&](int s) {
    return base + (2 * kGroups + S + s) * C::kTileBytes;
  };
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + S + s]); };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kCtaRows;
  const int n_kt = key_tiles(a, q0 + kCtaRows - kRows);  // the last group's

  if (threadIdx.x == 0) {
    mbar_init(fixed_bar, 1);
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
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(fixed_bar, 2 * kGroups * C::kTileBytes);
      for (int g = 0; g < kGroups; ++g)
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load(q_s(g) + b * kBoxBytes, &qmap, fixed_bar, b * kBox,
                   q0 + g * kRows, bh);
          tma_load(do_s(g) + b * kBoxBytes, &domap, fixed_bar, b * kBox,
                   q0 + g * kRows, bh);
        }
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
  const int my_kt = key_tiles(a, qg);
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;    // tile row of h = 0 (h = 1: +8)
  const int c0 = 2 * (lane % 4);          // column of e = 0 in a chunk
  const float sl = a.scale * kLog2e;
  float lse2[2], dlt[2];                  // lse log2e and delta of the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qg + r0 + 8 * h;
    const size_t r = (size_t)bh * a.tq + row;
    lse2[h] = row < a.tq ? a.lse[r] * kLog2e : 0.f;
    dlt[h] = row < a.tq ? a.delta[r] : 0.f;
  }
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  float sc[32], dp[32];                   // S then P; dP then dS
  uint32_t ds_hi[16], ds_lo[16];

  mbar_wait(fixed_bar, 0);
  for (int kt = 0; kt < my_kt; ++kt) {
    const int s = kt % S;
    mbar_wait(full(s), (kt / S) & 1);
    wgmma_fence();
    product_ss<D>(sc, q_s(g), k_s(s));
    product_ss<D>(dp, do_s(g), v_s(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int k0 = kt * kRows;
    const bool edge = k0 + kRows > a.tk ||
                      (a.causal && qg < k0 + kRows - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      float p = exp2f(fmaf(sc[i], sl, -lse2[h]));
      if (edge) {
        const int kc = k0 + 8 * (i / 4) + c0 + (i % 2);
        if (kc >= a.tk || (a.causal && qg + r0 + 8 * h < kc)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dlt[h]);
    }
    split_bf16(dp, ds_hi, ds_lo);
    wgmma_fence();
    product_rs<D>(dq, ds_hi, ds_lo, k_s(s), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(empty(s));
  }
  // the tiles past this group's diagonal: released unread
  for (int kt = my_kt; kt < n_kt; ++kt) {
    mbar_wait(full(kt % S), (kt / S) & 1);
    mbar_arrive(empty(kt % S));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qg + r0 + 8 * h;
    if (row >= a.tq) continue;
    __nv_bfloat16* out = a.dq + ((size_t)bh * a.tq + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c0) =
          __floats2bfloat162_rn(a.scale * dq[4 * j + 2 * h],
                                a.scale * dq[4 * j + 2 * h + 1]);
  }
}

// --------------------------------------------------------------- dK/dV ---
// grid (BH, ceil(Tk / 128)); the heaviest (first) key tiles go first.
// Warpgroup g owns key rows k0 + 64 g .. + 63; both read the same Q / dO
// stages, which start at the first query tile the earlier warpgroup needs,
// and under a causal mask the later one releases that tile unread.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int S = C::kStages;
  constexpr int NO = D / 2;               // dk and dv registers of a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * S];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t fixed_bar = smem_u32(&bars[0]);
  auto k_s = [&](int g) { return base + g * C::kTileBytes; };
  auto v_s = [&](int g) { return base + (kGroups + g) * C::kTileBytes; };
  auto q_s = [&](int s) { return base + (2 * kGroups + s) * C::kTileBytes; };
  auto do_s = [&](int s) {
    return base + (2 * kGroups + S + s) * C::kTileBytes;
  };
  // a stage's lse log2e [64] then delta [64]
  auto stat = [&](int s) {
    return reinterpret_cast<float*>(
        gbase + (2 * kGroups + 2 * S) * C::kTileBytes + s * C::kStatBytes);
  };
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + S + s]); };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kCtaRows;
  const int n_qt = (a.tq + kRows - 1) / kRows;
  // the first query tile that reaches this CTA's first key
  const int qt0 = a.causal ? min(k0 / kRows, n_qt) : 0;
  const int n_it = n_qt - qt0;            // query tiles streamed

  if (threadIdx.x == 0) {
    mbar_init(fixed_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1 + 32);         // the TMA bytes and 32 lanes
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------- producer warpgroup ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < kConsumers + 32 && n_it > 0) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(fixed_bar, 2 * kGroups * C::kTileBytes);
        for (int g = 0; g < kGroups; ++g)
          for (int b = 0; b < C::kBoxes; ++b) {
            tma_load(k_s(g) + b * kBoxBytes, &kmap, fixed_bar, b * kBox,
                     k0 + g * kRows, bh);
            tma_load(v_s(g) + b * kBoxBytes, &vmap, fixed_bar, b * kBox,
                     k0 + g * kRows, bh);
          }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % S, q0 = (qt0 + it) * kRows;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * C::kTileBytes);
          for (int b = 0; b < C::kBoxes; ++b) {
            tma_load(q_s(s) + b * kBoxBytes, &qmap, full(s), b * kBox, q0,
                     bh);
            tma_load(do_s(s) + b * kBoxBytes, &domap, full(s), b * kBox, q0,
                     bh);
          }
        }
        float* st = stat(s);
        for (int i = lane; i < kRows; i += 32) {
          const int row = q0 + i;
          const size_t r = (size_t)bh * a.tq + row;
          st[i] = row < a.tq ? a.lse[r] * kLog2e : 0.f;
          st[kRows + i] = row < a.tq ? a.delta[r] : 0.f;
        }
        mbar_arrive(full(s));             // releases the stores above
      }
    }
    return;
  }

  // ----------------------------------------------- consumer warpgroups ---
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = threadIdx.x / 128;
  const int kg = k0 + g * kRows;          // this warpgroup's first key
  // under a causal mask the later group's keys start past the first tile
  const int skip = a.causal ? min(g, n_it) : 0;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4;    // tile row of h = 0 (h = 1: +8)
  const int c0 = 2 * (lane % 4);          // column of e = 0 in a chunk
  const float sl = a.scale * kLog2e;
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
  float sc[32], dp[32];                   // S^T then P^T; dP^T then dS^T
  uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];

  if (n_it > 0) mbar_wait(fixed_bar, 0);
  for (int it = 0; it < skip; ++it) {
    mbar_wait(full(it % S), (it / S) & 1);
    mbar_arrive(empty(it % S));
  }
  for (int it = skip; it < n_it; ++it) {
    const int s = it % S, q0 = (qt0 + it) * kRows;
    mbar_wait(full(s), (it / S) & 1);
    wgmma_fence();
    product_ss<D>(sc, k_s(g), q_s(s));
    product_ss<D>(dp, v_s(g), do_s(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const float* st = stat(s);
    const bool edge = q0 + kRows > a.tq ||
                      (a.causal && q0 < kg + kRows - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + c0);
      const float2 dl =
          *reinterpret_cast<const float2*>(st + kRows + 8 * j + c0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2f(fmaf(sc[i], sl, -(e ? l2.y : l2.x)));
          if (edge) {
            const int qc = q0 + 8 * j + c0 + e;
            if (qc >= a.tq || (a.causal && qc < kg + r0 + 8 * h)) p = 0.f;
          }
          sc[i] = p;
          dp[i] = p * (dp[i] - (e ? dl.y : dl.x));
        }
    }
    split_bf16(sc, p_hi, p_lo);
    wgmma_fence();
    product_rs<D>(dv, p_hi, p_lo, do_s(s), 1);
    wgmma_commit();
    split_bf16(dp, ds_hi, ds_lo);         // while the dV products run
    wgmma_fence();
    product_rs<D>(dk, ds_hi, ds_lo, q_s(s), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kg + r0 + 8 * h;
    if (row >= a.tk) continue;
    const size_t r = ((size_t)bh * a.tk + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + r + 8 * j + c0) =
          __floats2bfloat162_rn(a.scale * dk[4 * j + 2 * h],
                                a.scale * dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + r + 8 * j + c0) =
          __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// --------------------------------------------------------------- host ---
// Launch the dQ kernel (dq = true) or the dK/dV kernel over bf16 q, dO
// [bh, Tq, D] and k, v [bh, Tk, D].
template <int D>
int launch_bwd(bool dq, const void* q, const void* k, const void* v,
               const void* dout, const BwdArgs& a, int bh,
               cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!make_map(&qm, q, bh, a.tq, D) || !make_map(&km, k, bh, a.tk, D) ||
      !make_map(&vm, v, bh, a.tk, D) || !make_map(&dom, dout, bh, a.tq, D))
    return (int)cudaErrorInvalidValue;
  auto kernel = dq ? flash_bwd_dq_sm90<D> : flash_bwd_dkv_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BwdCfg<D>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int rows = dq ? a.tq : a.tk;
  kernel<<<dim3(bh, (rows + kCtaRows - 1) / kCtaRows), kThreads,
           BwdCfg<D>::kSmem, stream>>>(qm, km, vm, dom, a);
  return (int)cudaGetLastError();
}

}  // namespace sm90
