#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU and
``nvcc`` (CUDA_HOME or /usr/local/cuda). In order, it

1. fails unless ``torch.cuda.is_available()``, and prints the card's name
   and power limit as ``nvidia-smi`` reports them;
2. builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the serving shapes: the paged decode kernel
   on 32 lanes of 8 KV heads x 64 dims, a pool of 2049 16-position
   blocks, 256-entry tables, live lengths in [1, 4096], spans 1 and 4,
   groups 1 and 2; the flash-decode kernel on 8 lanes x 8 heads against
   a 4096-position cache with lengths including 0 and 4096; each at the
   tolerance stated by ``TOL``;
4. serves 16 requests (prompts of 64-512 seeded tokens, 32 new tokens
   each) through ``ContinuousBatcher(paged=True)`` at the full width of
   the repo's paged serving model (vocab 32000, d_model 512, 8 heads,
   8 layers, d_ff 2048, max_len 4096, bfloat16, random weights from a
   seed), checks every stream's length, the block allocator's
   invariants, that every decode step launched the paged kernel once
   per layer, and that each emitted token's logit lies within a stated
   tolerance of its row's maximum when the stream is teacher-forced
   through ``prefill_chunk`` (a dense contraction, no kernel);
5. runs greedy ``generate()`` (batch 8, prompt 256, 32 new tokens) at
   the same width with the flash-decode kernel, with the same checks;
6. times each decode step, and each kernel beside its plain version, a
   one-call PyTorch yardstick (``scaled_dot_product_attention``, timed
   here only) and its bound (live K/V bytes over 3.35 TB/s); the paged
   kernel is timed on the served pool full, each block in one lane's
   table;
7. traces 16 decode steps of a serve run and of ``generate()`` with
   ``torch.profiler`` and prints, for each, the host ms per step, the
   device ms per step (the sum of the kernels' own times), the device's
   idle share and the kernels that took the most time;
8. times both kernels and the yardstick with every lane at one length,
   over 8, 32 and 128 lanes and lengths 256 and 4096, to show what
   limits the kernels;
9. prints the kernels' JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits nonzero and prints no
result line. It imports nothing of JAX or of the JAX package.
"""

import json
import subprocess
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and fp32
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain| for
# every output element, as (atol, rtol). float32: both sum the same fp32
# products in another order, which moves an output by ~1e-6 at these
# lengths. bfloat16: each rounds its fp32 result to bf16 once; where the
# two fp32 sums differ in their last bits the roundings may land one
# bf16 ulp apart, and one ulp is at most 2^-7 of the value (rtol). atol
# covers the rare flip of one probability rounded to bf16 before PV,
# which moves an output by at most 2^-7 p|v|: below 1e-3 wherever a
# probability of a lane of more than a few dozen keys flips. Typical
# outputs are ~0.03 at these lengths, where the bound is 1.2e-3.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-3, 2.0 ** -7)}
# lse is float32 in both and ~8 here, where one fp32 ulp is 9.5e-7
TOL_LSE = 1e-4
# teacher-forced check: an emitted token's logit may sit this far below
# its row's maximum. Logits have std ~0.45 here; the batched dense prefill
# and the stepped decode round bf16 activations at other places over 8
# layers, which moves a logit by a few bf16 ulps (2^-7 near 1).
TOL_TEACHER = 0.1

SERVE_CFG = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8,
                 d_ff=2048, max_len=4096, use_flash_kernel=True)
SERVE = dict(max_batch=32, block_size=16, num_blocks=2049, requests=16,
             prompt_lo=64, prompt_hi=512, n_new=32)
GENERATE = dict(batch=8, prompt=256, n_new=32)

SOURCE = "mxnet_tpu_torch/csrc/decode_attention.cu"
REPLACES = {"paged_decode": "mxnet_tpu/kernels/paged_decode.py:69",
            "flash_decode": "mxnet_tpu/kernels/flash_attention.py:439"}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def time_ms(fn, iters):
    """Mean ms per call on the card: CUDA events around ``iters`` calls
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype_name):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def compare(got, want, dtype_name, what):
    """Hold a kernel's output against its plain version at TOL; returns
    the max abs error. The log line gives the worst element's error as a
    share of what it is allowed."""
    atol, rtol = TOL[dtype_name]
    want = want.float()
    err = (got.float() - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    log("%s: max abs err %.3g, worst err / (%g + %g |plain|) = %.3f "
        "(max |plain| %.3g)" % (what, float(err.max()), atol, rtol, share,
                                float(want.abs().max())))
    if not share <= 1.0:
        raise AssertionError("%s disagrees with its plain version" % what)
    return float(err.max())


# ---------------------------------------------------------------- B3 ---

def randn(torch, shape, gen, device, dtype):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def paged_tensors(torch, device, dtype, tables, pos, span, g, seed,
                  kvh=8, d=64, bs=16, nb=SERVE["num_blocks"]):
    """Pool, q, tables and pos of one paged-kernel case on the card; the
    pool and q are drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = {n: randn(torch, (nb, bs, kvh, d), gen, device, dtype)
            for n in ("k", "v")}
    q = randn(torch, (len(pos), span, kvh * g, d), gen, device, dtype)
    return (q, pool, torch.from_numpy(tables.astype(np.int32)).to(device),
            torch.from_numpy(pos.astype(np.int32)).to(device))


def paged_case(torch, device, dtype, span, g, seed, lanes=32, bs=16,
               nbl=256, nb=SERVE["num_blocks"]):
    """One check case at the served shapes (a pool of 2049 blocks,
    256-entry tables), made from ``seed``: each lane's table holds
    distinct blocks drawn for that lane alone, so lanes may share blocks
    as prefix sharing makes them; live lengths are uniform up to the
    table's 4096 positions; lane 0 is an idle lane parked at position 0
    on an all-null table."""
    rng = np.random.RandomState(seed)
    tables = np.stack([rng.choice(np.arange(1, nb), nbl, replace=False)
                       for _ in range(lanes)])
    pos = rng.randint(0, nbl * bs - span + 1, size=lanes)
    tables[0], pos[0] = 0, 0
    return paged_tensors(torch, device, dtype, tables, pos, span, g, seed)


def full_pool_case(torch, device, dtype, seed, lanes=32, bs=16, nbl=256,
                   nb=SERVE["num_blocks"]):
    """The served pool full, made from ``seed``: its nb - 1 usable blocks
    split among the lanes at random and dealt from one permutation, so
    each block sits in one lane's table only, as ContinuousBatcher maps
    them; each lane's live length ends inside its last block."""
    rng = np.random.RandomState(seed)
    counts = 1 + rng.multinomial(nb - 1 - lanes, np.full(lanes, 1 / lanes))
    assert counts.max() <= nbl
    perm = 1 + rng.permutation(nb - 1)
    tables = np.zeros((lanes, nbl), np.int64)
    for b, end in enumerate(np.cumsum(counts)):
        tables[b, :counts[b]] = perm[end - counts[b]:end]
    pos = counts * bs - 1 - rng.randint(0, bs, size=lanes)
    return paged_tensors(torch, device, dtype, tables, pos, 1, 1, seed)


def paged_work(q, pool, tables, pos):
    """(bytes, flops) the paged function needs on these inputs: every
    pool cell some lane attends, read once (a cell two lanes share
    counts once), q, the tables, pos and the output."""
    lanes, span, h, d = q.shape
    nb, bs, kvh, _ = pool["k"].shape
    tables, pos = tables.cpu().numpy(), pos.cpu().numpy()
    used = np.zeros((nb, bs), bool)
    for b in range(lanes):
        t = np.arange(pos[b] + span)
        used[tables[b, t // bs], t % bs] = True
    item = q.element_size()
    nbytes = (2 * int(used.sum()) * kvh * d * item + 2 * q.numel() * item
              + 4 * tables.size + 4 * lanes)
    flops = 4 * int((pos + span).sum()) * span * h * d
    return nbytes, flops


def check_paged(torch, kernels, device):
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for span, g in ((1, 1), (4, 1), (1, 2), (4, 2)):
            q, pool, tables, pos = paged_case(torch, device, dtype, span, g,
                                              seed=10 * span + g)
            got = kernels.paged_attention(q, pool, tables, pos)
            want = kernels.paged_attention_reference(q, pool, tables, pos)
            errs[(name, span, g)] = compare(
                got, want, name,
                "paged_decode %-8s span=%d G=%d" % (name, span, g))
    return errs


# ---------------------------------------------------------------- B4 ---

def flash_case(torch, device, dtype, g, seed, b=8, kvh=8, tmax=4096, d=64):
    """Inputs of one flash-decode case, made from ``seed``; lane 0 has
    no valid key and lane 1 a full cache."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    k, v = (randn(torch, (b, tmax, kvh, d), gen, device, dtype)
            for _ in range(2))
    q = randn(torch, (b, kvh * g, d), gen, device, dtype)
    lengths = rng.randint(1, tmax, size=b)
    lengths[0], lengths[1] = 0, tmax
    return q, k, v, torch.from_numpy(lengths.astype(np.int32)).to(device)


def flash_work(q, k, lengths):
    b, h, d = q.shape
    kvh = k.shape[2]
    live = int(lengths.long().sum())
    item = q.element_size()
    nbytes = 2 * live * kvh * d * item + 2 * q.numel() * item + 4 * b * (1 + h)
    flops = 4 * live * h * d
    return nbytes, flops


def check_flash(torch, kernels, device):
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for g in (1, 2):
            q, k, v, lengths = flash_case(torch, device, dtype, g, seed=20 + g)
            o, lse = kernels.flash_decode_with_lse(q, k, v, lengths)
            o_ref, lse_ref = kernels.dense_decode_with_lse(q, k, v, lengths)
            what = "flash_decode %-8s G=%d" % (name, g)
            errs[(name, g)] = compare(o, o_ref.to(dtype), name, what)
            err_lse = max_err(lse, lse_ref)
            log("%s: lse max abs err %.3g (tol %g)" % (what, err_lse,
                                                      TOL_LSE))
            if not err_lse <= TOL_LSE:
                raise AssertionError("flash_decode's lse disagrees with its "
                                     "plain version")
    return errs


# ------------------------------------------------------ main path runs ---

def teacher_gap(torch, tf, params, cfg, streams, t_prompt):
    """Largest (row max - emitted token's logit) over the emitted tokens
    of ``streams`` (lists of prompt + generated tokens; t_prompt[i] is
    stream i's prompt length), teacher-forcing each stream through
    prefill_chunk."""
    worst = 0.0
    for toks, t_p in zip(streams, t_prompt):
        x = torch.tensor([toks[:-1]], dtype=torch.long, device=params.device)
        cache = tf.init_cache(cfg, 1, params.device)
        logits, _ = tf.prefill_chunk(params, cache, x, 0, cfg,
                                     attend_limit=len(toks) - 1)
        rows = logits[0, t_p - 1:].float()
        emitted = torch.tensor(toks[t_p:], device=params.device)
        gap = rows.max(dim=-1).values - rows.gather(1, emitted[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def serve_jobs(cfg, n_new):
    """The served job mix: SERVE["requests"] seeded prompts of
    prompt_lo-prompt_hi tokens, each asking for ``n_new`` tokens."""
    rng = np.random.RandomState(1)
    return [(list(rng.randint(0, cfg.vocab_size,
                              rng.randint(SERVE["prompt_lo"],
                                          SERVE["prompt_hi"] + 1))),
             n_new) for _ in range(SERVE["requests"])]


def batcher(sv, params, cfg, device):
    return sv.ContinuousBatcher(params, cfg, max_batch=SERVE["max_batch"],
                                block_size=SERVE["block_size"],
                                num_blocks=SERVE["num_blocks"], device=device)


def serve(torch, tf, sv, kernels, params, cfg, device):
    jobs = serve_jobs(cfg, SERVE["n_new"])
    srv = batcher(sv, params, cfg, device)
    kernels.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.admit(p, n) for p, n in jobs]
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    if any(r is None for r in rids):
        raise AssertionError("a request was refused admission")
    results, step_s = {}, []
    while srv.active_count:
        t0 = time.perf_counter()
        results.update(srv.step())
        step_s.append(time.perf_counter() - t0)
    launches = kernels.launches["paged_decode"]
    srv.check_invariants(quiesce=True)
    for rid, (prompt, n_new) in zip(rids, jobs):
        if len(results[rid]) != len(prompt) + n_new \
                or results[rid][:len(prompt)] != prompt:
            raise AssertionError("request %d: wrong stream" % rid)
    steps = srv.dispatch_count
    if steps < SERVE["n_new"] - 1 or launches < cfg.n_layers * steps:
        raise AssertionError("paged kernel launched %d times in %d decode "
                             "steps of %d layers" % (launches, steps,
                                                     cfg.n_layers))
    gap = teacher_gap(torch, tf, params, cfg, [results[r] for r in rids],
                      [len(p) for p, _ in jobs])
    log("serve: %d requests, %d decode steps, paged_decode launches %d, "
        "admission %.3f s, decode step %.3f ms (mean), teacher-forced max "
        "gap %.4f (tol %g)" % (len(jobs), steps, launches, t_admit,
                              1e3 * np.mean(step_s), gap, TOL_TEACHER))
    if not gap <= TOL_TEACHER:
        raise AssertionError("served tokens disagree with the "
                             "teacher-forced logits")
    return {"launches": launches, "steps": steps,
            "step_ms": 1e3 * float(np.mean(step_s))}


def run_generate(torch, tf, kernels, params, cfg, device):
    rng = np.random.RandomState(2)
    b, t_p, n_new = GENERATE["batch"], GENERATE["prompt"], GENERATE["n_new"]
    prompt = rng.randint(0, cfg.vocab_size, (b, t_p)).astype(np.int32)
    kernels.launches.clear()
    out = tf.generate(params, prompt, n_new, cfg, device=device)
    torch.cuda.synchronize()
    launches = kernels.launches["flash_decode"]
    out = out.cpu().numpy()
    if out.shape != (b, t_p + n_new) or not (out[:, :t_p] == prompt).all() \
            or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError("generate() returned a malformed batch")
    if launches < cfg.n_layers * (n_new - 1):
        raise AssertionError("flash_decode launched %d times for %d decode "
                             "steps of %d layers" % (launches, n_new - 1,
                                                     cfg.n_layers))
    gap = teacher_gap(torch, tf, params, cfg, [list(r) for r in out],
                      [t_p] * b)
    # ms per decode step: the 32-token call less the prefill-only call
    times = {}
    for n in (1, n_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.generate(params, prompt, n, cfg, device=device)
        torch.cuda.synchronize()
        times[n] = time.perf_counter() - t0
    step_ms = 1e3 * (times[n_new] - times[1]) / (n_new - 1)
    log("generate: batch %d, prompt %d, %d new tokens, flash_decode "
        "launches %d, decode step %.3f ms, teacher-forced max gap %.4f "
        "(tol %g)" % (b, t_p, n_new, launches, step_ms, gap, TOL_TEACHER))
    if not gap <= TOL_TEACHER:
        raise AssertionError("generated tokens disagree with the "
                             "teacher-forced logits")
    return {"launches": launches, "steps": n_new - 1, "step_ms": step_ms}


# ------------------------------------------------------------ timings ---

def time_paged(torch, F, kernels, device):
    q, pool, tables, pos = full_pool_case(torch, device, torch.bfloat16,
                                          seed=11)
    lanes, _, h, d = q.shape
    ms = time_ms(lambda: kernels.paged_attention(q, pool, tables, pos), 20)
    plain = time_ms(
        lambda: kernels.paged_attention_reference(q, pool, tables, pos), 5)
    # yardstick: SDPA on the gathered dense K/V (gather not timed)
    idx = tables.long()
    t = tables.shape[1] * pool["k"].shape[1]
    kd, vd = (pool[n][idx].reshape(lanes, t, h, d).transpose(1, 2)
              for n in ("k", "v"))
    mask = (torch.arange(t, device=device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qd = q.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask), 20)
    nbytes, flops = paged_work(q, pool, tables, pos)
    return ms, plain, lib, bound_ms(nbytes, flops, "bfloat16")


def time_flash(torch, F, kernels, device):
    q, k, v, lengths = flash_case(torch, device, torch.bfloat16, 1, seed=21)
    b, h, d = q.shape
    t = k.shape[1]
    ms = time_ms(lambda: kernels.flash_decode_with_lse(q, k, v, lengths), 20)
    plain = time_ms(
        lambda: kernels.dense_decode_with_lse(q, k, v, lengths), 5)
    kd, vd = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(t, device=device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    qd = q[:, :, None]
    lib = time_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask), 20)
    nbytes, flops = flash_work(q, k, lengths)
    return ms, plain, lib, bound_ms(nbytes, flops, "bfloat16")


# ------------------------------------------------------------ profile ---

PROFILE_STEPS = 16
PROFILE_TOP = 6
SWEEP_LANES = (8, 32, 128)
SWEEP_LENGTHS = (256, 4096)


def profile_steps(torch, what, step):
    """Run ``step`` PROFILE_STEPS times untraced, then as many times under
    torch.profiler (CUDA activity only), and print the host ms per step of
    both runs, the device ms per step of the traced one (the sum of the
    kernels' own times), its idle share and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    def host_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS

    untraced = host_ms()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = host_ms()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError("the profiler saw no kernel in " + what)
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / PROFILE_STEPS
    log("%s: host %.3f ms per step (%.3f traced), device %.3f ms per step, "
        "idle share %.3f" % (what, untraced, traced, busy, 1 - busy / traced))
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:PROFILE_TOP]:
        log("  %8.1f us/step %5d calls  %s"
            % (e.self_device_time_total / PROFILE_STEPS, e.count, e.key[:80]))


def profile_decode(torch, tf, sv, params, cfg, device):
    """Where a decode step's time goes: the serve job mix on 16 lanes of
    32, then generate()'s decode step at batch 8 after a 256-token
    prefill, each warmed up by two steps."""
    srv = batcher(sv, params, cfg, device)
    for prompt, n_new in serve_jobs(cfg, 2 * PROFILE_STEPS + 4):
        srv.admit(prompt, n_new)
    for _ in range(2):
        srv.step()
    profile_steps(torch, "serve step, 16 live lanes of 32", srv.step)

    b, t_p = GENERATE["batch"], GENERATE["prompt"]
    prompt = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (b, t_p))).to(device)
    state = {"cache": tf.init_cache(cfg, b, device), "pos": t_p}
    with torch.no_grad():
        logits, state["cache"] = tf.prefill(params, state["cache"], prompt,
                                            cfg)
        state["tok"] = torch.argmax(logits, -1)

        def decode():
            out, state["cache"] = tf.decode_step(
                params, state["cache"], state["tok"], state["pos"], cfg)
            state["tok"] = torch.argmax(out, -1)
            state["pos"] += 1

        for _ in range(2):
            decode()
        profile_steps(torch, "generate decode step, batch 8", decode)


# -------------------------------------------------------------- sweep ---

def sweep(torch, F, kernels, device, kvh=8, d=64, bs=16):
    """Both kernels and the yardstick with every lane at one length, in
    bfloat16, over lane counts and lengths. The time follows the total
    bytes where bandwidth limits a kernel, and the per-lane length at a
    fixed lane count where one CTA's walk along its lane does."""
    gen = torch.Generator(device=device).manual_seed(3)

    def rand(*shape):
        return randn(torch, shape, gen, device, torch.bfloat16)

    for lanes in SWEEP_LANES:
        for length in SWEEP_LENGTHS:
            q = rand(lanes, kvh, d)
            k, v = rand(lanes, length, kvh, d), rand(lanes, length, kvh, d)
            lens = torch.full((lanes,), length, dtype=torch.int32,
                              device=device)
            flash = time_ms(
                lambda: kernels.flash_decode_with_lse(q, k, v, lens), 20)
            kd, vd = k.transpose(1, 2), v.transpose(1, 2)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kd, vd), 20)
            del k, v, kd, vd
            nbl = length // bs
            pool = {n: rand(lanes * nbl + 1, bs, kvh, d) for n in "kv"}
            tables = (1 + torch.randperm(lanes * nbl, generator=gen,
                                         device=device)).reshape(lanes, nbl)
            tables = tables.to(torch.int32)
            pos = torch.full((lanes,), length - 1, dtype=torch.int32,
                             device=device)
            qp = q[:, None]
            paged = time_ms(
                lambda: kernels.paged_attention(qp, pool, tables, pos), 20)
            del pool
            bound, _ = bound_ms(2 * lanes * length * kvh * d * 2,
                                4 * lanes * length * kvh * d, "bfloat16")
            log("sweep %3d lanes x %4d: flash_decode %.4f ms, paged_decode "
                "%.4f ms, sdpa %.4f ms, bound %.4f ms"
                % (lanes, length, flash, paged, lib, bound))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    try:
        import mxnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit("chip_smoke: run from the root of a checkout of "
                         "the repository (%s)" % exc)
    import torch.nn.functional as F
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.models import serving as sv
    from mxnet_tpu_torch.models import transformer as tf

    # fp32 comparisons are made in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(card_line())
    log("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    t0 = time.perf_counter()
    _build.build_all()
    log("kernels built in %.1f s" % (time.perf_counter() - t0))

    paged_errs = check_paged(torch, kernels, device)
    flash_errs = check_flash(torch, kernels, device)

    cfg = tf.TransformerConfig(dtype=torch.bfloat16, **SERVE_CFG)
    params = tf.init_params(cfg, seed=0, device=device)
    served = serve(torch, tf, sv, kernels, params, cfg, device)
    generated = run_generate(torch, tf, kernels, params, cfg, device)

    rows = []
    for name, timing, run, err in (
            ("paged_decode", time_paged, served,
             paged_errs[("bfloat16", 1, 1)]),
            ("flash_decode", time_flash, generated,
             flash_errs[("bfloat16", 1)])):
        ms, plain, lib, (bound, bound_by) = timing(torch, F, kernels,
                                                   device)
        log("%s: %.4f ms, plain %.4f ms, sdpa %.4f ms, bound %.4f ms, "
            "%.2f launches per decode step"
            % (name, ms, plain, lib, bound, run["launches"] / run["steps"]))
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": run["launches"], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib})
    log("decode step: serve %.3f ms, generate %.3f ms"
        % (served["step_ms"], generated["step_ms"]))
    profile_decode(torch, tf, sv, params, cfg, device)
    sweep(torch, F, kernels, device)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
