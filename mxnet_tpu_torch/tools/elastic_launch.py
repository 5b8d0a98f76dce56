"""Elastic supervisor: launch, watch, shrink, regrow, resume (the port's
copy of ``tools/elastic_launch.py``).

The other half of ``mxnet_tpu_torch.parallel.elastic``: a
generation-based restart loop around a multi-process job. Workers run one
*generation* of training; the supervisor reads how each generation ended
and relaunches accordingly — at a smaller world after a coordinated
shrink, at full strength at the next boundary (regrow), or as a plain
capped restart after a crash::

    python -m mxnet_tpu_torch.tools.elastic_launch -n 2 -- \\
        python -m mxnet_tpu_torch.entry --elastic-worker --steps 8 \\
        --ckpt-dir ./elastic_ckpt --keep-global-batch

Exit codes of a worker:

    0    the generation finished and the job is complete -> exit 0
    43   watchdog abort: a collective hung -> counted restart at g+1,
         same world
    44   coordinated shrink: the survivors captured their shards and the
         g+1 shrink record names the new world -> counted restart at g+1
         with the survivors
    45   generation boundary, work remaining -> NOT counted; relaunch at
         g+1 regrown to the full world (unless --no-regrow)
    46   integrity quarantine: the rank judged itself corrupt and left ->
         counted restart; its host is held out of regrow for
         --quarantine-cooldown generations; the relaunch resumes from the
         last verified checkpoint
    47   structural out-of-memory: an emergency checkpoint committed ->
         counted restart at g+1, same world, with the sticky
         gradient-accumulation factor doubled (MXNET_MEM_ACCUM_FACTOR)
    143  SIGTERM (preemption) -> counted restart at g+1, same world
    else a hard crash -> counted restart after an exponential backoff
         with jitter, at g+1, same world

``--max-restarts`` bounds the counted restarts: a crash-looping job fails
loudly with the last failing code.

Workers rendezvous through the variables this supervisor exports:
``MXNET_TPU_NUM_PROC``, ``MXNET_TPU_PROC_ID`` and, above a world of one,
``MXNET_TPU_COORDINATOR`` (``parallel.init_distributed``'s contract), and
``MXNET_ELASTIC_DIR``, ``MXNET_ELASTIC_GENERATION`` and
``MXNET_ELASTIC_BASE_WORLD`` (the full world, from which a worker keeping
the global batch computes its accumulation factor). ``--chaos-spec``
reaches only ``--chaos-generation``'s workers, as ``MXNET_CHAOS``, so an
injected fault cannot fire again after the relaunch. The sticky
accumulation factor starts at ``--accum-factor`` (1). This module imports
nothing but the port's sideband records.
"""

import argparse
import os
import random
import subprocess
import sys
import time

from ..parallel import elastic

WATCHDOG_EXIT_CODE = 43
QUARANTINE_EXIT_CODE = 46
OOM_EXIT_CODE = 47
SIGTERM_EXIT_CODE = 143


def worker_env(args, proc_id, world, generation):
    env = dict(os.environ)
    if args.chaos_spec is not None:
        # the spec reaches ONLY the targeted generation's workers, so an
        # occurrence-counted rule (counters are per process) cannot fire
        # again after the relaunch and turn one fault into a crash loop
        if generation == args.chaos_generation:
            env["MXNET_CHAOS"] = args.chaos_spec
        else:
            env.pop("MXNET_CHAOS", None)
    env.update({
        "MXNET_TPU_NUM_PROC": str(world),
        "MXNET_TPU_PROC_ID": str(proc_id),
        "MXNET_ELASTIC_DIR": args.elastic_dir,
        "MXNET_ELASTIC_GENERATION": str(generation),
        "MXNET_ELASTIC_BASE_WORLD": str(args.num_workers),
    })
    if args.accum_factor > 1:
        # sticky out-of-memory recovery: every later generation inherits
        # the doubled factor, so the job does not relapse
        env["MXNET_MEM_ACCUM_FACTOR"] = str(args.accum_factor)
    if world > 1:
        # a fresh port each generation: the previous generation's
        # coordinator socket may still be in TIME_WAIT
        env["MXNET_TPU_COORDINATOR"] = "127.0.0.1:%d" % (
            args.base_port + generation % 101)
    else:
        env.pop("MXNET_TPU_COORDINATOR", None)
    return env


def run_generation(args, world, generation):
    """Launch one generation's workers and collect their exit codes."""
    elastic.write_generation(
        args.elastic_dir, generation, world,
        base_world=args.num_workers, since_wall=args.since_wall)
    print("[elastic_launch] generation %d: world %d%s"
          % (generation, world,
             " (shrunk from %d)" % args.num_workers
             if world < args.num_workers else ""), flush=True)
    procs = [subprocess.Popen(args.command,
                              env=worker_env(args, i, world, generation))
             for i in range(world)]
    return [p.wait() for p in procs]


def classify(codes):
    """The generation's verdict, in precedence order."""
    if all(c == 0 for c in codes):
        return "done"
    if elastic.SHRINK_EXIT_CODE in codes:
        return "shrink"
    if QUARANTINE_EXIT_CODE in codes:
        return "quarantine"
    if OOM_EXIT_CODE in codes:
        return "oom"
    if all(c in (0, elastic.BOUNDARY_EXIT_CODE) for c in codes):
        return "boundary"
    if WATCHDOG_EXIT_CODE in codes:
        return "watchdog"
    if SIGTERM_EXIT_CODE in codes:
        return "sigterm"
    return "crash"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="elastic restart supervisor",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="full world size (the regrow target)")
    ap.add_argument("--max-restarts", type=int, default=8,
                    help="counted restarts before failing loudly")
    ap.add_argument("--backoff-ms", type=float, default=200.0,
                    help="initial crash-restart backoff (doubles, + up to "
                         "50%% jitter, capped at 30 s)")
    ap.add_argument("--no-regrow", action="store_true",
                    help="stay at the shrunk world at boundaries")
    ap.add_argument("--elastic-dir", default=None,
                    help="rendezvous sideband directory (default: "
                         "$MXNET_ELASTIC_DIR, else ./elastic_sideband)")
    ap.add_argument("--base-port", type=int, default=8476,
                    help="coordinator base port (offset per generation)")
    ap.add_argument("--start-generation", type=int, default=0)
    ap.add_argument("--chaos-spec", default=None,
                    help="chaos spec exported as MXNET_CHAOS to "
                         "--chaos-generation's workers only")
    ap.add_argument("--chaos-generation", type=int, default=0)
    ap.add_argument("--quarantine-cooldown", type=int, default=2,
                    help="generations a quarantined host is held out of "
                         "regrow")
    ap.add_argument("--accum-factor", type=int, default=1,
                    help="initial sticky gradient-accumulation factor "
                         "(doubled after each out-of-memory exit)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no worker command given")
    if args.command[0] == "--":
        args.command = args.command[1:]
    args.elastic_dir = (args.elastic_dir
                        or os.environ.get("MXNET_ELASTIC_DIR")
                        or os.path.abspath("elastic_sideband"))
    args.accum_factor = max(1, args.accum_factor)
    args.since_wall = None
    return args


def _quarantine(args, codes, generation, cooldown):
    """Report the evidence a quarantined rank left and put its host on
    the regrow cooldown list; returns the quarantined ranks."""
    qranks = [i for i, c in enumerate(codes) if c == QUARANTINE_EXIT_CODE]
    if not qranks:
        return qranks
    tags = {}
    for rec in elastic.read_quarantine_records(args.elastic_dir, generation):
        print("[elastic_launch] quarantine evidence: rank %s (%s) — %s"
              % (rec.get("rank"), rec.get("host"), rec.get("evidence")),
              flush=True)
        tags[int(rec.get("rank", -1))] = rec.get("host")
    for r in qranks:
        tag = tags.get(r) or "rank%d" % r
        cooldown[tag] = generation + 1 + args.quarantine_cooldown
        print("[elastic_launch] host %s on cooldown until generation %d"
              % (tag, cooldown[tag]), flush=True)
    return qranks


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.elastic_dir, exist_ok=True)
    world = args.num_workers
    generation = args.start_generation
    restarts = 0
    cooldown = {}     # host tag -> first generation it may rejoin
    while True:
        codes = run_generation(args, world, generation)
        verdict = classify(codes)
        print("[elastic_launch] generation %d exited %s -> %s"
              % (generation, codes, verdict), flush=True)
        qranks = _quarantine(args, codes, generation, cooldown)
        if verdict == "done":
            print("[elastic_launch] job complete after %d generation(s), "
                  "%d counted restart(s)" % (generation + 1, restarts),
                  flush=True)
            return 0
        args.since_wall = time.time()
        if verdict == "boundary":
            # a clean hand-back: the recovered host rejoins here, minus
            # any hosts still on the cooldown list
            target = args.num_workers if not args.no_regrow else world
            held = sorted(t for t, g in cooldown.items()
                          if g > generation + 1)
            new_world = max(1, target - len(held))
            if held and new_world < target:
                print("[elastic_launch] regrow held back by cooldown: %s "
                      "(world %d instead of %d)"
                      % (held, new_world, target), flush=True)
            if new_world > world:
                print("[elastic_launch] regrow: world %d -> %d"
                      % (world, new_world), flush=True)
            world = new_world
            generation += 1
            continue
        restarts += 1
        if restarts > args.max_restarts:
            print("[elastic_launch] FAIL: %d restarts exceeded "
                  "--max-restarts %d — the job is crash-looping, not "
                  "recovering (last codes %s)"
                  % (restarts, args.max_restarts, codes),
                  file=sys.stderr, flush=True)
            return next((c for c in codes if c != 0), 1)
        if verdict == "shrink":
            rec = elastic.read_shrink_record(args.elastic_dir,
                                             generation + 1)
            if rec is None:
                print("[elastic_launch] shrink exit without a shrink record "
                      "— treating as a crash restart", file=sys.stderr,
                      flush=True)
                verdict = "crash"
            else:
                world = int(rec["world"])
                print("[elastic_launch] shrink: survivors %s resume from "
                      "step %d at world %d"
                      % (rec["survivors"], rec["step"], world), flush=True)
                generation += 1
                continue
        if verdict == "quarantine":
            # the corrupt rank removed itself: relaunch without it, from
            # the last verified checkpoint
            new_world = max(1, world - len(qranks))
            print("[elastic_launch] quarantine: rank(s) %s removed — "
                  "relaunching at world %d from the last verified "
                  "checkpoint" % (qranks, new_world), flush=True)
            world = new_world
            generation += 1
            continue
        if verdict == "oom":
            # smaller micro-batches at the same global batch, so the
            # resumed step fits where the old one died
            args.accum_factor *= 2
            print("[elastic_launch] oom: relaunching with sticky "
                  "accumulation factor %d (MXNET_MEM_ACCUM_FACTOR)"
                  % args.accum_factor, flush=True)
        # watchdog, oom, sigterm and crash: a capped exponential backoff
        # with jitter, so supervisors never stampede a shared resource
        delay = min(args.backoff_ms * (2 ** (restarts - 1)), 30000.0)
        delay *= 1.0 + 0.5 * random.random()
        print("[elastic_launch] %s restart %d/%d in %.0f ms"
              % (verdict, restarts, args.max_restarts, delay), flush=True)
        time.sleep(delay / 1e3)
        generation += 1


if __name__ == "__main__":
    sys.exit(main())
