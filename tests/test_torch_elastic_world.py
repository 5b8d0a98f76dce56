"""The elastic chain end to end on the CPU, in real processes: the port's
counterpart of tests/test_elastic.py's slow ``test_two_process_kill_one_rank
_e2e`` (``tools/chaos_smoke.py --elastic``), on the port's toy worker
(``python -m mxnet_tpu_torch.entry --elastic-worker``) under the port's
launcher.

A 2-rank gloo world (the launcher's coordinator on localhost) loses rank
1 to a chaos kill after its second step. Rank 0, in the all-reduce of its
third step, finds the dead peer on the sideband (heartbeat every 0.2 s,
3 misses), captures its shard of step 2, exits 44, and the launcher
relaunches it at world 1, where it keeps the global batch of 8 rows with
2 micro-batches a step; after 2 steps it hands back at a boundary (45)
and the world regrows to 2 and finishes step 6. A host whose loopback
interface gloo does not pick may need GLOO_SOCKET_IFNAME=lo.

Checks: the launcher's log shows the shrink and the regrow; the DATA
lines tile rows 0-48 with no row skipped or replayed; generation 1's
LOSS lines are bitwise those of a clean world-1 run resumed from the
same shard set in another process; the regrown world's ranks agree; and
generation 1's losses lie within rtol 1e-5 of JAX's
``make_accum_train_step`` run from the captured state loaded by the JAX
package (fp32 arithmetic in another order)."""

import os
import re
import shutil
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from mxnet_tpu.models import checkpoint as jck
from mxnet_tpu.parallel import elastic as jel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, ROWS = 6, 8
TIMEOUT = 150


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.pop("MXNET_CHAOS", None)
    env.update(kw)
    return env


def _worker(ck, steps, gen_steps):
    return [sys.executable, "-m", "mxnet_tpu_torch.entry",
            "--elastic-worker", "--steps", str(steps), "--gen-steps",
            str(gen_steps), "--ckpt-dir", ck, "--device", "cpu",
            "--keep-global-batch", "--heartbeat-s", "0.2", "--miss", "3",
            "--keep-generations", "8"]


def _losses(out, gen):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^LOSS g%d r0 (\d+) (\S+)$" % gen, out, re.M)}


def test_kill_shrink_exact_resume_regrow(tmp_path):
    sb, ck = str(tmp_path / "sb"), str(tmp_path / "ck")
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.elastic_launch",
         "-n", "2", "--max-restarts", "4", "--backoff-ms", "100",
         "--elastic-dir", sb, "--base-port", str(_free_port()),
         "--chaos-spec", "train.step:crash:at=1:rank=1:code=31",
         "--", *_worker(ck, STEPS, 2)],
        capture_output=True, text=True, timeout=TIMEOUT, env=_env())
    out = r.stdout
    assert r.returncode == 0, out[-4000:] + r.stderr[-4000:]
    assert "generation 0 exited [44, 31] -> shrink" in out, out
    assert "regrow: world 1 -> 2" in out and "job complete" in out

    # every row exactly once, whatever generation consumed it
    ranges = {}
    for m in re.finditer(r"^DATA g(\d+) r0 (\d+) (\d+) (\d+)$", out, re.M):
        step, lo, hi = (int(m.group(i)) for i in (2, 3, 4))
        assert ranges.setdefault(step, (lo, hi)) == (lo, hi), step
    assert ranges == {s: ((s - 1) * ROWS, s * ROWS)
                      for s in range(1, STEPS + 1)}

    g1 = _losses(out, 1)
    assert sorted(g1) == [3, 4], out
    assert "resumed g1 r0 from step 2 (world 1, accum 2)" in out
    finals = re.findall(r"^final g2 r(\d) step 6 param_l1 (\S+) "
                        r"fingerprint (\S+)$", out, re.M)
    assert len(finals) == 2 and finals[0][1:] == finals[1][1:]

    # a clean world-1 run from the same shard set, in another process
    clean_ck = str(tmp_path / "ck_clean")
    shutil.copytree(ck, clean_ck)
    rc = subprocess.run(
        _worker(clean_ck, max(g1), 0), capture_output=True, text=True,
        timeout=TIMEOUT, env=_env(
            MXNET_ELASTIC_DIR=str(tmp_path / "sb_clean"),
            MXNET_ELASTIC_GENERATION="1", MXNET_ELASTIC_RESUME_GEN="1",
            MXNET_ELASTIC_BASE_WORLD="2", MXNET_TPU_NUM_PROC="1",
            MXNET_TPU_PROC_ID="0"))
    assert rc.returncode == 0, rc.stderr[-4000:]
    assert _losses(rc.stdout, 1) == g1

    # JAX's accumulating step from the captured state, on the same rows
    cfg, params, mom, step, extras = jck.load_shard_checkpoint(
        clean_ck, generation=1)
    assert step == 2 and extras["world"] == 1 and extras["base_world"] == 2
    data = np.random.RandomState(7).randint(
        0, cfg.vocab_size, (64, cfg.max_len)).astype(np.int32)
    jstep = jel.make_accum_train_step(cfg, lr=0.1, accum=2)
    for s in (3, 4):
        rows = data[(s - 1) * ROWS:s * ROWS].reshape(2, ROWS // 2, -1)
        params, mom, loss = jstep(params, mom, jnp.asarray(rows))
        np.testing.assert_allclose(float.fromhex(g1[s]), float(loss),
                                   rtol=1e-5)
