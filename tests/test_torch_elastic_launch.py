"""The port's elastic supervisor (``mxnet_tpu_torch/tools/elastic_launch.py``)
driven with scripted fake workers that import neither torch nor JAX, as
tests/test_elastic.py drives ``tools/elastic_launch.py``: a clean run,
a shrink on exit 44, a regrow at a boundary (45), a loud failure past
``--max-restarts``, the counting of 43 and 143, the doubled accumulation
factor after 47, a quarantine (46) with its evidence, and a chaos spec
that reaches one generation only. The exit codes and the sideband
records are the JAX launcher's, checked by reading the records with the
JAX package. One run goes through ``python -m``; the others call
``main`` in this process. Exact checks throughout."""

import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu.parallel import elastic as jel

from mxnet_tpu_torch.tools import elastic_launch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD = ("import os, sys, json\n"
        "g = int(os.environ['MXNET_ELASTIC_GENERATION'])\n"
        "w = int(os.environ['MXNET_TPU_NUM_PROC'])\n"
        "r = int(os.environ['MXNET_TPU_PROC_ID'])\n"
        "d = os.environ['MXNET_ELASTIC_DIR']\n"
        "def shrink_record(gen, survivors, dead, step):\n"
        "    rec = {'generation': gen, 'survivors': survivors,\n"
        "           'dead': dead, 'world': len(survivors), 'step': step,\n"
        "           'wall': 0.0}\n"
        "    with open(os.path.join(d, 'shrink.g%d.json' % gen), 'w') as f:\n"
        "        json.dump(rec, f)\n")


def _worker(tmp_path, body):
    path = tmp_path / "fake_worker.py"
    path.write_text(HEAD + body)
    return [sys.executable, str(path)]


def _args(tmp_path, n=2, max_restarts=3, extra=()):
    return ["-n", str(n), "--max-restarts", str(max_restarts),
            "--backoff-ms", "10", "--elastic-dir", str(tmp_path / "sb"),
            *extra, "--"]


def _run(tmp_path, capsys, body, **kw):
    os.environ.pop("MXNET_CHAOS", None)
    rc = elastic_launch.main(_args(tmp_path, **kw) + _worker(tmp_path, body))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_clean_run_through_python_m(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXNET_CHAOS", None)
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.elastic_launch",
         *_args(tmp_path), *_worker(tmp_path, "sys.exit(0)\n")],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert "job complete after 1 generation(s), 0 counted" in r.stdout
    gen = jel.read_generation(str(tmp_path / "sb"))
    assert gen["generation"] == 0 and gen["world"] == 2
    assert gen["base_world"] == 2


def test_shrink_on_44_then_finish(tmp_path, capsys):
    body = ("if g == 0 and r == 0:\n"
            "    shrink_record(1, [0], [1], 2)\n"
            "    sys.exit(44)\n"
            "if g == 0:\n"
            "    sys.exit(31)\n"
            "assert w == 1 and os.environ['MXNET_ELASTIC_BASE_WORLD'] == '2'\n"
            "assert 'MXNET_TPU_COORDINATOR' not in os.environ\n"
            "sys.exit(0)\n")
    rc, out, err = _run(tmp_path, capsys, body)
    assert rc == 0, out + err
    assert "shrink: survivors [0] resume from step 2 at world 1" in out
    assert "generation 1: world 1 (shrunk from 2)" in out
    assert jel.read_generation(str(tmp_path / "sb"))["since_wall"] > 0


def test_regrow_at_boundary(tmp_path, capsys):
    body = ("if g == 0 and r == 0:\n"
            "    shrink_record(1, [0], [1], 2)\n"
            "    sys.exit(44)\n"
            "if g == 0:\n"
            "    sys.exit(31)\n"
            "if g == 1:\n"
            "    assert w == 1\n"
            "    sys.exit(45)\n"
            "assert w == 2 and os.environ['MXNET_TPU_COORDINATOR']\n"
            "sys.exit(0)\n")
    rc, out, err = _run(tmp_path, capsys, body)
    assert rc == 0, out + err
    assert "regrow: world 1 -> 2" in out
    # 44 counted, 45 not
    assert "after 3 generation(s), 1 counted restart(s)" in out
    rc, out, err = _run(tmp_path, capsys, body,
                        extra=("--no-regrow", "--start-generation", "0"))
    assert rc == 1 and "crash restart" in out   # g2 at world 1 asserts


def test_max_restarts_fails_loudly(tmp_path, capsys):
    rc, out, err = _run(tmp_path, capsys, "sys.exit(7)\n", max_restarts=2)
    assert rc == 7
    assert "crash-looping" in err
    assert out.count("generation") >= 3
    # a 44 without a shrink record is a crash
    rc, out, err = _run(tmp_path, capsys, "sys.exit(44 if g == 0 else 0)\n")
    assert rc == 0 and "without a shrink record" in err


def test_watchdog_sigterm_oom_quarantine_are_counted(tmp_path, capsys):
    body = ("codes = {0: 43, 1: 143, 2: 47}\n"
            "if g == 3:\n"
            "    assert os.environ['MXNET_MEM_ACCUM_FACTOR'] == '2'\n"
            "    if r == 1:\n"
            "        p = os.path.join(d, 'quarantine.g3.rank1.json')\n"
            "        json.dump({'rank': 1, 'generation': 3, 'host': 'h7',\n"
            "                   'evidence': 'crc'}, open(p, 'w'))\n"
            "        sys.exit(46)\n"
            "    sys.exit(0)\n"
            "if g == 4:\n"
            "    assert w == 1, w\n"
            "sys.exit(codes.get(g, 0))\n")
    rc, out, err = _run(tmp_path, capsys, body, max_restarts=5)
    assert rc == 0, out + err
    assert "watchdog restart 1/5" in out and "sigterm restart 2/5" in out
    assert "oom: relaunching with sticky accumulation factor 2" in out
    assert "quarantine evidence: rank 1 (h7) — crc" in out
    assert "host h7 on cooldown until generation 6" in out
    assert "relaunching at world 1" in out


def test_classify_matches_jax():
    from mxnet_tpu.parallel import elastic as _  # noqa: F401
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_elastic_launch", os.path.join(ROOT, "tools",
                                           "elastic_launch.py"))
    jlaunch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jlaunch)
    for codes in ([0, 0], [44, 31], [46, 0], [47, 0], [45, 0], [45, 45],
                  [43, 0], [143, 0], [9, 0], [45, 44], [46, 44], [43, 143]):
        assert elastic_launch.classify(codes) == jlaunch.classify(codes)


def test_chaos_spec_scoped_to_one_generation(tmp_path, capsys):
    body = ("spec = os.environ.get('MXNET_CHAOS')\n"
            "if g == 0:\n"
            "    assert spec == 'train.step:crash:at=0:rank=1', spec\n"
            "    sys.exit(1)\n"
            "assert spec is None, spec\n"
            "sys.exit(0)\n")
    rc, out, err = _run(tmp_path, capsys, body,
                        extra=("--chaos-spec",
                               "train.step:crash:at=0:rank=1"))
    assert rc == 0, out + err
    assert "crash restart 1/3" in out


@pytest.mark.parametrize("argv", [[], ["-n", "2"]])
def test_no_worker_command_is_refused(argv, capsys):
    with pytest.raises(SystemExit):
        elastic_launch.main(argv)
    capsys.readouterr()
