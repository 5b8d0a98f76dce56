"""Checkpoints of the transformer (port of ``mxnet_tpu/models/checkpoint.py``,
its single-controller part).

The format is the JAX package's, so a checkpoint written by either
package loads in the other:

* **save** copies every parameter (and, for training, every momentum
  leaf) to host memory and writes ONE data file
  (``arrays-<step>-<id>.npz``), then a retained per-save
  ``manifest-<step>-<id>.json`` and the ``manifest.json`` latest pointer,
  whose atomic replace is the commit point. Keys are the flattened tree
  paths of the JAX package (``p.embed``, ``p.layers.0.wq``, momentum
  under ``m.``), which are the port's parameter names behind a prefix.
* every manifest carries a **per-array crc32** of the exact bytes on
  disk and a ``dtypes`` map: bf16 is stored as JAX stores it, as 2-byte
  void records, and viewed back by name on load.
* **lineage**: ``param_fingerprint`` folds every parameter's name,
  dtype, shape and bytes (the id serving's ``weight_fingerprint``
  reports for the same weights) and ``parent`` names the manifest this
  process last committed or loaded; :func:`verify_lineage` walks the
  chain.
* :func:`load_checkpoint` verifies every digest and the fingerprint and
  raises :class:`CheckpointCorrupt` naming the file and both digests on a
  torn, truncated or missing data file, falling back to the newest older
  retained checkpoint (``save_checkpoint(..., keep=N)``).
* ``save_checkpoint(..., async_save=True)`` copies the tree into pinned
  host memory on the CURRENT stream before it returns and writes it on a
  saver thread, which waits for that copy first. The port's train step
  writes parameters and momentum in place, so the copy must be ordered
  ahead of the next step's writes: stream order does that, and a step
  called straight after the save leaves the checkpoint at the values it
  was given. The next save or load, or :func:`wait_for_pending_save`, is
  the barrier, and re-raises a failed write.
* :func:`install_emergency_checkpoint` saves once on SIGTERM or SIGINT
  and once at interpreter exit; :func:`resume_from_latest` is the other
  half of the restart loop.

Int8 weight trees (``transformer.quantize_weights_int8``) save and load
in the JAX package's form: each :class:`~.transformer.Q8Weight` as three
arrays under the ``#`` suffix (``p.layers.0.wq#q8``, ``#scale`` and
``#dt``, a zero-size array of the weight's dtype), in both directions;
they are serving artifacts, so :func:`restore_train_state` refuses them,
as JAX does. Restoring onto a mesh goes through
``transformer.shard_params`` (each rank's block). Not ported: the shard
checkpoints and elastic resume (``save_shard_checkpoint`` through
``resume_elastic``), which need a multi-process world (ROADMAP item A7d),
the memory budget's snapshot admission and the collective-hang
watchdog's escalation hook (A10).
"""

import atexit
import dataclasses
import gc
import json
import os
import signal
import threading
import traceback
import warnings
import zlib

import numpy as np
import torch

from ..context import resolve_device
from ..observability import chaos as _chaos
from ..observability import membudget as _membudget

__all__ = ["save_checkpoint", "load_checkpoint", "restore_train_state",
           "CheckpointCorrupt", "CheckpointIncompatible",
           "wait_for_pending_save", "verify_lineage", "lineage_head",
           "list_checkpoints", "resume_from_latest", "resume_elastic",
           "save_shard_checkpoint", "load_shard_checkpoint",
           "list_shard_generations", "shard_layout",
           "install_emergency_checkpoint",
           "uninstall_emergency_checkpoint",
           "save_emergency_checkpoint", "fingerprint_entries"]

_SEP = "."          # path component separator inside npz keys
_PARAMS = "p"       # key prefix: model parameters
_MOMENTUM = "m"     # key prefix: optimizer momentum
_QSUF = "#"         # q8 sub-leaf suffix marker: "...wq#q8", "...wq#scale"
_FORMAT = "mxnet_tpu.transformer.checkpoint/1"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int8": torch.int8, "int32": torch.int32, "int64": torch.int64}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint that must not be trusted: torn/truncated/missing
    data file or a per-array digest mismatch. The message names the
    file and, for digest failures, expected vs actual."""


class CheckpointIncompatible(CheckpointCorrupt):
    """A checkpoint that cannot serve THIS resume: a config mismatch (or
    the elastic world / generation a shard save records). The message
    names the mismatching field and both values."""


def _a7_refusal(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            "checkpoint.%s: shard checkpoints and elastic resume need a "
            "multi-process world and come with ROADMAP item A7d" % name)
    refuse.__name__ = name
    refuse.__doc__ = ("Not ported: raises naming ROADMAP item A7d (shard "
                      "checkpoints and elastic resume).")
    return refuse


save_shard_checkpoint = _a7_refusal("save_shard_checkpoint")
load_shard_checkpoint = _a7_refusal("load_shard_checkpoint")
list_shard_generations = _a7_refusal("list_shard_generations")
shard_layout = _a7_refusal("shard_layout")
resume_elastic = _a7_refusal("resume_elastic")


# ---------------------------------------------------------- host trees --

def _flatten(params, momentum):
    """{npz key: tensor} of the parameters (a TransformerLM; an int8
    weight as its ``#q8``, ``#scale`` and ``#dt`` arrays) and the momentum
    (a dict by parameter name)."""
    from .transformer import TransformerLM, flat_tensors
    if not isinstance(params, TransformerLM):
        raise TypeError("params must be a TransformerLM")
    flat = {_PARAMS + _SEP + n: t for n, t in flat_tensors(params).items()}
    if momentum is not None:
        flat.update((_MOMENTUM + _SEP + n, m) for n, m in momentum.items())
    return flat


def _dtype_name(t):
    return "bfloat16" if t.dtype == torch.bfloat16 \
        else str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _to_numpy(t):
    """A host tensor as the numpy array the JAX package writes: bf16 as
    2-byte void records (what numpy makes of an ml_dtypes array)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr, dtype_name, device):
    """The inverse: a numpy array whose true dtype is ``dtype_name``."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device)


class _Snapshot(object):
    """Host copies of every leaf. On CUDA each is copied into pinned
    memory on the current stream, behind one event: stream order puts
    the copies ahead of any later in-place write of the tensors, and
    :meth:`arrays` waits for the event before the host reads them."""

    def __init__(self, flat, overlap=True):
        self.dtypes = {k: _dtype_name(t) for k, t in flat.items()}
        self.host = {}
        self.event = None
        for k, t in flat.items():
            t = t.detach()
            if t.device.type == "cuda":
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=overlap)
                self.host[k] = buf
            else:
                self.host[k] = t.clone()
        if any(t.device.type == "cuda" for t in flat.values()):
            self.event = torch.cuda.Event()
            self.event.record()

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in self.host.values())

    def arrays(self):
        if self.event is not None:
            self.event.synchronize()
        return {k: _to_numpy(t) for k, t in self.host.items()}


def _snapshot(flat):
    """The host snapshot of a save, with the chaos site
    ``checkpoint.snapshot``; an out-of-memory error (injected or real)
    retries once, leaf by leaf, after a collection."""
    if not _chaos.enabled():
        return _Snapshot(flat)
    try:
        nbytes = sum(t.numel() * t.element_size() for t in flat.values())
        _chaos.fire("checkpoint.snapshot", bytes=nbytes)
        return _Snapshot(flat)
    except Exception as exc:  # noqa: BLE001 — retry an OOM once
        if not _membudget.is_resource_exhausted(exc):
            raise
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return _Snapshot(flat, overlap=False)


def fingerprint_entries(entries):
    """8-hex id of a tree: the JAX package's
    ``integrity.tree_fingerprint``, a crc32 fold over the entries sorted
    by name, each ``(name, dtype name, shape, bytes)``. The same weights
    give the same id in both packages (bf16 reads "bfloat16" over its
    2-byte words, as numpy renders an ml_dtypes array)."""
    acc = 0
    for name, dtype, shape, raw in sorted(entries, key=lambda e: e[0]):
        c = zlib.crc32(raw) & 0xFFFFFFFF
        acc = zlib.crc32(
            ("%s:%s:%s:%08x" % (name, dtype, tuple(shape), c)).encode(),
            acc) & 0xFFFFFFFF
    return "%08x" % acc


def _param_fingerprint(host, dtypes):
    return fingerprint_entries(
        (k, dtypes.get(k) or v.dtype.name, v.shape,
         np.ascontiguousarray(v).tobytes())
        for k, v in host.items() if k.startswith(_PARAMS + _SEP))


def _cfg_to_json(cfg):
    """TransformerConfig -> the JAX package's config JSON: the dtype by
    its numpy name."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = next(n for n, t in _DTYPES.items() if t == cfg.dtype)
    return d


def _cfg_from_json(d):
    from .transformer import TransformerConfig
    d = dict(d)
    d["dtype"] = _DTYPES[d["dtype"]]
    return TransformerConfig(**d)


def _crc(arr):
    """crc32 hex of the array's exact on-disk bytes."""
    return "%08x" % (zlib.crc32(np.ascontiguousarray(arr).tobytes())
                     & 0xFFFFFFFF)


def _world():
    if torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return torch.distributed.get_world_size(), \
            torch.distributed.get_rank()
    return 1, 0


# ------------------------------------------------------- async in-flight --

_pending_lock = threading.Lock()
_pending = [None]                    # the one in-flight saver thread
_last_committed_step = [None]        # newest step this process committed

# lineage tail: {"name", "digest", "step"} of the newest manifest this
# process committed OR loaded — the next save records it as its parent
_lineage = [None]


def _manifest_digest(text):
    return "%08x" % (zlib.crc32(text.encode()) & 0xFFFFFFFF)


def _note_lineage(path, name):
    """Record ``name`` as the lineage tail after a successful load, so a
    checkpoint saved by the resumed run chains to the one it resumed
    from. The latest pointer resolves to its retained twin (same
    content): the pointer file is overwritten every save and cannot
    anchor a chain."""
    try:
        with open(os.path.join(path, name)) as f:
            text = f.read()
        m = json.loads(text)
        if name == "manifest.json":
            for _s, _mt, rname, arrays in _retained_manifests(path):
                if arrays == m.get("arrays_file"):
                    name = rname
                    with open(os.path.join(path, rname)) as f:
                        text = f.read()
                    break
            else:
                return
        _lineage[0] = {"name": name, "digest": _manifest_digest(text),
                       "step": int(m.get("step", -1))}
    except (OSError, ValueError):
        pass


def lineage_head():
    """The current lineage tail: the manifest this process last committed
    or loaded (name, digest, step), or None before either."""
    return _lineage[0]


class _Saver(threading.Thread):
    def __init__(self, fn):
        super().__init__(name="mxnet-ckpt-saver", daemon=True)
        self._fn = fn
        self.error = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # noqa: BLE001 — re-raised at barrier
            self.error = e


def wait_for_pending_save():
    """Block until the in-flight async save (if any) committed; re-raise
    its failure here."""
    with _pending_lock:
        t = _pending[0]
    if t is None:
        return
    t.join()
    with _pending_lock:
        if _pending[0] is t:
            _pending[0] = None
    if t.error is not None:
        raise t.error


def save_checkpoint(path, cfg, params, momentum=None, step=0,
                    metadata=None, keep=1, async_save=False):
    """Write a training (or serving) checkpoint directory.

    path      directory (created); holds manifest.json and the data files
              it references (arrays-<step>-<id>.npz)
    cfg       the TransformerConfig the params were built with
    params    a TransformerLM (on any device)
    momentum  optional momentum, a dict by parameter name
              (``transformer.init_momentum``); omit for serving
    step      training step counter, returned on restore
    metadata  optional JSON-serialisable dict
    keep      retain this many complete checkpoints (default 1); older
              ones are deleted after the commit, the newest never
    async_save  copy to pinned host memory now, on the current stream;
              serialise, commit and sweep on a saver thread after that
              copy completes. The next save/load is the barrier. A
              multi-process world saves synchronously (rank 0 writes).
    """
    wait_for_pending_save()          # in-flight barrier (and re-raise)
    flat = _flatten(params, momentum)
    world, rank = _world()
    snap = _snapshot(flat)
    has_m = momentum is not None
    if async_save and world == 1:
        t = _Saver(lambda: _write_commit_sweep(
            path, cfg, snap.arrays(), snap.dtypes, has_m, step, metadata,
            keep))
        with _pending_lock:
            _pending[0] = t
        t.start()
        return path
    write_error = None
    try:
        if rank == 0:
            _write_commit_sweep(path, cfg, snap.arrays(), snap.dtypes,
                                has_m, step, metadata, keep)
    except Exception as e:  # noqa: BLE001 — re-raised below
        write_error = e
    if world > 1:
        # completion barrier and success broadcast: no rank proceeds
        # before the writer committed, and a writer failure raises
        # everywhere
        ok = [write_error is None]
        torch.distributed.broadcast_object_list(ok, src=0)
        if write_error is None and not ok[0]:
            raise RuntimeError(
                "checkpoint save failed on the writing process (rank 0); "
                "see its log for the original error")
    if write_error is not None:
        raise write_error
    return path


def _write_commit_sweep(path, cfg, host, dtypes, has_momentum, step,
                        metadata, keep=1):
    """The write path. The data file gets a unique name and the manifests
    point at it: a crash at ANY point leaves every previously committed
    checkpoint intact, and the final manifest.json replace is the
    commit. A retained copy (manifest-<step>-<id>.json) lands first.
    Afterwards the sweep deletes past-``keep`` checkpoints, unreferenced
    data files and orphaned .tmp files — never the newest."""
    os.makedirs(path, exist_ok=True)
    stamp = "%d-%s" % (int(step), os.urandom(4).hex())
    arrays_file = "arrays-%s.npz" % stamp
    manifest = {
        "format": _FORMAT,
        "config": _cfg_to_json(cfg),
        "step": int(step),
        "has_momentum": has_momentum,
        "arrays_file": arrays_file,
        # the true dtype of every entry (bf16 is written as void records)
        "dtypes": dict(dtypes),
        "arrays": sorted(host),
        "checksums": {k: _crc(v) for k, v in host.items()},
        "param_fingerprint": _param_fingerprint(host, dtypes),
        "parent": _lineage[0],
        "metadata": metadata or {},
    }
    # serialise BEFORE touching the directory: a non-JSON metadata value
    # must fail before any file is written
    manifest_text = json.dumps(manifest, indent=1, sort_keys=True)
    tmp = os.path.join(path, "." + arrays_file + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, os.path.join(path, arrays_file))
    if _chaos.enabled():
        # at-rest corruption of the landed data file, before the commit
        _chaos.corrupt_file("checkpoint.bytes",
                            os.path.join(path, arrays_file), step=int(step))
    # a crash injected HERE (data landed, nothing committed) is the
    # torn-save case
    _chaos.fire("checkpoint.write", path=path, step=int(step))
    retained = "manifest-%s.json" % stamp
    for name in (retained, "manifest.json"):
        tmp = os.path.join(path, "." + name + ".tmp")
        with open(tmp, "w") as f:
            f.write(manifest_text)
        os.replace(tmp, os.path.join(path, name))   # last one = commit
    _last_committed_step[0] = int(step)
    _lineage[0] = {"name": retained,
                   "digest": _manifest_digest(manifest_text),
                   "step": int(step)}
    _sweep(path, keep, stamp)


def _retained_manifests(path):
    """[(step, mtime, filename, arrays_file)] for every readable retained
    manifest, oldest first."""
    out = []
    for name in os.listdir(path):
        if not (name.startswith("manifest-") and name.endswith(".json")):
            continue
        full = os.path.join(path, name)
        try:
            with open(full) as f:
                m = json.load(f)
            mtime = os.path.getmtime(full)
        except (OSError, ValueError):
            continue
        out.append((int(m.get("step", -1)), mtime, name,
                    m.get("arrays_file")))
    out.sort(key=lambda e: (e[0], e[1], e[2]))
    return out


def _sweep(path, keep, current_stamp):
    """Retention: keep the newest ``keep`` complete checkpoints (always
    the one just written), drop older manifest/data pairs, unreferenced
    data files and orphaned tmps."""
    keep = max(int(keep), 1)
    entries = _retained_manifests(path)
    keepers = {e[2] for e in entries[-keep:]}
    keepers.add("manifest-%s.json" % current_stamp)
    referenced = {e[3] for e in entries if e[2] in keepers}
    # protect the data file the latest pointer references, whatever
    # wrote it
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            referenced.add(json.load(f).get("arrays_file"))
    except (OSError, ValueError):
        pass
    for stale in os.listdir(path):
        doomed_manifest = (stale.startswith("manifest-")
                           and stale.endswith(".json")
                           and stale not in keepers)
        doomed_arrays = (stale.startswith("arrays")
                         and stale not in referenced)
        orphaned_tmp = stale.startswith(".") and stale.endswith(".tmp")
        if doomed_manifest or doomed_arrays or orphaned_tmp:
            try:
                os.remove(os.path.join(path, stale))
            except OSError:
                pass


def list_checkpoints(path):
    """Complete retained checkpoints under ``path`` as [(step,
    manifest_filename)], oldest first (a bare manifest.json lists as
    [(step, 'manifest.json')])."""
    if not os.path.isdir(path):
        return []
    entries = [(e[0], e[2]) for e in _retained_manifests(path)]
    if not entries and os.path.exists(os.path.join(path, "manifest.json")):
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                entries = [(int(json.load(f).get("step", -1)),
                            "manifest.json")]
        except (OSError, ValueError):
            pass
    return entries


def _read_arrays(path, manifest, manifest_name):
    """The verified read of one manifest's data file: {key: (numpy
    array, dtype name)}. Every entry must exist and match its digest;
    raises CheckpointCorrupt naming the file otherwise."""
    arrays_file = manifest.get("arrays_file", "arrays.npz")
    full = os.path.join(path, arrays_file)
    checksums = manifest.get("checksums")     # absent on old checkpoints
    dtypes = manifest.get("dtypes", {})
    flat = {}
    try:
        with np.load(full) as npz:
            members = set(npz.files)
            for k in manifest.get("arrays", sorted(members)):
                if k not in members:
                    raise CheckpointCorrupt(
                        "checkpoint %s (%s): array %r missing from %s"
                        % (path, manifest_name, k, arrays_file))
                arr = npz[k]
                if checksums is not None:
                    got = _crc(arr)
                    want = checksums.get(k)
                    if got != want:
                        raise CheckpointCorrupt(
                            "checkpoint %s (%s): array %r in %s is "
                            "corrupt — digest %s, manifest says %s"
                            % (path, manifest_name, k, arrays_file,
                               got, want))
                flat[k] = (arr, dtypes.get(k) or arr.dtype.name)
    except CheckpointCorrupt:
        raise
    except FileNotFoundError:
        raise CheckpointCorrupt(
            "checkpoint %s (%s): data file %s is missing"
            % (path, manifest_name, arrays_file)) from None
    except Exception as e:  # noqa: BLE001 — torn zip, short read, ...
        raise CheckpointCorrupt(
            "checkpoint %s (%s): data file %s is unreadable (%s: %s)"
            % (path, manifest_name, arrays_file,
               type(e).__name__, e)) from e
    return flat


def _fingerprint_of(flat):
    return fingerprint_entries(
        (k, dt, arr.shape, np.ascontiguousarray(arr).tobytes())
        for k, (arr, dt) in flat.items() if k.startswith(_PARAMS + _SEP))


def _load_manifest(path, manifest_name, mesh, device):
    full = os.path.join(path, manifest_name)
    try:
        with open(full) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise CheckpointCorrupt(
            "checkpoint %s: manifest %s is not valid JSON (%s)"
            % (path, manifest_name, e)) from e
    if not str(manifest.get("format", "")).startswith(
            "mxnet_tpu.transformer.checkpoint/"):
        raise ValueError("not a transformer checkpoint: %s" % path)
    cfg = _cfg_from_json(manifest["config"])
    flat = _read_arrays(path, manifest, manifest_name)
    want_fp = manifest.get("param_fingerprint")
    if want_fp is not None:
        # the lineage gate: an unverifiable checkpoint is refused (the
        # caller's candidate loop falls back to an ancestor)
        got_fp = _fingerprint_of(flat)
        if got_fp != want_fp:
            raise CheckpointCorrupt(
                "checkpoint %s (%s): parameter fingerprint %s does not "
                "match manifest %s — refusing unverified weights"
                % (path, manifest_name, got_fp, want_fp))
    from .transformer import (Q8Weight, TransformerLM, _set_leaf,
                              shard_params)
    params = TransformerLM(cfg, device if mesh is None else mesh.device)
    named = dict(params.named_parameters())
    pref, mref = _PARAMS + _SEP, _MOMENTUM + _SEP
    keys = {k[len(pref):].split(_QSUF)[0] for k in flat if k.startswith(pref)}
    if keys != set(named):
        raise CheckpointIncompatible(
            "checkpoint %s: its parameters do not match the config's: %s"
            % (path, sorted(keys ^ set(named))))
    with torch.no_grad():
        for name, p in named.items():
            q8 = pref + name + _QSUF
            arr, dt = flat.get(pref + name) or flat[q8 + "q8"]
            if tuple(arr.shape) != tuple(p.shape):
                raise CheckpointIncompatible(
                    "checkpoint %s: %s has shape %s, the config %s"
                    % (path, name, arr.shape, tuple(p.shape)))
            if pref + name in flat:
                p.copy_(_to_tensor(arr, dt, p.device))
                continue
            scale, scale_dt = flat[q8 + "scale"]
            _set_leaf(params, name, Q8Weight(
                _to_tensor(arr, dt, p.device),
                _to_tensor(scale, scale_dt, p.device),
                _DTYPES[flat[q8 + "dt"][1]]))
    momentum = None
    if manifest["has_momentum"]:
        momentum = {k[len(mref):]: _to_tensor(arr, dt, params.device)
                    for k, (arr, dt) in flat.items() if k.startswith(mref)}
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
        if momentum is not None:
            # the momentum takes its parameter's block: shard it as a tree
            # of the same names
            shell = TransformerLM(cfg, "meta")
            for name, m in momentum.items():
                _set_leaf(shell, name, m)
            momentum = dict(shard_params(shell, cfg, mesh).named_parameters())
    return cfg, params, momentum, int(manifest["step"]), \
        manifest.get("metadata", {})


def load_checkpoint(path, mesh=None, fallback=True, device=None):
    """Read a checkpoint directory back: ``(cfg, params, momentum, step,
    metadata)``, params a TransformerLM and momentum a dict by parameter
    name (None when the checkpoint carried none), on ``device`` (the
    current CUDA device by default), or placed for ``mesh`` through
    ``shard_params``'s rule, each rank its block of the parameters and
    of the momentum.

    Every array is digest-verified against the manifest, and the
    parameters against its fingerprint; a torn, truncated or missing
    data file raises :class:`CheckpointCorrupt` naming the file and
    digests. With ``fallback=True`` (default) a corrupt newest checkpoint
    falls back, with a warning, to the newest older retained one."""
    wait_for_pending_save()
    if mesh is None:
        device = resolve_device(device)
    candidates = []
    latest_arrays = None
    if os.path.exists(os.path.join(path, "manifest.json")):
        candidates.append("manifest.json")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                latest_arrays = json.load(f).get("arrays_file")
        except (OSError, ValueError):
            latest_arrays = None
    retained = _retained_manifests(path) if os.path.isdir(path) else []
    for _step, _mt, name, arrays in reversed(retained):
        if arrays == latest_arrays and candidates:
            continue                 # same checkpoint as the pointer
        candidates.append(name)
    if not candidates:
        # a missing directory or manifest surfaces as FileNotFoundError
        with open(os.path.join(path, "manifest.json")):
            pass
    first_error = None
    for i, name in enumerate(candidates):
        try:
            out = _load_manifest(path, name, mesh, device)
        except CheckpointCorrupt as e:
            if first_error is None:
                first_error = e
            if not fallback:
                raise
            if i + 1 < len(candidates):
                warnings.warn(
                    "mxnet_tpu_torch.checkpoint: %s — falling back to an "
                    "older retained checkpoint" % e,
                    RuntimeWarning, stacklevel=2)
            continue
        if first_error is not None:
            warnings.warn(
                "mxnet_tpu_torch.checkpoint: recovered from %s at step %d "
                "after a corrupt newer checkpoint" % (name, out[3]),
                RuntimeWarning, stacklevel=2)
        _note_lineage(path, name)
        return out
    raise first_error


def verify_lineage(path, deep=False):
    """Walk the retained-manifest chain newest -> oldest and verify it.

    Returns a list, newest first, of ``{"name", "step", "status",
    "parent"}``: ``status`` is ``verified`` (manifest readable; with
    ``deep=True`` also every array digest and the recomputed parameter
    fingerprint), ``corrupt`` (``detail`` names why) or
    ``parent-mismatch`` (the parent manifest on disk no longer matches
    the digest recorded at save time); ``parent`` is ``root``,
    ``verified``, ``mismatch`` or ``pruned`` (a parent deleted by
    retention ends the chain and is not a failure)."""
    entries = _retained_manifests(path) if os.path.isdir(path) else []
    texts, manifests = {}, {}
    for _s, _mt, name, _arrays in entries:
        try:
            with open(os.path.join(path, name)) as f:
                texts[name] = f.read()
            manifests[name] = json.loads(texts[name])
        except (OSError, ValueError):
            continue
    out = []
    for _s, _mt, name, _arrays in reversed(entries):
        m = manifests.get(name)
        if m is None:
            out.append({"name": name, "step": -1, "status": "corrupt",
                        "parent": None, "detail": "manifest unreadable"})
            continue
        status, detail = "verified", None
        if deep:
            try:
                flat = _read_arrays(path, m, name)
                want = m.get("param_fingerprint")
                if want is not None:
                    got = _fingerprint_of(flat)
                    if got != want:
                        status = "corrupt"
                        detail = ("param fingerprint %s != manifest %s"
                                  % (got, want))
            except CheckpointCorrupt as e:
                status, detail = "corrupt", str(e)
        parent = m.get("parent")
        if not parent:
            pstat = "root"
        else:
            ptext = texts.get(parent.get("name"))
            if ptext is None:
                pstat = "pruned"
            elif _manifest_digest(ptext) == parent.get("digest"):
                pstat = "verified"
            else:
                pstat = "mismatch"
                if status == "verified":
                    status = "parent-mismatch"
        entry = {"name": name, "step": int(m.get("step", -1)),
                 "status": status, "parent": pstat}
        if detail:
            entry["detail"] = detail
        out.append(entry)
    return out


def restore_train_state(path, mesh=None, device=None):
    """Checkpoint -> ``(cfg, params, momentum, step)`` ready for
    ``make_train_step(cfg)``. A checkpoint saved without momentum
    resumes with zero momentum."""
    cfg, params, momentum, step, _ = load_checkpoint(path, mesh=mesh,
                                                     device=device)
    return _finish_train_state(cfg, params, momentum, step)


def resume_from_latest(path, mesh=None, init=None, expect_world=None,
                       expect_generation=None, expect_cfg=None,
                       device=None):
    """Resume training from the newest loadable checkpoint under ``path``
    (corrupt newer ones fall back as in :func:`load_checkpoint`):
    ``(cfg, params, momentum, step)``. With no checkpoint present it
    returns ``init()``, which must give that same tuple (step 0 by
    convention), so a worker that always starts with
    ``resume_from_latest(dir, init=fresh)`` is restartable.

    ``expect_cfg`` field-compares the saved config with this run's;
    ``expect_world`` / ``expect_generation`` check the elastic metadata a
    shard save records. A mismatch raises
    :class:`CheckpointIncompatible` naming the field and both values."""
    wait_for_pending_save()
    has_any = os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "manifest.json"))
        or _retained_manifests(path))
    if not has_any:
        if init is None:
            raise FileNotFoundError(
                "no checkpoint under %s and no init() provided" % path)
        return init()
    cfg, params, momentum, step, meta = load_checkpoint(
        path, mesh=mesh, device=device)
    _validate_manifest_compat(path, cfg, meta, expect_world,
                              expect_generation, expect_cfg)
    return _finish_train_state(cfg, params, momentum, step)


def _validate_manifest_compat(path, cfg, meta, expect_world,
                              expect_generation, expect_cfg):
    if expect_cfg is not None:
        saved = dataclasses.asdict(cfg)
        want = dataclasses.asdict(expect_cfg)
        for field in sorted(saved):
            if saved[field] != want.get(field):
                raise CheckpointIncompatible(
                    "checkpoint %s: config.%s is %r but this run was "
                    "built with %r — refusing to resume a different "
                    "model" % (path, field, saved[field], want.get(field)))
    elastic = (meta or {}).get("elastic") or {}
    if expect_world is not None and "world" in elastic \
            and int(elastic["world"]) != int(expect_world):
        raise CheckpointIncompatible(
            "checkpoint %s: saved by a world of %s but resuming at world "
            "%s — merge the elastic shard set (resume_elastic) or restart "
            "the matching world" % (path, elastic["world"], expect_world))
    if expect_generation is not None and "generation" in elastic \
            and int(elastic["generation"]) > int(expect_generation):
        raise CheckpointIncompatible(
            "checkpoint %s: saved at elastic generation %s, newer than the "
            "launching generation %s — stale rendezvous record"
            % (path, elastic["generation"], expect_generation))


def _finish_train_state(cfg, params, momentum, step):
    """Shared tail of the resume paths: refuse serving-only int8 trees
    (as JAX does), zero-init momentum when none was saved."""
    from .transformer import _is_q8
    if _is_q8(params):
        raise ValueError(
            "checkpoint holds int8-quantized weights — a serving "
            "artifact, not a resumable training state; quantization "
            "discards the fp weights SGD needs. Load it with "
            "load_checkpoint() and serve it.")
    if momentum is None:
        from .transformer import init_momentum
        momentum = init_momentum(params)
    return cfg, params, momentum, step


# ------------------------------------------------ emergency checkpoint --

_emergency_lock = threading.Lock()
_emergency = {"path": None, "state": None, "keep": 2,
              "prev_sigterm": None, "sigterm": False,
              "prev_sigint": None, "sigint": False,
              "atexit": False, "fired": False}


def save_emergency_checkpoint(reason="emergency"):
    """One best-effort SYNCHRONOUS save of the registered training state
    (after any in-flight async save). Returns the path, or None when no
    provider is installed."""
    with _emergency_lock:
        path, state, keep = (_emergency["path"], _emergency["state"],
                             _emergency["keep"])
    if path is None or state is None:
        return None
    st = state()
    meta = dict(st.get("metadata") or {})
    meta["emergency"] = str(reason)
    for extra in ("cursor", "rng"):
        if st.get(extra) is not None:
            meta.setdefault(extra, st[extra])
    save_checkpoint(path, st["cfg"], st["params"],
                    momentum=st.get("momentum"),
                    step=int(st.get("step", 0)), metadata=meta, keep=keep)
    return path


def _sigterm_handler(signum, frame):
    with _emergency_lock:
        prev = _emergency["prev_sigterm"]
        _emergency["fired"] = True
    try:
        p = save_emergency_checkpoint("sigterm")
        if p:
            print("mxnet_tpu_torch.checkpoint: SIGTERM — emergency "
                  "checkpoint committed to %s" % p, flush=True)
    except Exception:  # noqa: BLE001 — last gasp: report, then go down
        traceback.print_exc()
    if callable(prev):
        prev(signum, frame)
        return
    raise SystemExit(143)            # 128 + SIGTERM


def _sigint_handler(signum, frame):
    """A SIGINT is a preemption notice too: one best-effort save, then
    the conventional 130 exit, chaining a non-default previous
    handler."""
    with _emergency_lock:
        prev = _emergency["prev_sigint"]
        _emergency["fired"] = True
    try:
        p = save_emergency_checkpoint("sigint")
        if p:
            print("mxnet_tpu_torch.checkpoint: SIGINT — emergency "
                  "checkpoint committed to %s" % p, flush=True)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
    if callable(prev) and prev is not signal.default_int_handler:
        prev(signum, frame)
        return
    raise SystemExit(130)            # 128 + SIGINT


def _atexit_pass():
    """Best-effort final save at interpreter exit, skipped when a signal
    path already saved, the provider was uninstalled, the world has more
    than one rank (a save there is a collective), or the current step is
    the last one committed."""
    with _emergency_lock:
        armed = _emergency["path"] is not None \
            and _emergency["state"] is not None \
            and not _emergency["fired"]
        state = _emergency["state"]
        last = _last_committed_step[0]
    if not armed:
        return
    try:
        if _world()[0] > 1:
            return
        st = state()
        if last is not None and int(st.get("step", -1)) == last:
            return
        save_emergency_checkpoint("atexit")
    except Exception:  # noqa: BLE001 — exit paths never raise
        traceback.print_exc()


def install_emergency_checkpoint(path, state, keep=2, on_sigterm=True,
                                 on_watchdog=True, on_sigint=True,
                                 atexit_pass=True):
    """Arm emergency checkpointing: ``state()`` returns a dict with
    ``cfg``/``params`` (and optionally ``momentum``/``step``/
    ``metadata``) holding the CURRENT training state. ``on_sigterm``: a
    SIGTERM saves once and exits 143 (chaining a previous handler);
    ``on_sigint`` the same for SIGINT (exit 130); ``atexit_pass`` saves
    once at interpreter exit for the step the cadence missed.
    ``on_watchdog`` is accepted for the JAX signature: the collective-hang
    watchdog comes with ROADMAP item A10."""
    with _emergency_lock:
        _emergency["path"] = path
        _emergency["state"] = state
        _emergency["keep"] = int(keep)
        _emergency["fired"] = False
    if on_sigterm:
        try:
            prev = signal.signal(signal.SIGTERM, _sigterm_handler)
            with _emergency_lock:
                if prev is not _sigterm_handler:
                    _emergency["prev_sigterm"] = prev
                _emergency["sigterm"] = True
        except ValueError:           # not the main thread
            warnings.warn(
                "mxnet_tpu_torch.checkpoint: SIGTERM handler not installed "
                "(not on the main thread)", RuntimeWarning, stacklevel=2)
    if on_sigint:
        try:
            prev = signal.signal(signal.SIGINT, _sigint_handler)
            with _emergency_lock:
                if prev is not _sigint_handler:
                    _emergency["prev_sigint"] = prev
                _emergency["sigint"] = True
        except ValueError:
            pass
    if atexit_pass:
        with _emergency_lock:
            need = not _emergency["atexit"]
            _emergency["atexit"] = True
        if need:
            atexit.register(_atexit_pass)
    return path


def uninstall_emergency_checkpoint():
    """Disarm: restore the previous SIGTERM/SIGINT dispositions and drop
    the provider (the atexit registration stays but does nothing)."""
    with _emergency_lock:
        prev = _emergency["prev_sigterm"]
        prev_int = _emergency["prev_sigint"]
        had_sig = _emergency["sigterm"]
        had_int = _emergency["sigint"]
        _emergency.update({"path": None, "state": None,
                           "prev_sigterm": None, "sigterm": False,
                           "prev_sigint": None, "sigint": False,
                           "fired": False})
    if had_sig:
        try:
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)
        except ValueError:
            pass
    if had_int:
        try:
            signal.signal(signal.SIGINT,
                          prev_int if prev_int is not None
                          else signal.default_int_handler)
        except ValueError:
            pass
