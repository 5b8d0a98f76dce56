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
``transformer.shard_params`` (each rank's block).

**Elastic shard sets** (:func:`save_shard_checkpoint` through
:func:`resume_elastic`) are the JAX package's too: one
``shard-arrays-g<g>-r<r>of<w>-<stamp>.npz`` and
``shard-manifest-g<g>-r<r>of<w>.json`` per survivor, with the replicated
parameters, the rank's slice of every flat momentum lane
(:func:`shard_layout`, ``fusion.plan_buckets`` over the momentum), the
data cursor and the RNG snapshot, so a set either package wrote merges
in the other. A shard save is collective-free: on the GPU it copies the
tensors into pinned host memory on a stream of its own that waits only
for the ``ready`` event of the step they belong to (:func:`_local_values`).
Not ported: the memory budget's snapshot admission and the
collective-hang watchdog's escalation hook (ROADMAP A10).
"""

import atexit
import collections
import dataclasses
import gc
import json
import os
import signal
import threading
import time
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
    params, momentum = _state_from_flat(path, cfg, flat,
                                        manifest["has_momentum"], mesh, device)
    return cfg, params, momentum, int(manifest["step"]), \
        manifest.get("metadata", {})


def _state_from_flat(path, cfg, flat, has_momentum, mesh, device):
    """(params, momentum) from verified flat arrays {key: (numpy array,
    dtype name)}: a TransformerLM on ``device`` (or each rank's block of
    it under ``mesh``) and the momentum dict by parameter name, or
    None."""
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
    if has_momentum:
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
    return params, momentum


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


# ------------------------------------------- elastic shard checkpoints --
#
# A *shard set* is one per-rank checkpoint per survivor of an elastic
# generation: the replicated parameters (every rank carries them: any one
# readable copy restores), this rank's contiguous slice of each flat
# momentum lane, the data cursor and the RNG snapshot. The lane layout is
# `fusion.plan_buckets` over the momentum in sorted-key order, each lane
# padded to a multiple of the world as `ShardSlot` pads it, so any two
# ranks compute the same layout from the same state. Merge-on-load
# reassembles the full lanes from the recorded layout, not from a replan,
# so a relaunch under other bucket settings still loads; re-partitioning
# for another world is the next save's replan over the merged state.

_SHARD_FORMAT = "mxnet_tpu.transformer.shard/1"

# what the last shard save of this process cost: the host copies (ms),
# the write (ms) and the bytes of its data file
_last_shard = {"capture_ms": None, "write_ms": None, "bytes": None}


def _np_dtype(name):
    """The numpy dtype of a dtype name on disk: bf16 as 2-byte void
    records, as the JAX package writes it."""
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _leaf_dtype(x):
    if torch.is_tensor(x):
        return _dtype_name(x)
    return np.dtype(getattr(x, "dtype", np.float32)).name


# pinned host buffers reserved for a later capture, by (shape, dtype),
# and the capture's side stream of each device
_host_pool = {}
_capture_streams = {}
_host_pool_lock = threading.Lock()


def _reserve_host_buffers(tensors):
    """Pin host buffers now for the copies a later :func:`_local_values`
    makes of these CUDA tensors, and make its side stream on their
    device, so that the capture neither pins memory nor makes a stream
    while the device is blocked. On the H100 the process's first
    ``torch.cuda.Stream``, made while another thread waited on the device
    behind a spinning kernel, waited until that wait ended; copies on a
    stream made beforehand did not. The elastic coordinator reserves at
    the training loop's first step boundary. Returns the buffers
    reserved."""
    tensors = [t for t in tensors if torch.is_tensor(t) and t.is_cuda]
    wanted = collections.Counter((tuple(t.shape), t.dtype) for t in tensors)
    with _host_pool_lock:
        for dev in {t.device for t in tensors}:
            if dev not in _capture_streams:
                _capture_streams[dev] = torch.cuda.Stream(device=dev)
        for (shape, dtype), n in wanted.items():
            have = _host_pool.setdefault((shape, dtype), [])
            while len(have) < n:
                have.append(torch.empty(shape, dtype=dtype, pin_memory=True))
    return sum(n for n in wanted.values())


def _host_buffer(t):
    """(a pinned buffer for ``t``'s copy, whether it came from the
    reserved pool)."""
    with _host_pool_lock:
        have = _host_pool.get((tuple(t.shape), t.dtype))
        if have:
            return have.pop(), True
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True), False


def _return_host_buffers(bufs):
    with _host_pool_lock:
        for buf in bufs:
            _host_pool.setdefault((tuple(buf.shape), buf.dtype), []).append(
                buf)


def _local_values(flat, ready=None):
    """Host copies of every leaf of ``flat`` ({key: tensor or numpy
    array}) without a collective: ``({key: numpy array}, {key: dtype
    name}, [pooled buffers])``.

    The elastic capture calls this from the monitor thread while the
    main thread may be blocked in an all-reduce whose peer is dead. A
    ``.cpu()`` there would queue its copy on the compute stream behind
    that all-reduce and never finish, and a copy into pageable memory
    waits for the device too, even on another stream. So each device's
    tensors are copied into pinned host memory on a stream of their own
    that waits only for ``ready`` (the CUDA event the training loop
    recorded after the step these tensors belong to; without one, for the
    work queued so far on the calling thread's current stream), and only
    that stream is synchronized.

    On the H100 such copies finished while another thread waited on the
    device behind the hung kernel (in ``float(loss)`` or
    ``torch.cuda.synchronize()``), on a stream made before that wait
    (:func:`_reserve_host_buffers` makes it, and pins the buffers, at the
    training loop's first step boundary). The buffers taken from that
    pool are listed in the third value, for the caller to hand back
    (``_return_host_buffers``) once the arrays are written."""
    host, dtypes, sides, pooled = {}, {}, {}, []
    for key, x in flat.items():
        if isinstance(x, np.ndarray):
            host[key], dtypes[key] = x, x.dtype.name
            continue
        t = x.detach()
        dtypes[key] = _dtype_name(t)
        if not t.is_cuda:
            host[key] = t
            continue
        side = sides.get(t.device)
        if side is None:
            with _host_pool_lock:
                side = _capture_streams.get(t.device)
            side = sides[t.device] = side or torch.cuda.Stream(
                device=t.device)
            if ready is not None:
                side.wait_event(ready)
            else:
                side.wait_stream(torch.cuda.current_stream(t.device))
        buf, from_pool = _host_buffer(t)
        if from_pool:
            pooled.append(buf)
        with torch.cuda.stream(side):
            buf.copy_(t, non_blocking=True)
        host[key] = buf
    for side in sides.values():
        side.synchronize()
    return ({k: v if isinstance(v, np.ndarray) else _to_numpy(v)
             for k, v in host.items()}, dtypes, pooled)


def _momentum_flat(momentum):
    """{"m.<name>": leaf} of a momentum dict by parameter name."""
    return {_MOMENTUM + _SEP + n: m for n, m in momentum.items()}


def shard_layout(momentum, world):
    """Deterministic lane layout for sharding a momentum dict (by
    parameter name, tensors or numpy arrays) over ``world`` ranks:
    ``fusion.plan_buckets`` over the flattened leaves in sorted-key
    order, each lane padded so ``world`` divides it. Returns
    ``{"signature", "world", "lanes": [{bucket, lane, dtype, size, l_pad,
    segments}]}``, segments as ``[key, shape, size, offset]``: the JAX
    package's layout for the same tree."""
    from ..parallel import fusion
    flat = _momentum_flat(momentum)
    entries = [(k, tuple(int(d) for d in np.shape(flat[k])),
                _leaf_dtype(flat[k])) for k in sorted(flat)]
    plan = fusion.plan_buckets(entries)
    sig = "%08x" % (zlib.crc32(
        repr(fusion.plan_signature(entries)).encode()) & 0xFFFFFFFF)
    world = int(world)
    lanes = []
    for bucket in plan:
        for li, lane in enumerate(bucket.lanes):
            l_pad = -(-lane.size // world) * world
            lanes.append({
                "bucket": bucket.index, "lane": li,
                "dtype": str(lane.dtype), "size": lane.size,
                "l_pad": l_pad,
                "segments": [[s.key, list(s.shape), s.size, s.offset]
                             for s in lane.segments]})
    return {"signature": sig, "world": world, "lanes": lanes}


def _lane_key(lane):
    return "ms.%d.%d" % (lane["bucket"], lane["lane"])


def _pack_lane_host(lane, flat):
    """Host-side pack: the lane's segments raveled back to back, zero
    padded to ``l_pad`` (the numpy twin of ``fusion.pack_lane``)."""
    dt = _np_dtype(lane["dtype"])
    out = np.zeros(lane["l_pad"], dt)
    for key, _shape, size, offset in lane["segments"]:
        out[offset:offset + size] = np.ravel(
            np.asarray(flat[key])).astype(dt, copy=False)
    return out


def _shard_manifest_name(generation, rank, world):
    return "shard-manifest-g%d-r%dof%d.json" % (generation, rank, world)


def save_shard_checkpoint(path, cfg, params, momentum=None, step=0,
                          rank=0, world=1, generation=0, cursor=None,
                          rng=None, base_world=None, metadata=None,
                          keep_generations=None, ready=None):
    """One survivor's shard of an elastic generation's state.

    Writes ``shard-arrays-g<g>-r<r>of<w>-<stamp>.npz`` and its manifest:
    the parameters (a TransformerLM) in full, the momentum (a dict by
    parameter name) as THIS rank's slice of every flat lane
    (``shard_layout(momentum, world)``), the iterator ``cursor`` (a JSON
    ``state_dict()``), the ``rng`` snapshot, and the layout itself, so
    merge-on-load never replans. Collective-free (see
    :func:`_local_values`; ``ready`` is the CUDA event after which the
    tensors hold this step's values), so it runs from a monitor thread
    while the main thread is blocked. Keeps the newest
    ``keep_generations`` complete shard generations (default 2)."""
    keep_generations = 2 if keep_generations is None else keep_generations
    os.makedirs(path, exist_ok=True)
    rank, world = int(rank), int(world)
    if not 0 <= rank < world:
        raise ValueError("shard rank %d outside world %d" % (rank, world))
    t0 = time.perf_counter()
    flat = _flatten(params, None)
    if momentum is not None:
        flat.update(_momentum_flat(momentum))
    values, dtypes, pinned = _local_values(flat, ready)
    capture_ms = 1e3 * (time.perf_counter() - t0)
    try:
        _write_shard(path, cfg, values, dtypes, momentum, step, rank, world,
                     generation, cursor, rng, base_world, metadata, t0,
                     capture_ms)
    finally:
        del values
        _return_host_buffers(pinned)
    _sweep_shards(path, keep_generations)
    return path


def _write_shard(path, cfg, values, dtypes, momentum, step, rank, world,
                 generation, cursor, rng, base_world, metadata, t0,
                 capture_ms):
    host = {k: v for k, v in values.items()
            if k.startswith(_PARAMS + _SEP)}
    dtypes = {k: dtypes[k] for k in host}
    layout = None
    if momentum is not None:
        layout = shard_layout(momentum, world)
        host_m = {k: v for k, v in values.items()
                  if k.startswith(_MOMENTUM + _SEP)}
        for lane in layout["lanes"]:
            packed = _pack_lane_host(lane, host_m)
            n = lane["l_pad"] // world
            host[_lane_key(lane)] = packed[rank * n:(rank + 1) * n]
            dtypes[_lane_key(lane)] = lane["dtype"]
    stamp = "%d-%s" % (int(step), os.urandom(4).hex())
    arrays_file = "shard-arrays-g%d-r%dof%d-%s.npz" % (generation, rank,
                                                       world, stamp)
    manifest = {
        "format": _SHARD_FORMAT,
        "config": _cfg_to_json(cfg),
        "generation": int(generation), "world": world, "rank": rank,
        "base_world": int(world if base_world is None else base_world),
        "step": int(step),
        "has_momentum": momentum is not None,
        "layout": layout,
        "arrays_file": arrays_file,
        "dtypes": dtypes,
        "arrays": sorted(host),
        "checksums": {k: _crc(v) for k, v in host.items()},
        "param_fingerprint": _param_fingerprint(host, dtypes),
        "cursor": cursor, "rng": rng,
        "metadata": metadata or {},
    }
    manifest_text = json.dumps(manifest, indent=1, sort_keys=True)
    tmp = os.path.join(path, "." + arrays_file + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, os.path.join(path, arrays_file))
    _chaos.fire("checkpoint.write", path=path, step=int(step), shard=rank)
    name = _shard_manifest_name(generation, rank, world)
    tmp = os.path.join(path, "." + name + ".tmp")
    with open(tmp, "w") as f:
        f.write(manifest_text)
    os.replace(tmp, os.path.join(path, name))     # the commit point
    _last_committed_step[0] = int(step)
    _last_shard.update(
        capture_ms=capture_ms,
        write_ms=1e3 * (time.perf_counter() - t0) - capture_ms,
        bytes=os.path.getsize(os.path.join(path, arrays_file)))


def _shard_manifests(path):
    """[(generation, rank, world, manifest dict, name)] for every readable
    shard manifest under ``path``."""
    out = []
    if not os.path.isdir(path):
        return out
    for name in os.listdir(path):
        if not (name.startswith("shard-manifest-")
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(path, name)) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        if m.get("format") != _SHARD_FORMAT:
            continue
        out.append((int(m.get("generation", -1)), int(m.get("rank", -1)),
                    int(m.get("world", 0)), m, name))
    out.sort(key=lambda e: (e[0], e[1]))
    return out


def list_shard_generations(path):
    """Complete shard generations under ``path``, oldest first:
    [(generation, step, world)] where every rank 0..world-1 committed a
    manifest and all agree on the step."""
    by_gen = {}
    for gen, rank, world, m, _name in _shard_manifests(path):
        by_gen.setdefault(gen, []).append((rank, world, m))
    out = []
    for gen in sorted(by_gen):
        entries = by_gen[gen]
        worlds = {w for _r, w, _m in entries}
        steps = {int(m.get("step", -1)) for _r, _w, m in entries}
        ranks = {r for r, _w, _m in entries}
        if len(worlds) == 1 and len(steps) == 1 \
                and ranks == set(range(next(iter(worlds)))):
            out.append((gen, next(iter(steps)), next(iter(worlds))))
    return out


def _sweep_shards(path, keep_generations):
    """Retention for shard sets: keep the newest ``keep_generations``
    COMPLETE generations (and any incomplete newer one: a set the other
    survivors are still writing is not garbage); drop older manifests
    and their data files."""
    keep_generations = max(int(keep_generations), 1)
    complete = [g for g, _s, _w in list_shard_generations(path)]
    if not complete:
        return
    keep_from = complete[-keep_generations] \
        if len(complete) >= keep_generations else complete[0]
    for gen, _rank, _world, m, name in _shard_manifests(path):
        if gen >= keep_from:
            continue
        for stale in (name, m.get("arrays_file")):
            if not stale:
                continue
            try:
                os.remove(os.path.join(path, stale))
            except OSError:
                pass


def _check_same(field, values, path):
    distinct = sorted(set(values), key=str)
    if len(distinct) > 1:
        raise CheckpointIncompatible(
            "shard set %s: ranks disagree on %s (%s) — refusing to merge a "
            "mixed set" % (path, field, distinct))
    return distinct[0]


def load_shard_checkpoint(path, mesh=None, generation=None,
                          allow_partial=False, device=None):
    """Merge-on-load of one shard generation: ``(cfg, params, momentum,
    step, extras)``, params a TransformerLM on ``device`` (or each rank's
    block under ``mesh``), momentum the dict by parameter name, extras
    ``generation``, ``world``, ``base_world``, ``cursor``, ``rng`` and
    ``metadata``.

    Takes the newest COMPLETE generation (or ``generation``), verifies
    every rank's arrays against its manifest's digests, reassembles the
    full momentum lanes from the recorded layout, and restores the
    parameters from the lowest readable rank's copy. A mixed or
    incomplete set raises :class:`CheckpointIncompatible` naming the
    field or the missing ranks; with ``allow_partial=True`` a missing or
    unreadable rank's lane slices are zero-filled, with a warning."""
    sets = {}
    for gen, rank, world, m, name in _shard_manifests(path):
        sets.setdefault(gen, {})[rank] = (m, name)
    if not sets:
        raise FileNotFoundError("no shard manifests under %s" % path)
    if generation is None:
        complete = [g for g, _s, _w in list_shard_generations(path)]
        generation = complete[-1] if complete else max(sets)
    if generation not in sets:
        raise CheckpointIncompatible(
            "shard set %s: no manifests for generation %s (have %s)"
            % (path, generation, sorted(sets)))
    ranks = sets[generation]
    world = _check_same("world size",
                        [m.get("world") for m, _n in ranks.values()], path)
    step = _check_same("step",
                       [m.get("step") for m, _n in ranks.values()], path)
    cfg_json = _check_same(
        "config", [json.dumps(m.get("config"), sort_keys=True)
                   for m, _n in ranks.values()], path)
    has_momentum = any(m.get("has_momentum") for m, _n in ranks.values())
    layouts = [m.get("layout") for m, _n in ranks.values()
               if m.get("layout") is not None]
    if layouts:
        _check_same("shard layout",
                    [l.get("signature") for l in layouts], path)
    missing = sorted(set(range(world)) - set(ranks))
    if missing and not allow_partial:
        raise CheckpointIncompatible(
            "shard set %s: generation %d is incomplete — missing rank(s) "
            "%s of world %d (pass allow_partial=True to zero-fill their "
            "optimizer slices)" % (path, generation, missing, world))
    # each rank's verified arrays; the parameters fall back across ranks,
    # and a rank lost to corruption degrades like a missing one
    arrays, errors = {}, []
    for rank in sorted(ranks):
        m, name = ranks[rank]
        try:
            arrays[rank] = _read_arrays(path, m, name)
        except CheckpointCorrupt as e:
            errors.append(e)
            if not allow_partial:
                raise
            warnings.warn(
                "mxnet_tpu_torch.checkpoint: %s — zero-filling rank %d's "
                "optimizer slices" % (e, rank), RuntimeWarning, stacklevel=2)
    if not arrays:
        raise errors[0] if errors else CheckpointCorrupt(
            "shard set %s: no readable rank" % path)
    if missing:
        warnings.warn(
            "mxnet_tpu_torch.checkpoint: shard generation %d missing "
            "rank(s) %s — their optimizer slices resume as zeros"
            % (generation, missing), RuntimeWarning, stacklevel=2)
    first = min(arrays)
    pref = _PARAMS + _SEP
    want_fp = ranks[first][0].get("param_fingerprint")
    if want_fp is not None:
        got_fp = _fingerprint_of(arrays[first])
        if got_fp != want_fp:
            raise CheckpointCorrupt(
                "shard set %s: rank %d parameter fingerprint %s does not "
                "match manifest %s — refusing unverified weights"
                % (path, first, got_fp, want_fp))
    flat = {k: v for k, v in arrays[first].items() if k.startswith(pref)}
    has_m = has_momentum and bool(layouts)
    if has_m:
        for lane in layouts[0]["lanes"]:
            key = _lane_key(lane)
            n = lane["l_pad"] // world
            full = np.zeros(lane["l_pad"], _np_dtype(lane["dtype"]))
            for rank in range(world):
                got = arrays.get(rank, {}).get(key)
                if got is None:
                    continue
                got = got[0]
                if got.shape != (n,):
                    raise CheckpointIncompatible(
                        "shard set %s: rank %d lane %s slice has shape %s, "
                        "layout says (%d,) — layout/world mismatch"
                        % (path, rank, key, got.shape, n))
                full[rank * n:(rank + 1) * n] = got
            for skey, shape, size, offset in lane["segments"]:
                flat[skey] = (full[offset:offset + size].reshape(shape),
                              lane["dtype"])
    cfg = _cfg_from_json(json.loads(cfg_json))
    if mesh is None:
        device = resolve_device(device)
    params, momentum = _state_from_flat(path, cfg, flat, has_m, mesh,
                                        device)
    m0 = ranks[first][0]
    extras = {"generation": int(generation), "world": int(world),
              "base_world": int(m0.get("base_world", world)),
              "cursor": m0.get("cursor"), "rng": m0.get("rng"),
              "metadata": m0.get("metadata", {})}
    return cfg, params, momentum, int(step), extras


def resume_elastic(path, mesh=None, init=None, expect_world=None,
                   expect_generation=None, allow_partial=False,
                   generation=None, device=None):
    """The elastic worker's resume: the newest usable state — a shard set
    or a full checkpoint, whichever carries the LATER step (a tie goes to
    the shard set, which also carries the cursor). Returns ``(cfg,
    params, momentum, step, extras)``; ``extras`` is ``{}`` from a full
    checkpoint without cursor or RNG, or from ``init()``.

    ``expect_generation`` refuses a shard set from a generation NEWER
    than the one launching (a stale rendezvous record);
    ``expect_world`` refuses a momentum-less set recorded for another
    world; both raise :class:`CheckpointIncompatible` naming the
    mismatch. An explicit ``generation`` pins the resume to that shard
    set (the exact-comparison harness's entry point)."""
    wait_for_pending_save()
    shard_gens = list_shard_generations(path) if os.path.isdir(path) \
        else []
    if generation is not None:
        shard_gens = [e for e in shard_gens if e[0] == int(generation)]
        if not shard_gens:
            raise CheckpointIncompatible(
                "no complete shard set for generation %s under %s"
                % (generation, path))
    full = list_checkpoints(path) if generation is None else []
    shard_step = shard_gens[-1][1] if shard_gens else None
    full_step = full[-1][0] if full else None
    if shard_step is not None and (full_step is None
                                   or shard_step >= full_step):
        gen = shard_gens[-1][0]
        if expect_generation is not None and gen > int(expect_generation):
            raise CheckpointIncompatible(
                "shard set %s: newest generation %d is AHEAD of the "
                "launching generation %d — the supervisor is reading a "
                "stale rendezvous record" % (path, gen,
                                             int(expect_generation)))
        try:
            out = load_shard_checkpoint(path, mesh=mesh, generation=gen,
                                        allow_partial=allow_partial,
                                        device=device)
        except CheckpointIncompatible:
            raise
        except CheckpointCorrupt as e:
            # an unverifiable shard set must not serve the resume: fall
            # through to the newest verified full checkpoint
            if not full:
                raise
            warnings.warn(
                "mxnet_tpu_torch.checkpoint: %s — falling back to the "
                "newest verified full checkpoint" % e,
                RuntimeWarning, stacklevel=2)
        else:
            if expect_world is not None and out[4]["world"] != int(
                    expect_world) and out[2] is None:
                raise CheckpointIncompatible(
                    "shard set %s: recorded world %d cannot serve world %d "
                    "(no optimizer lanes to re-partition)"
                    % (path, out[4]["world"], int(expect_world)))
            cfg, params, momentum, step, extras = out
            if momentum is None:
                from .transformer import init_momentum
                momentum = init_momentum(params)
            return cfg, params, momentum, step, extras
    if full:
        cfg, params, momentum, step, meta = load_checkpoint(
            path, mesh=mesh, device=device)
        cfg, params, momentum, step = _finish_train_state(
            cfg, params, momentum, step)
        extras = {k: meta[k] for k in ("cursor", "rng")
                  if (meta or {}).get(k) is not None}
        return cfg, params, momentum, step, extras
    if init is None:
        raise FileNotFoundError(
            "no checkpoint under %s and no init() provided" % path)
    out = init()
    return tuple(out) + ({},) if len(out) == 4 else out


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


def _prune_stale_sideband():
    """Drop the heartbeat, shrink and watchdog files of previous elastic
    generations, so a relaunch never reads a dead generation's membership
    as live. No-op outside an elastic run."""
    try:
        from ..parallel import elastic
        d = elastic.elastic_dir()
        if d:
            elastic.prune_stale(d, elastic.generation_env())
    except Exception:  # noqa: BLE001 — best-effort hygiene only
        pass


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
    watchdog comes with ROADMAP item A10. Installing also prunes the
    stale sideband files of previous elastic generations
    (``parallel.elastic.prune_stale``)."""
    with _emergency_lock:
        _emergency["path"] = path
        _emergency["state"] = state
        _emergency["keep"] = int(keep)
        _emergency["fired"] = False
    _prune_stale_sideband()
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
