"""Sharded checkpoints with reshard-on-load (counterpart of
``paddle_tpu/distributed/checkpoint.py``; Paddle's auto-parallel
``DistributedSaver``).

The on-disk layout is the reference's, so either package loads the
other's checkpoint (f32 state; see below for bf16):

- ``shards.<rank>.pkl``: a pickled ``{name: {index_key: ndarray}}`` of the
  boxes this rank writes, ``index_key`` being the box's global extent
  ``"start-stop_start-stop"`` (``"scalar"`` for a 0-d array);
- ``meta.json``: ``process_count`` and, per array, its global ``shape``,
  ``dtype`` and ``spec`` (per dim, the mesh axis that shards it);
- ``extra.pkl``: small host state (step counts);
- ``manifest.<rank>.json``, written last by each rank: a CRC32 and a size
  per file it wrote.

Each rank holds local tensors; a :class:`Placement` says where a local
tensor's boxes sit in the global array (a tensor-parallel shard, a ZeRO
slice, a fused ``qkv`` column split into several boxes). A box that
several ranks hold (replicas over dp, say) is written by one of them.
Loading assembles each global array from every rank's file and hands
each rank its own boxes of it, whatever mesh saved it: reshard-on-load.

Durability: every rank writes into one staging directory; rank 0 waits
(on the file system, no collective, so an async save never interleaves
with training's collectives) for every rank's manifest of this save,
writes ``meta.json`` / ``extra.pkl`` / its manifest and publishes the
directory with one atomic rename. A writer killed at any point leaves
the previous snapshot or the new one. :class:`Checkpoint` keeps N
snapshots and loads the newest one that validates, falling back past
torn or corrupt ones. Fault sites ``ckpt.shard`` / ``ckpt.meta``; the
``ckpt_*`` telemetry families and events are the reference's.

bf16: numpy has no bfloat16, so a bf16 box is stored as its raw 16 bits
(``uint16``) under dtype ``"bfloat16"`` and read back as bf16, never as
an integer.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from .. import telemetry
from ..analysis import locksan
from ..utils import faults

__all__ = ["DistributedSaver", "Checkpoint", "CheckpointCorrupt",
           "Placement", "validate_checkpoint", "layer_placements",
           "load_logical_state", "restore_local",
           "save_distributed_checkpoint", "load_distributed_checkpoint"]


def _ckpt_metrics():
    reg = telemetry.registry()
    return (
        reg.histogram("ckpt_save_seconds",
                      "checkpoint write wall time (staging to publish)"),
        reg.histogram("ckpt_load_seconds",
                      "checkpoint load wall time (validate to assemble)"),
        reg.counter("ckpt_bytes_written_total",
                    "bytes committed to published snapshots"),
        reg.counter("ckpt_fallbacks_total",
                    "torn/corrupt snapshots skipped during load"),
        reg.gauge("ckpt_last_save_unixtime",
                  "wall time of the last committed snapshot"),
    )


_M_SAVE_S, _M_LOAD_S, _M_BYTES, _M_FALLBACKS, _M_LAST_SAVE = _ckpt_metrics()


class CheckpointCorrupt(RuntimeError):
    """A snapshot failed validation (missing files, checksum mismatch)."""


class Placement:
    """Where a local tensor sits in its global array: ``boxes`` of
    ``(local_start, global_start, size)`` per dim, and the mesh ``axes``
    over which ranks hold different boxes (a rank writes a box only when
    its coordinate on every other axis is 0). ``spec`` is the per-dim
    axis list recorded in the metadata."""

    def __init__(self, global_shape, boxes=None, axes=(), spec=None):
        self.global_shape = tuple(int(s) for s in global_shape)
        n = len(self.global_shape)
        self.boxes = boxes if boxes is not None else [
            ((0,) * n, (0,) * n, self.global_shape)]
        self.axes = frozenset(axes)
        self.spec = list(spec) if spec is not None else [None] * n

    @classmethod
    def offset(cls, global_shape, local_shape, dim, start, axis):
        """A local tensor that is ``global[start:start + len]`` on ``dim``
        (sharded over ``axis``)."""
        n = len(global_shape)
        g0 = [0] * n
        g0[dim] = start
        spec = [None] * n
        spec[dim] = axis
        return cls(global_shape, [((0,) * n, tuple(g0), tuple(local_shape))],
                   axes=(axis,), spec=spec)

    def narrow(self, dim, start, length, axis):
        """The placement of ``local.narrow(dim, start, length)`` (a ZeRO
        slice over ``axis``)."""
        boxes = []
        for l0, g0, size in self.boxes:
            lo = max(l0[dim], start)
            hi = min(l0[dim] + size[dim], start + length)
            if hi <= lo:
                continue
            nl, ng, ns = list(l0), list(g0), list(size)
            nl[dim] = lo - start
            ng[dim] = g0[dim] + (lo - l0[dim])
            ns[dim] = hi - lo
            boxes.append((tuple(nl), tuple(ng), tuple(ns)))
        spec = list(self.spec)
        spec[dim] = axis if spec[dim] is None else [spec[dim], axis]
        return Placement(self.global_shape, boxes, self.axes | {axis}, spec)

    def pieces(self, local):
        """``(index_key, global_slices, local_view)`` per box."""
        for l0, g0, size in self.boxes:
            lsl = tuple(slice(a, a + s) for a, s in zip(l0, size))
            gsl = tuple(slice(a, a + s) for a, s in zip(g0, size))
            key = ("_".join(f"{a}-{a + s}" for a, s in zip(g0, size))
                   if size else "scalar")
            yield key, gsl, local[lsl] if size else local


def _writes(placement, coords) -> bool:
    return all(c == 0 for a, c in coords.items()
               if a not in placement.axes)


_BF16 = "bfloat16"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return _BF16
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        if a.dtype.itemsize != 2:
            raise CheckpointCorrupt(
                f"a bfloat16 array stored as {a.dtype}; expected its raw "
                f"16 bits")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


_SAVE_SEQ = [0]

# one in-flight async write per checkpoint directory
_PENDING_WRITES: dict[str, threading.Thread] = {}
_PENDING_ERRORS: dict[str, BaseException] = {}
_PENDING_LOCK = locksan.Lock("checkpoint.pending")


def _wait_path(path, reraise=False):
    key = os.path.abspath(path)
    with _PENDING_LOCK:
        t = _PENDING_WRITES.pop(key, None)
    if t is not None:
        t.join()
    with _PENDING_LOCK:
        err = _PENDING_ERRORS.pop(key, None)
    if err is not None and reraise:
        raise RuntimeError(
            f"async checkpoint write to '{path}' failed; the snapshot was "
            f"NOT committed") from err


def _crc32_file(fp: str) -> int:
    crc = 0
    with open(fp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _atomic_write(fp: str, write_fn):
    tmp = fp + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fp)


def _manifest_name(rank: int) -> str:
    return f"manifest.{rank}.json"


def validate_checkpoint(path: str) -> list[str]:
    """Integrity check of one checkpoint directory; a list of problems
    (empty = good): ``meta.json`` parses, and every file of every
    manifest exists with its recorded size and CRC32."""
    problems = []
    if not os.path.isdir(path):
        return [f"not a directory: {path}"]
    try:
        with open(os.path.join(path, "meta.json")) as f:
            json.load(f)
    except FileNotFoundError:
        return ["meta.json missing (torn or foreign directory)"]
    except (json.JSONDecodeError, OSError) as e:
        return [f"meta.json unreadable: {e}"]
    manifests = [fn for fn in os.listdir(path)
                 if fn.startswith("manifest.") and fn.endswith(".json")]
    if not manifests:
        return ["no manifest.*.json (pre-manifest or torn write)"]
    for mf in sorted(manifests):
        try:
            with open(os.path.join(path, mf)) as f:
                entries = json.load(f)["files"]
        except (json.JSONDecodeError, OSError, KeyError) as e:
            problems.append(f"{mf} unreadable: {e}")
            continue
        for fn, want in entries.items():
            fp = os.path.join(path, fn)
            if not os.path.exists(fp):
                problems.append(f"{fn} listed in {mf} but missing")
                continue
            if os.path.getsize(fp) != want["size"]:
                problems.append(
                    f"{fn}: size {os.path.getsize(fp)} != recorded "
                    f"{want['size']} (truncated write)")
                continue
            if _crc32_file(fp) != want["crc32"]:
                problems.append(f"{fn}: CRC32 mismatch (corrupt)")
    return problems


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _world():
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _coords():
    from .mesh import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg.coords() if hcg is not None else {}


class DistributedSaver:
    """save / load of an owner's sharded state. The owner (a
    ``DistributedEngine`` or a ``LlamaPipelineTrainer``) gives
    ``_ckpt_items() -> {name: (local tensor, Placement)}`` and
    ``_ckpt_extra()``, and takes ``_ckpt_restore(full_arrays, extra)``."""

    def __init__(self, engine=None, publish_timeout_s=600.0):
        self.engine = engine
        self._pending = None
        self.publish_timeout_s = publish_timeout_s

    # -- save -----------------------------------------------------------
    def save(self, path, state=None, specs=None, extra=None,
             async_save=False):
        """Write this rank's boxes and (rank 0) the metadata under
        ``path``. ``state``: a nested dict of tensors or arrays (default:
        the owner's); every rank of the world calls ``save``."""
        if state is None:
            items = self.engine._ckpt_items()
            extra = {**self.engine._ckpt_extra(), **(extra or {})}
        else:
            items = {}
            for name, v in _flatten(state).items():
                t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    np.asarray(v))
                items[name] = (t, Placement(tuple(t.shape)))
        rank, world = _world()
        coords = _coords()
        meta = {"process_count": world, "arrays": {}}
        blobs = {}
        for name, (t, pl) in items.items():
            meta["arrays"][name] = {"shape": list(pl.global_shape),
                                    "dtype": _dtype_name(t),
                                    "spec": pl.spec}
            if not _writes(pl, coords):
                continue
            for key, _, view in pl.pieces(t.detach()):
                blobs.setdefault(name, {})[key] = _to_numpy(view)
        _wait_path(path, reraise=True)
        final = os.path.abspath(path)
        # every rank makes the same saves in the same order: the save's
        # sequence number and step tell this save's manifests from stale
        _SAVE_SEQ[0] += 1
        token = f"{_SAVE_SEQ[0]}:{(extra or {}).get('step_count', 0)}"

        def _write():
            t_start = time.monotonic()
            stage = final + ".tmp-save"
            os.makedirs(stage, exist_ok=True)
            mine = os.path.join(stage, _manifest_name(rank))
            if os.path.exists(mine):
                os.remove(mine)
            written = {}

            def put(fn, write_fn):
                fp = os.path.join(stage, fn)
                _atomic_write(fp, write_fn)
                written[fn] = {"crc32": _crc32_file(fp),
                               "size": os.path.getsize(fp)}

            try:
                faults.inject("ckpt.shard", rank=rank, path=path)
                put(f"shards.{rank}.pkl",
                    lambda f: pickle.dump(blobs, f, protocol=4))
                if rank == 0:
                    faults.inject("ckpt.meta", rank=rank, path=path)
                    put("meta.json",
                        lambda f: f.write(json.dumps(meta, indent=1)
                                          .encode()))
                    put("extra.pkl",
                        lambda f: pickle.dump(extra or {}, f, protocol=4))
                put(_manifest_name(rank),
                    lambda f: f.write(json.dumps(
                        {"files": dict(written), "token": token},
                        indent=1).encode()))
                if rank == 0:
                    self._await_manifests(stage, world, token)
                    if os.path.exists(final):
                        shutil.rmtree(final)
                    os.replace(stage, final)
                else:
                    # the save returns once rank 0 has published it
                    self._await_manifests(final, None, token, rank)
            except BaseException as e:
                if rank == 0:
                    shutil.rmtree(stage, ignore_errors=True)
                telemetry.record_event(
                    "ckpt.save_failed", path=final, rank=rank,
                    error=f"{type(e).__name__}: {e}")
                raise
            dur = time.monotonic() - t_start
            nbytes = sum(w["size"] for w in written.values())
            _M_SAVE_S.observe(dur)
            _M_BYTES.inc(nbytes)
            _M_LAST_SAVE.set(time.time())
            telemetry.record_event("ckpt.save", path=final, rank=rank,
                                   bytes=nbytes, seconds=round(dur, 4),
                                   async_save=async_save)

        if async_save:
            def _write_logged():
                try:
                    _write()
                except BaseException as e:  # lint: allow-silent(error surfaced by wait()/_wait_path)
                    with _PENDING_LOCK:
                        _PENDING_ERRORS[final] = e

            t = threading.Thread(target=_write_logged, daemon=False,
                                 name=f"ckpt-writer:{os.path.basename(final)}")
            with _PENDING_LOCK:
                _PENDING_WRITES[final] = t
            self._pending = (final, t)
            t.start()
        else:
            _write()

    def _await_manifests(self, stage, world, token, rank=None):
        """Wait until every rank's manifest of this save is in ``stage``
        (rank 0, before it publishes), or ``rank``'s is in the published
        directory (the others). The file system is the only channel, so
        an async save issues no collective."""
        deadline = time.monotonic() + self.publish_timeout_s
        ranks = range(world) if rank is None else [rank]
        while True:
            ready = 0
            for r in ranks:
                fp = os.path.join(stage, _manifest_name(r))
                try:
                    with open(fp) as f:
                        ready += json.load(f).get("token") == token
                except (OSError, json.JSONDecodeError):
                    pass
            if ready == len(ranks) and (
                    rank is None or
                    os.path.exists(os.path.join(stage, "meta.json"))):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint '{stage}': {ready} of {len(ranks)} "
                    f"manifests of this save within "
                    f"{self.publish_timeout_s}s")
            time.sleep(0.01)

    def wait(self):
        """Join an in-flight async save; re-raises its failure."""
        if self._pending is not None:
            _wait_path(self._pending[0], reraise=True)
            self._pending = None

    # -- load -----------------------------------------------------------
    def load(self, path, mesh=None, specs=None, wait_s=None):
        """Assemble the global arrays (numpy) of the checkpoint at
        ``path`` and, with an owner, restore its state from them onto the
        current mesh. Returns ``(state_tree, extra)``. A rank that did not
        publish the snapshot waits up to ``wait_s`` (default the publish
        timeout) for it to appear."""
        t_start = time.monotonic()
        _wait_path(path, reraise=True)
        deadline = time.monotonic() + (self.publish_timeout_s
                                       if wait_s is None else wait_s)
        while not os.path.exists(os.path.join(path, "meta.json")) and \
                time.monotonic() < deadline and \
                os.path.exists(os.path.abspath(path) + ".tmp-save"):
            time.sleep(0.01)
        problems = [p for p in validate_checkpoint(path)
                    if not p.startswith("no manifest")]
        if problems:
            raise CheckpointCorrupt(
                f"checkpoint '{path}' failed validation: "
                + "; ".join(problems))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        extra = {}
        extra_path = os.path.join(path, "extra.pkl")
        if os.path.exists(extra_path):
            with open(extra_path, "rb") as f:
                extra = pickle.load(f)
        merged: dict = {}
        for r in range(int(meta.get("process_count", 1))):
            fp = os.path.join(path, f"shards.{r}.pkl")
            if not os.path.exists(fp):
                continue
            with open(fp, "rb") as f:
                blob = pickle.load(f)
            for name, shards in blob.items():
                merged.setdefault(name, {}).update(shards)
        flat = {}
        for name, info in meta["arrays"].items():
            shape = tuple(info["shape"])
            dt = info["dtype"]
            shards = merged.get(name, {})
            if not shards:
                raise FileNotFoundError(
                    f"no shards found for '{name}' in {path}")
            full = np.empty(shape, np.uint16 if dt == _BF16 else
                            np.dtype(dt))
            covered = 0
            for key, data in shards.items():
                data = np.asarray(data)
                if key == "scalar":
                    full = np.asarray(data, full.dtype)
                    covered = 1
                    continue
                idx = tuple(slice(int(a), int(b)) for a, b in
                            (part.split("-") for part in key.split("_")))
                full[idx] = data
                covered += int(np.prod([s.stop - s.start for s in idx]))
            if covered != max(1, int(np.prod(shape))):
                raise ValueError(
                    f"checkpoint '{path}' is incomplete for '{name}': "
                    f"shards cover {covered} of {int(np.prod(shape))} "
                    f"elements (saved from {meta.get('process_count', '?')}"
                    f" processes)")
            flat[name] = _from_numpy(full, dt) if dt == _BF16 else full
        if self.engine is not None:
            self.engine._ckpt_restore(flat, extra)
        dur = time.monotonic() - t_start
        _M_LOAD_S.observe(dur)
        telemetry.record_event("ckpt.load", path=os.path.abspath(path),
                               arrays=len(meta["arrays"]),
                               seconds=round(dur, 4))
        return _unflatten(flat), extra


def restore_local(local: torch.Tensor, placement: Placement, full) -> None:
    """Copy this rank's boxes of the global array ``full`` into
    ``local`` (in place)."""
    src = full if isinstance(full, torch.Tensor) else torch.from_numpy(
        np.asarray(full))
    with torch.no_grad():
        if not placement.global_shape:
            local.copy_(src.reshape(()).to(local.dtype))
            return
        for _, gsl, view in placement.pieces(local):
            view.copy_(src[gsl].to(view.device, view.dtype))


def layer_placements(layer) -> dict:
    """``{parameter name: Placement}`` of a layer's parameters: what its
    sharded sublayers (tensor-parallel layers, ``MoELayer``) report, else
    whole."""
    out = {}
    for mname, m in layer.named_modules():
        if hasattr(m, "placements"):
            for pname, pl in m.placements().items():
                out[f"{mname}.{pname}" if mname else pname] = pl
    for n, p in layer.named_parameters():
        out.setdefault(n, Placement(tuple(p.shape)))
    return out


def load_logical_state(layer, state) -> None:
    """Load a layer's logical (whole, unsharded) parameters, Paddle's
    names and layouts, arrays or tensors: each rank copies its boxes."""
    pls = layer_placements(layer)
    for n, p in layer.named_parameters():
        restore_local(torch.Tensor.detach(p), pls[n], state[n])


class Checkpoint:
    """Numbered snapshots under one root: atomic save, and a load that
    falls back to the last good snapshot (``last_load_report`` says what
    was skipped and why)."""

    PREFIX = "step-"

    def __init__(self, root: str, keep: int = 3, engine=None):
        self.root = os.path.abspath(root)
        self.keep = int(keep)
        self.engine = engine
        self.last_load_report: dict | None = None
        self._saver = None
        self._next = None      # the next step number, the same on every rank

    def snapshots(self) -> list[tuple[int, str]]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if not name.startswith(self.PREFIX) or ".tmp" in name:
                continue
            try:
                step = int(name[len(self.PREFIX):])
            except ValueError:
                continue
            out.append((step, os.path.join(self.root, name)))
        return sorted(out)

    def _path_for(self, step: int) -> str:
        return os.path.join(self.root, f"{self.PREFIX}{step:08d}")

    def save(self, state=None, specs=None, extra=None, step=None,
             async_save=False) -> str:
        """Write the next snapshot; retention applies after a successful
        publish."""
        if step is None:
            if self._next is None:
                snaps = self.snapshots()
                self._next = (snaps[-1][0] + 1) if snaps else 1
            step = self._next
        self._next = step + 1
        os.makedirs(self.root, exist_ok=True)
        path = self._path_for(step)
        saver = DistributedSaver(self.engine)
        saver.save(path, state=state, specs=specs, extra=extra,
                   async_save=async_save)
        if async_save:
            self._saver = saver
        else:
            self._retire()
        return path

    def wait(self):
        if self._saver is not None:
            self._saver.wait()
            self._retire()
            self._saver = None

    def _retire(self):
        if _world()[0] != 0:
            return
        snaps = self.snapshots()
        for _, path in snaps[:max(0, len(snaps) - self.keep)]:
            shutil.rmtree(path, ignore_errors=True)

    def load(self, mesh=None, specs=None):
        """Load the newest snapshot that validates. Raises
        CheckpointCorrupt when none does."""
        skipped: list[tuple[str, str]] = []
        for step, path in reversed(self.snapshots()):
            problems = validate_checkpoint(path)
            if problems:
                skipped.append((path, "; ".join(problems)))
                _M_FALLBACKS.inc()
                telemetry.record_event("ckpt.fallback", path=path,
                                       reason="; ".join(problems)[:300])
                continue
            try:
                state, extra = DistributedSaver(self.engine).load(
                    path, mesh=mesh, specs=specs)
            except Exception as e:  # lint: allow-silent(unreadable despite its manifest: recorded and skipped)
                skipped.append((path, f"load failed: {e}"))
                _M_FALLBACKS.inc()
                telemetry.record_event("ckpt.fallback", path=path,
                                       reason=f"load failed: {e}"[:300])
                continue
            self.last_load_report = {"loaded": path, "skipped": skipped}
            return state, extra
        self.last_load_report = {"loaded": None, "skipped": skipped}
        detail = "; ".join(f"{p}: {r}" for p, r in skipped) or "none found"
        raise CheckpointCorrupt(
            f"no loadable checkpoint under '{self.root}' — {detail}")


def save_distributed_checkpoint(engine, path, async_save=False):
    saver = DistributedSaver(engine)
    saver.save(path, async_save=async_save)
    return saver


def load_distributed_checkpoint(engine, path):
    return DistributedSaver(engine).load(path)
