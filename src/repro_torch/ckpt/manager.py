"""Checkpoint manager: manifest + per-array npy shards, async, keep-N, atomic.

Fault-tolerance contract:

* Atomicity — a checkpoint directory is staged under ``<step>.tmp0``
  and os.rename'd into place only after every shard and the manifest are
  fsynced; a crash mid-write can never produce a directory that
  ``latest_step`` would pick up.  Stale ``.tmp`` staging dirs left by a
  killed writer are garbage-collected on the next scan.
* Integrity — every shard's serialized bytes are sha256'd into the
  manifest and re-verified on restore; a flipped bit or truncated file
  raises ``CheckpointCorruptError`` instead of silently resuming from
  garbage.  ``restore_latest_named`` treats a corrupt snapshot as absent:
  it deletes the bad directory and falls back to the newest *valid* one.
* Async — ``save``/``save_named(..., blocking=False)`` write on a
  background thread; training or serving continues.  One save is in
  flight at a time; ``save`` takes its host copies before it returns.
* Keep-N garbage collection, and a ``valid_steps`` scan that ignores —
  and removes — incomplete or corrupt directories.
* Multi-process — ``process_index`` namespaces the files
  (``leaf_<process>_<i>.npy``, staged under ``<step>.tmp<process>``).  A
  process that commits a step another process already committed adds its
  files to the directory and unions the manifests: the top level stays
  the lowest process's (a single-process reader sees its tree), and
  ``"processes"`` holds each process's entries.  Each manager restores
  its own process's leaves.  (The reference's manager replaces the
  directory, so there the last process to commit a step wins.)
* Resharding restore — ``restore(..., shardings=)`` places each loaded
  leaf with the current mesh's placements (``distribute_tensor``), so a
  run restarted on another layout restores transparently.

Two payload shapes are supported:

* ``save``/``restore``/``restore_latest`` — a tree checkpoint restored
  into the structure of a caller-provided ``like_tree`` (the training-loop
  API).  A tree is nested dicts, tuples, lists and NamedTuples of tensors
  or numpy arrays, its leaves taken in JAX's ``tree_flatten`` order (a
  dict's values by sorted key, None no leaves); a `train.step.TrainState`
  is written as the reference's TrainState (`core.convert.train_state_names`),
  so each package restores the other's steps, and is restored in place.
* ``save_named``/``restore_named`` — a flat ``{name: ndarray}`` dict
  whose names and dtypes are recorded in the manifest, restorable with
  no prior knowledge of the structure (the server-snapshot API: the
  restorer learns the job and slot layout *from* the checkpoint).

The on-disk format is the JAX reference package's (``step_%010d``
directories; ``manifest.json`` with ``shards``, ``checksums``,
``raw_dtypes``, ``dtypes``, ``shapes``, ``names`` and ``extra``; one npy
file per array; dtypes numpy does not treat as numeric stored as a uint8
view with the true dtype recorded: bfloat16 tensors are written through
``tensor.view(torch.uint8)`` and read back the same way, so no
``ml_dtypes`` is needed), byte for byte: a directory written by either
package's manager reads back in the other.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointCorruptError(RuntimeError):
    """A shard failed its checksum / a step dir is unreadable."""


def _dtype_name(arr) -> str:
    return "bfloat16" if isinstance(arr, torch.Tensor) else str(arr.dtype)


def _serialize(arr) -> tuple[bytes, Optional[str]]:
    """npy-encode one host array; returns (bytes, raw_dtype_or_None).

    Non-numpy-native dtypes (bf16 etc.) are stored as a uint8 view with
    the true dtype recorded so restore can view them back.  A bfloat16
    leaf comes as a CPU tensor (`_host`).
    """
    raw = None
    if isinstance(arr, torch.Tensor):
        raw = "bfloat16"
        arr = arr.contiguous().view(torch.uint8).numpy()
    elif arr.dtype.kind not in "biufc":
        raw = str(arr.dtype)
        arr = arr.view(np.uint8)
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue(), raw


def _tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's ``tree_flatten`` order: a dict's
    values by sorted key, a tuple's, list's or NamedTuple's in order; None
    has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _tree_leaves(child)]
    return [tree]


def _tree_unflatten(like, leaves):
    """``like``'s structure over the iterator ``leaves`` (`_tree_leaves` order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _tree_unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        children = [_tree_unflatten(child, leaves) for child in like]
        if isinstance(like, list):
            return children
        return type(like)(*children) if hasattr(like, "_fields") else tuple(children)
    return next(leaves)


def _train_state(tree):
    """``tree`` if it is a `train.step.TrainState`, else None."""
    if not hasattr(tree, "_fields"):
        return None
    from repro_torch.train.step import TrainState

    return tree if isinstance(tree, TrainState) else None


def _host(leaf):
    """A host copy of one leaf: a numpy array, or a CPU tensor for
    bfloat16 (which numpy cannot hold without ``ml_dtypes``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(leaf)


def _host_leaves(tree) -> list:
    state = _train_state(tree)
    if state is not None:
        from repro_torch.core import convert

        return [_host(t) for t in convert.train_state_to_arrays(state).values()]
    return [_host(leaf) for leaf in _tree_leaves(tree)]


def _as_like(arr, like):
    """A restored leaf as ``like``: a tensor of its dtype on its device,
    or a numpy array of its dtype."""
    if isinstance(like, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    like_dtype = np.asarray(like).dtype
    return arr.astype(like_dtype) if arr.dtype != like_dtype else arr


def _shardings_like(like_tree, shardings) -> list:
    """The leaves of ``shardings`` in ``like_tree``'s leaf order; a None
    in ``shardings`` stands for one unplaced leaf."""
    likes = _tree_leaves(like_tree)
    flat = _tree_leaves(_none_as_leaf(shardings))
    if len(flat) != len(likes):
        raise ValueError(f"shardings has {len(flat)} leaves, the tree {len(likes)}")
    return [None if s is _NONE else s for s in flat]


_NONE = object()


def _none_as_leaf(tree):
    if tree is None:
        return _NONE
    if isinstance(tree, dict):
        return {k: _none_as_leaf(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_none_as_leaf(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_none_as_leaf(v) for v in tree)
    return tree


def _place(leaf, sharding):
    """``leaf`` (a tensor or an array) as a DTensor of ``sharding``'s placements."""
    if sharding is None:
        return leaf
    from torch.distributed.tensor import distribute_tensor

    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(leaf))
    return distribute_tensor(t.to(sharding.mesh.device_type), sharding.mesh, sharding.placements)


def _check_count(manifest: dict, count: int, d: str) -> None:
    if manifest["num_leaves"] != count:
        raise ValueError(f"{d} holds {manifest['num_leaves']} leaves, the tree {count}")


_PROCESS_KEYS = ("num_leaves", "shards", "raw_dtypes", "checksums", "dtypes", "shapes",
                 "treedef", "names", "extra")
_SHARD_RE = re.compile(r"^leaf_(\d+)_\d+\.npy$")


def _process_of(manifest: dict) -> int:
    """The process that wrote a one-process manifest (from its file names)."""
    for fname in manifest["shards"].values():
        m = _SHARD_RE.match(fname)
        if m:
            return int(m.group(1))
    return 0


def _union(old: dict, new: dict, proc: int) -> dict:
    """The manifest of a step directory holding ``old``'s processes and ``new``'s."""
    procs = dict(old.get("processes") or {str(_process_of(old)): old})
    procs[str(proc)] = new
    procs = {k: {f: v[f] for f in _PROCESS_KEYS if f in v} for k, v in procs.items()}
    first = procs[min(procs, key=int)]
    out = {k: v for k, v in new.items() if k not in _PROCESS_KEYS}
    out.update(first)
    out["processes"] = procs
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.proc = int(process_index)
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # ---- paths ----
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _is_valid(self, name: str) -> bool:
        """Complete-looking step dir: manifest parses, every shard exists."""
        full = os.path.join(self.dir, name)
        try:
            with open(os.path.join(full, "manifest.json")) as f:
                manifest = json.load(f)
            for entry in (manifest.get("processes") or {"": manifest}).values():
                for fname in entry["shards"].values():
                    if not os.path.exists(os.path.join(full, fname)):
                        return False
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return True

    def valid_steps(self) -> list[int]:
        """Sorted steps with complete snapshots; GCs partial/corrupt dirs.

        Stale ``.tmp`` staging dirs (killed writer) and non-tmp step dirs
        that fail validation are removed — a single writer per directory
        is assumed, so anything invalid at scan time is crash debris.
        """
        steps = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if not os.path.isdir(full) or not name.startswith("step_"):
                continue
            if ".tmp" in name:
                shutil.rmtree(full, ignore_errors=True)
                continue
            m = _STEP_RE.match(name)
            if m is None or not self._is_valid(name):
                shutil.rmtree(full, ignore_errors=True)
                continue
            steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.valid_steps()
        return max(steps) if steps else None

    # ---- save ----
    def _write_payload(self, step: int, items: list, extra: dict | None,
                       names: Optional[list] = None):
        """Stage shards + manifest under .tmp, fsync, rename into place."""
        tmp = self._step_dir(step) + f".tmp{self.proc}"
        os.makedirs(tmp, exist_ok=True)
        shards = {}
        raw_dtypes = {}
        checksums = {}
        dtypes = {}
        shapes = {}
        for i, arr in enumerate(items):
            fname = f"leaf_{self.proc}_{i:05d}.npy"
            dtypes[str(i)] = _dtype_name(arr)
            shapes[str(i)] = list(arr.shape)
            data, raw = _serialize(arr)
            if raw is not None:
                raw_dtypes[str(i)] = raw
            checksums[str(i)] = hashlib.sha256(data).hexdigest()
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            shards[str(i)] = fname
        manifest = {
            "step": step,
            "num_leaves": len(items),
            "shards": shards,
            "raw_dtypes": raw_dtypes,
            "checksums": checksums,
            "dtypes": dtypes,
            "shapes": shapes,
            "treedef": "",
            "time": time.time(),
            "extra": extra or {},
        }
        if names is not None:
            manifest["names"] = names
        final = self._step_dir(step)
        other = self._other_processes(final)
        if other is not None:
            manifest = _union(other, manifest, self.proc)
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if other is not None:  # join the other processes' files
            for name in os.listdir(tmp):
                os.replace(os.path.join(tmp, name), os.path.join(final, name))
            os.rmdir(tmp)
        else:
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        self._gc()

    def _other_processes(self, final: str) -> Optional[dict]:
        """The manifest of ``final`` when other processes (not this one)
        committed it, else None."""
        try:
            with open(os.path.join(final, "manifest.json")) as f:
                old = json.load(f)
        except (OSError, ValueError):
            return None
        procs = set(old.get("processes") or {str(_process_of(old))}) - {str(self.proc)}
        return old if procs and self._is_valid(os.path.basename(final)) else None

    def save(self, step: int, tree: Any, *, blocking: bool = True, extra: dict | None = None):
        """Checkpoint a tree (a `train.step.TrainState` as the reference's
        TrainState) at ``step``.  Host copies are taken before this
        returns, so the caller may update its tensors in place at once."""
        host = _host_leaves(tree)
        self._start(lambda: self._write_payload(step, host, extra), blocking)

    def _start(self, write, blocking: bool):
        self.wait()  # one save in flight at a time (async OR blocking)
        if blocking:
            write()
        else:
            self._async_thread = threading.Thread(target=write, daemon=True)
            self._async_thread.start()

    def save_named(self, step: int, arrays: dict, *, blocking: bool = True,
                   extra: dict | None = None):
        """Checkpoint a flat ``{name: array}`` dict; names go in the manifest
        so ``restore_named`` needs no like-tree.  With ``blocking=False`` the
        writer reads the arrays after this returns: the caller hands over
        arrays that nothing changes later (`serve_mc.snapshot` hands host
        copies)."""
        names = list(arrays.keys())
        host = [np.asarray(arrays[k]) for k in names]
        self._start(lambda: self._write_payload(step, host, extra, names), blocking)

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _gc(self):
        steps = []
        for n in os.listdir(self.dir):
            m = _STEP_RE.match(n)
            if m is not None:
                steps.append(int(m.group(1)))
        for s in sorted(steps)[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore ----
    def _load_shard(self, d: str, manifest: dict, i: int) -> np.ndarray:
        """Read shard ``i``, verify its checksum, and decode the array."""
        key = str(i)
        path = os.path.join(d, manifest["shards"][key])
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise CheckpointCorruptError(f"missing shard {path}: {e}") from e
        want = manifest.get("checksums", {}).get(key)
        if want is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != want:
                raise CheckpointCorruptError(
                    f"checksum mismatch for {path}: {got} != {want}"
                )
        try:
            return np.load(io.BytesIO(data))
        except ValueError as e:
            raise CheckpointCorruptError(f"unreadable shard {path}: {e}") from e

    def _manifest(self, step: int) -> tuple[str, dict]:
        """The step's manifest as this process reads it: its own entries
        where several processes wrote the step."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(f"unreadable manifest in {d}: {e}") from e
        procs = manifest.get("processes")
        if procs is not None:
            if str(self.proc) not in procs:
                raise CheckpointCorruptError(
                    f"{d} holds processes {sorted(procs, key=int)}, not {self.proc}")
            manifest = {k: v for k, v in manifest.items() if k not in _PROCESS_KEYS}
            manifest.update(procs[str(self.proc)])
        return d, manifest

    def processes(self, step: int) -> list[int]:
        """The process indices whose leaves ``step`` holds."""
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            manifest = json.load(f)
        return sorted(int(p) for p in (manifest.get("processes") or {_process_of(manifest): 0}))

    def _load_leaf(self, d: str, manifest: dict, i: int):
        """Shard ``i`` in its recorded dtype: a numpy array, or a CPU
        tensor for bfloat16."""
        arr = self._load_shard(d, manifest, i)
        raw = manifest.get("raw_dtypes", {}).get(str(i))
        if raw == "bfloat16":
            return torch.from_numpy(arr).view(torch.bfloat16).reshape(manifest["shapes"][str(i)])
        return arr if raw is None else arr.view(np.dtype(raw))

    def restore(self, step: int, like_tree: Any, shardings: Any = None) -> tuple[Any, dict]:
        """Load ``step`` into the structure of ``like_tree``; returns
        ``(tree, extra)``.  Each leaf takes the like leaf's dtype (and, for
        a tensor, its device).  A `train.step.TrainState` is restored in
        place (`core.convert.train_state_from_arrays`), after every shard
        has been read and verified.  ``shardings``: a tree of the same
        structure of `sharding.NamedSharding`s (None leaves for none);
        each loaded leaf becomes a DTensor of its placements."""
        d, manifest = self._manifest(step)
        state = _train_state(like_tree)
        if state is not None and shardings is not None:
            raise ValueError("restore(shardings=) takes a tree of tensors; a TrainState is "
                             "restored in place into its own tensors")
        if state is not None:
            from repro_torch.core import convert

            names = convert.train_state_names(state)
            _check_count(manifest, len(names), d)
            arrays = {n: self._load_leaf(d, manifest, i) for i, n in enumerate(names)}
            return convert.train_state_from_arrays(arrays, state), manifest.get("extra", {})
        likes = _tree_leaves(like_tree)
        _check_count(manifest, len(likes), d)
        out = [_as_like(self._load_leaf(d, manifest, i), like) for i, like in enumerate(likes)]
        if shardings is not None:
            out = [_place(leaf, sh) for leaf, sh in zip(out, _shardings_like(like_tree, shardings))]
        return _tree_unflatten(like_tree, iter(out)), manifest.get("extra", {})

    def restore_latest(self, like_tree: Any, shardings: Any = None):
        """Restore the newest *valid* snapshot as ``(step, tree, extra)``,
        falling back past corrupt ones (each failed candidate is deleted so
        later scans skip it); ``(None, None, {})`` when there is none."""
        for step in reversed(self.valid_steps()):
            try:
                tree, extra = self.restore(step, like_tree, shardings)
                return step, tree, extra
            except CheckpointCorruptError:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        return None, None, {}

    def restore_named(self, step: int) -> tuple[dict, dict]:
        """Load a ``save_named`` checkpoint as ``({name: ndarray}, extra)``,
        host numpy in the writer's layout."""
        d, manifest = self._manifest(step)
        names = manifest.get("names")
        if names is None:
            raise CheckpointCorruptError(
                f"{d} was not written by save_named (no names in manifest)"
            )
        raw_dtypes = manifest.get("raw_dtypes", {})
        out = {}
        for i, name in enumerate(names):
            arr = self._load_shard(d, manifest, i)
            key = str(i)
            if key in raw_dtypes:
                arr = arr.view(np.dtype(raw_dtypes[key]))
            out[name] = arr
        return out, manifest.get("extra", {})

    def restore_latest_named(self):
        """Restore the newest *valid* snapshot as ``(step, arrays, extra)``,
        falling back past corrupt ones (each failed candidate is deleted so
        later scans skip it); ``(None, None, {})`` when there is none."""
        for step in reversed(self.valid_steps()):
            try:
                arrays, extra = self.restore_named(step)
                return step, arrays, extra
            except CheckpointCorruptError:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
        return None, None, {}
