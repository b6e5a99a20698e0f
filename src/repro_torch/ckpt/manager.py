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
* Async — ``save_named(..., blocking=False)`` writes on a background
  thread; serving continues.  One save is in flight at a time.
* Keep-N garbage collection, and a ``valid_steps`` scan that ignores —
  and removes — incomplete or corrupt directories.

The payload is a flat ``{name: ndarray}`` dict whose names and dtypes are
recorded in the manifest, restorable with no prior knowledge of the
structure (the server-snapshot API: the restorer learns the job and slot
layout *from* the checkpoint).

The on-disk format is the JAX reference package's (``step_%010d``
directories; ``manifest.json`` with ``shards``, ``checksums``,
``raw_dtypes``, ``dtypes``, ``shapes``, ``names`` and ``extra``; one npy
file per array; dtypes numpy does not treat as numeric stored as a uint8
view with the true dtype recorded), byte for byte: a directory written by
either package's manager reads back in the other.
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
from typing import Optional

import numpy as np

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointCorruptError(RuntimeError):
    """A shard failed its checksum / a step dir is unreadable."""


def _serialize(arr: np.ndarray) -> tuple[bytes, Optional[str]]:
    """npy-encode one host array; returns (bytes, raw_dtype_or_None).

    Non-numpy-native dtypes (bf16 etc.) are stored as a uint8 view with
    the true dtype recorded so restore can view them back.
    """
    raw = None
    if arr.dtype.kind not in "biufc":
        raw = str(arr.dtype)
        arr = arr.view(np.uint8)
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue(), raw


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
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
            for fname in manifest["shards"].values():
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
    def _write_payload(self, step: int, items: list, extra: dict | None, names: list):
        """Stage shards + manifest under .tmp, fsync, rename into place."""
        # One process writes: the reference's names for process 0.
        tmp = self._step_dir(step) + ".tmp0"
        os.makedirs(tmp, exist_ok=True)
        shards = {}
        raw_dtypes = {}
        checksums = {}
        dtypes = {}
        shapes = {}
        for i, arr in enumerate(items):
            fname = f"leaf_0_{i:05d}.npy"
            dtypes[str(i)] = str(arr.dtype)
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
            "names": names,
        }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def save_named(self, step: int, arrays: dict, *, blocking: bool = True,
                   extra: dict | None = None):
        """Checkpoint a flat ``{name: array}`` dict; names go in the manifest
        so ``restore_named`` needs no like-tree.  With ``blocking=False`` the
        writer reads the arrays after this returns: the caller hands over
        arrays that nothing changes later (`serve_mc.snapshot` hands host
        copies)."""
        names = list(arrays.keys())
        host = [np.asarray(arrays[k]) for k in names]

        def _write():
            self._write_payload(step, host, extra, names)

        self.wait()  # one save in flight at a time (async OR blocking)
        if blocking:
            _write()
        else:
            self._async_thread = threading.Thread(target=_write, daemon=True)
            self._async_thread.start()

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
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                return d, json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(f"unreadable manifest in {d}: {e}") from e

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
