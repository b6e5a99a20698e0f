"""Whole-server snapshot/restore for `SampleServer`.

A snapshot is the COMPLETE resumable state of a serving process, taken
between scheduling rounds (the same chunk-boundary consistency point that
makes admission and preemption safe):

* the whole slot pool (`SweepEngine.extract_pool`): every slot's
  spins/fields/betas and the interlaced MT19937 generator columns at
  their exact stream positions — idle slots' stale state included, whose
  resweeps are part of the pool's deterministic trajectory — plus the
  batched per-slot coupling tables on multi-tenant engines;
* every job, queued or active: segment progress, scheduler stamps,
  parked-slot carries from earlier preemptions, PT swap generator and
  tallies, and any job-private model (field by field — `LayeredModel`
  is plain numpy + scalars, so the round trip is exact);
* the admission policy's internals: queue order (submission seqs), the
  fair policy's served-cost ledger, aging clock, and construction config;
* the server's accounting: telemetry counters, per-chunk launch series,
  adaptive-chunker EWMA, wait-stat rings, free list, next job id, and
  the retirement log.

Everything lands in ONE flat ``{name: ndarray}`` dict plus a JSON-safe
manifest ``extra``, written through `ckpt.manager.CheckpointManager.
save_named` (atomic tmp+rename, per-shard sha256, async writer).  The
arrays are host numpy COPIES taken at the boundary (the port's carries
are tensors that a CPU caller could otherwise alias), so a background
write saves this boundary's state however far the server has stepped on.

The layout is the JAX reference package's, name for name and key for key
(``SNAPSHOT_VERSION`` 1): a JAX server's snapshot restores here and a
port server's in the reference.  The pool is stored in LOGICAL layout and
the free list flat, so a snapshot taken on D devices under one capacity
vector restores onto any other device count or vector (``mesh=``,
``capacities=`` on restore); ``devices``, ``capacities`` and
``free_by_device`` record the writer's layout, for information.  The
port's ``interpret`` is always false.  The recorded backend is the writer's ("jnp"/"pallas" from the reference,
"torch"/"cuda" from the port); `restore_server` refuses one this package
does not have, and a "torch" snapshot restored on the card, unless
``backend=`` names the one to use.

Restore continues BIT-EXACTLY equal to an uninterrupted run: spins,
energies, raw RNG and retirement order — across the card and the CPU too
for the "fast" and "accurate" exps.  Not for "exact": the card's `expf`
is up to 2 ulp from the CPU's ``exp``, so an "exact" pool restored on the
other device continues on its own trajectory.  Wall-clock state is not
restored: warm launch caches, wall-second wait stamps (sweep-clock waits
are exact) and telemetry *event* rings (counters ARE restored —
`stats()` is built on them).
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core import engine as sweep_engine
from repro_torch.core import ising
from repro_torch.core.engine import PoolState, SweepCarry

#: Bumped on any incompatible change to the layout below; restore refuses
#: a snapshot whose version it does not understand.
SNAPSHOT_VERSION = 1


# -----------------------------------------------------------------------------
# LayeredModel <-> (meta, arrays): field-by-field, exact.
# -----------------------------------------------------------------------------


def _model_state(model: ising.LayeredModel, arrays: dict, prefix: str) -> dict:
    """Serialize ``model`` into ``arrays[prefix/...]``; returns its meta."""
    meta = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if isinstance(v, np.ndarray):
            arrays[f"{prefix}/{f.name}"] = v
        elif isinstance(v, numbers.Number):
            meta[f.name] = v
        else:
            raise TypeError(f"cannot snapshot model field {f.name!r} of type {type(v)}")
    return meta


def _model_from(meta: dict, arrays: dict, prefix: str) -> ising.LayeredModel:
    kwargs = dict(meta)
    for f in dataclasses.fields(ising.LayeredModel):
        key = f"{prefix}/{f.name}"
        if key in arrays:
            kwargs[f.name] = arrays[key]
    return ising.LayeredModel(**kwargs)


# -----------------------------------------------------------------------------
# Policy <-> meta.
# -----------------------------------------------------------------------------


def _policy_state(policy) -> dict:
    from repro_torch.serve_mc.scheduler import AdmissionPolicy, PriorityBackfillPolicy

    meta = {"name": policy.name, "seq": policy._seq, "clock": policy.clock}
    if isinstance(policy, PriorityBackfillPolicy):
        meta.update(
            backfill=policy.backfill,
            preempt=policy.preempt,
            fair=policy.fair,
            user_weights=dict(policy.user_weights),
            aging_sweeps=policy.aging_sweeps,
            served={u: float(v) for u, v in policy._served.items()},
        )
    elif type(policy) is not AdmissionPolicy:
        raise TypeError(
            f"cannot snapshot custom admission policy {type(policy).__name__}; "
            "snapshots support the built-in fifo/backfill/fair policies"
        )
    return meta


def _policy_from(meta: dict):
    from repro_torch.serve_mc.scheduler import AdmissionPolicy, PriorityBackfillPolicy

    if "fair" in meta:
        return PriorityBackfillPolicy(
            backfill=meta["backfill"],
            preempt=meta["preempt"],
            fair=meta["fair"],
            user_weights=meta["user_weights"],
            aging_sweeps=meta["aging_sweeps"],
        )
    return AdmissionPolicy()


# -----------------------------------------------------------------------------
# Snapshot a live server.
# -----------------------------------------------------------------------------


def snapshot_state(server) -> tuple[dict, dict]:
    """``(arrays, extra)`` capturing ``server`` completely.

    Arrays are host numpy copies; ``extra`` is JSON-safe.  Pure read — the
    server is untouched, so the caller may keep stepping it (periodic
    snapshots hand the arrays to the manager's background writer).
    """
    eng = server.engine
    arrays: dict = {}
    pool = eng.extract_pool(server.carry)
    for name, v in zip(SweepCarry._fields, pool.carry):
        arrays[f"carry/{name}"] = v
    if pool.tables is not None:
        for k in sorted(pool.tables):  # the reference's (pytree) order
            arrays[f"tables/{k}"] = pool.tables[k]
    model_meta = _model_state(eng.model, arrays, "base_model")

    jobs_meta = []

    def add_job(job, role, slots=None):
        key = f"job/{job.jid}"
        meta, jarrays = job.snapshot_state()
        for k, v in jarrays.items():
            arrays[f"{key}/{k}"] = v
        if job.model is not None:
            meta["model"] = _model_state(job.model, arrays, f"{key}/model")
        entry = {"role": role, "meta": meta}
        if slots is not None:
            entry["slots"] = [int(b) for b in slots]
        jobs_meta.append(entry)

    for job in server.policy.jobs():  # queue order == restore enqueue order
        add_job(job, "queued")
    for job, slots in server._active.values():
        add_job(job, "active", slots)

    chunker = None
    if server._chunker is not None:
        ck = server._chunker
        chunker = {
            "target_launch_s": ck.target_launch_s,
            "max_chunk": ck.menu[-1],
            "init_chunk": ck.init_chunk,
            "alpha": ck.alpha,
            "per_sweep_ewma": ck.per_sweep_ewma,
        }

    free = [int(b) for b in server._pool.flat_free()]
    extra = {
        "version": SNAPSHOT_VERSION,
        "config": {
            "slots": server.slots,
            "chunk_sweeps": "adaptive" if server._chunker is not None else server.chunk_sweeps,
            "rung": eng.rung,
            "backend": eng.backend,
            "V": eng.V,
            "exp_flavor": eng.exp_flavor,
            "interpret": False,
            "replica_tile": eng.replica_tile,
            "multi_tenant": server.multi_tenant,
            "wait_window": server._wait_recent.maxlen,
            "devices": server.devices,
            "placement": server._pool.mode,
            # The capacity vector the snapshot was taken under (None for the
            # equal split); informational: the pool is in logical layout.
            "capacities": (
                list(server.config.capacities) if server.config.capacities is not None else None
            ),
            "snapshot_every_sweeps": server.snapshot_every_sweeps,
        },
        "model": model_meta,
        "policy": _policy_state(server.policy),
        "jobs": jobs_meta,
        "free": free,
        "free_by_device": server._pool.free_by_device(),  # informational
        "next_jid": server._next_jid,
        "counters": {
            "launches": server.launches,
            "sweeps_elapsed": server.sweeps_elapsed,
            "busy_slot_sweeps": server.busy_slot_sweeps,
            "total_slot_sweeps": server.total_slot_sweeps,
            "preemptions": server.preemptions,
            "submitted": server._c_submitted.value,
            "completed": server._c_completed.value,
            "straggler": server._c_straggler.value,
            "placements_affine": server._c_place_affine.value,
            "placements_spanning": server._c_place_span.value,
            "rebalance_migrations": server._c_migrations.value,
            "pt_swap_local": server._c_swap_local.value,
            "pt_swap_cross": server._c_swap_cross.value,
        },
        "launch_chunks": {str(k): int(v) for k, v in server.launch_chunks.items()},
        "chunker": chunker,
        "wait_records": [list(r) for r in server._wait_records],
        "wait_recent": [list(r) for r in server._wait_recent],
        "retired": [int(j) for j in server._retired],
    }
    return arrays, extra


def save_snapshot(server, manager: CheckpointManager, *, step=None,
                  blocking: bool = True) -> int:
    """Snapshot ``server`` at ``step`` (default: its sweep clock).

    The `snapshot.save` span covers the synchronous part only — the pool's
    copy to the host and the manifest build; with ``blocking=False`` the
    disk writes (fsync'd npy shards + manifest, then the atomic rename)
    happen on the manager's background thread, off the serving path.
    """
    step = int(server.sweeps_elapsed if step is None else step)
    tel = server.telemetry
    with tel.span("snapshot.save", step=step, blocking=blocking):
        arrays, extra = snapshot_state(server)
        manager.save_named(step, arrays, blocking=blocking, extra=extra)
        tel.counter("serve.snapshots").add(1)
    return step


# -----------------------------------------------------------------------------
# Restore.
# -----------------------------------------------------------------------------


def _sub_arrays(arrays: dict, prefix: str) -> dict:
    p = prefix + "/"
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


def restore_server(
    source,
    *,
    step: int | None = None,
    mesh=None,
    capacities=None,
    backend: str | None = None,
    device="cuda",
    replica_tile: int | None = None,
    chunk_sweeps=None,
    placement: str | None = None,
    telemetry=True,
    stream=None,
    snapshot_manager=None,
    snapshot_every_sweeps: int | None = None,
    preemption=None,
):
    """Rebuild a `SampleServer` from a snapshot and continue bit-exactly.

    ``source`` is a `CheckpointManager` or a snapshot directory path;
    ``step=None`` restores the newest VALID snapshot (corrupt ones are
    skipped and GC'd by the manager).  The server lives on ``device`` (the
    card unless the caller asks for the CPU, whichever device wrote the
    snapshot).  Keyword overrides replace the recorded construction
    parameters; ``backend`` must be given when the recorded one is not
    this package's ("jnp"/"pallas" from the JAX reference), and when a
    snapshot of the plain backend ("torch") is restored on the card, so
    the plain version never runs there unasked.  ``mesh`` (a `SlotMesh` on
    ``device``'s type) and ``capacities`` lay the restored pool out over
    devices; the recorded ones are informational and never reapplied (the
    restoring mesh may have another device count), so the default is one
    device.  By default periodic snapshots continue into ``source`` at the recorded
    cadence; pass ``snapshot_manager``/``snapshot_every_sweeps`` to
    redirect or disable them.
    """
    from repro_torch.serve_mc.jobs import AnnealJob, PTJob
    from repro_torch.serve_mc.scheduler import AdaptiveChunker, SampleServer

    mgr = source if isinstance(source, CheckpointManager) else CheckpointManager(str(source))
    if step is None:
        step, arrays, extra = mgr.restore_latest_named()
        if step is None:
            raise FileNotFoundError(f"no valid snapshot found under {mgr.dir!r}")
    else:
        arrays, extra = mgr.restore_named(step)
    version = extra.get("version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {version!r} != supported {SNAPSHOT_VERSION}")

    cfg = extra["config"]
    if backend is None:
        backend = cfg["backend"]
        if backend not in sweep_engine.backends():
            raise ValueError(
                f"snapshot was taken on backend {backend!r}, which repro_torch does not "
                f"have (it has {sweep_engine.backends()}); pass backend= to choose one"
            )
        if backend != "cuda" and torch.device(device).type == "cuda":
            raise ValueError(
                f"snapshot was taken on backend {backend!r} (the plain version); restoring "
                f"it on the card needs backend= ('cuda' for the kernels, {backend!r} for "
                f"the plain version)"
            )
    base_model = _model_from(extra["model"], arrays, "base_model")
    policy = _policy_from(extra["policy"])

    cs = cfg["chunk_sweeps"] if chunk_sweeps is None else chunk_sweeps
    chunker = None
    if cs == "adaptive":
        ck = extra.get("chunker") or {}
        chunker = AdaptiveChunker(
            target_launch_s=ck.get("target_launch_s", 0.05),
            max_chunk=ck.get("max_chunk", 64),
            init_chunk=ck.get("init_chunk", 8),
            alpha=ck.get("alpha", 0.3),
        )
        # Resume the measured launch-cost EWMA; the warm set is NOT
        # restored — `observe` must keep discarding each size's first
        # (set-up) launch in the new process.
        chunker.per_sweep_ewma = ck.get("per_sweep_ewma")

    server = SampleServer(
        base_model,
        slots=cfg["slots"],
        chunk_sweeps=cs,
        rung=cfg["rung"],
        backend=backend,
        V=cfg["V"],
        exp_flavor=cfg["exp_flavor"],
        device=device,
        replica_tile=cfg["replica_tile"] if replica_tile is None else replica_tile,
        chunker=chunker,
        multi_tenant=cfg["multi_tenant"],
        policy=policy,
        wait_window=cfg["wait_window"],
        placement=cfg.get("placement", "affine") if placement is None else placement,
        telemetry=telemetry,
        stream=stream,
        snapshot_manager=mgr if snapshot_manager is None else snapshot_manager,
        snapshot_every_sweeps=(
            cfg.get("snapshot_every_sweeps", 0)
            if snapshot_every_sweeps is None
            else snapshot_every_sweeps
        ),
        preemption=preemption,
        mesh=mesh,
        capacities=capacities,
    )

    tables = _sub_arrays(arrays, "tables") or None
    pool = PoolState(SweepCarry(*(arrays[f"carry/{n}"] for n in SweepCarry._fields)), tables)
    server.carry = server.engine.splice_pool(pool)

    # Jobs: queued (in recorded queue order) then active.
    kinds = {"anneal": AnnealJob, "pt": PTJob}
    for entry in extra["jobs"]:
        meta = entry["meta"]
        key = f"job/{meta['jid']}"
        model = _model_from(meta["model"], arrays, f"{key}/model") if "model" in meta else None
        job = kinds[meta["kind"]].from_snapshot(meta, _sub_arrays(arrays, key), model=model)
        if entry["role"] == "queued":
            server.policy.enqueue(job)
        else:
            server._active[job.jid] = (job, tuple(entry["slots"]))
        server.telemetry.async_begin(
            "job", job.jid, kind=job.kind, slots=job.num_slots, priority=job.priority,
            user=job.user, restored=True,
        )
    # The ledger/seq/clock go in AFTER the enqueues: enqueue's entering-
    # the-backlog flooring must not perturb the restored served levels.
    pol_meta = extra["policy"]
    if "served" in pol_meta:
        server.policy._served = {u: float(v) for u, v in pol_meta["served"].items()}
    server.policy._seq = pol_meta["seq"]
    server.policy.clock = pol_meta["clock"]

    server._pool.restore_free(extra["free"])
    server._next_jid = int(extra["next_jid"])

    c = extra["counters"]
    server._c_launches.add(c["launches"])
    server._c_sweeps.add(c["sweeps_elapsed"])
    server._c_busy.add(c["busy_slot_sweeps"])
    server._c_total.add(c["total_slot_sweeps"])
    server._c_preempt.add(c["preemptions"])
    server._c_submitted.add(c["submitted"])
    server._c_completed.add(c["completed"])
    server._c_straggler.add(c.get("straggler", 0))
    server._c_place_affine.add(c.get("placements_affine", 0))
    server._c_place_span.add(c.get("placements_spanning", 0))
    server._c_migrations.add(c.get("rebalance_migrations", 0))
    server._c_swap_local.add(c.get("pt_swap_local", 0))
    server._c_swap_cross.add(c.get("pt_swap_cross", 0))
    for chunk, v in extra["launch_chunks"].items():
        server.telemetry.counter("serve.launches_by_chunk", chunk=int(chunk)).add(int(v))
    server._wait_records.extend(tuple(r) for r in extra["wait_records"])
    server._wait_recent.extend(tuple(r) for r in extra["wait_recent"])
    server._retired.extend(int(j) for j in extra["retired"])
    server._last_snapshot_sweep = server.sweeps_elapsed
    server.telemetry.instant(
        "snapshot.restore",
        step=step,
        devices=server.devices,
        saved_devices=cfg["devices"],
        queued=len(server.policy),
        active=len(server._active),
    )
    return server
