"""Multi-pod dry run: build and run every (arch x shape x mesh) cell abstractly.

The reference compiles each cell ahead of time on 512 forced host devices
and reads XLA's memory, cost and collective analyses.  Here a cell runs
once in a fake world (``torch.distributed``'s ``"fake"`` backend: this
process is rank 0 of 256 or 512 ranks whose collectives do nothing) on
fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no storage,
no arithmetic), with every argument a DTensor of the cell's placements.
The world is this process's own: run the dry run as its own process
(``python -m repro_torch.launch.dryrun``), as the reference runs its
512-device ``XLA_FLAGS`` in a process of its own.

Per cell the dry run:
  1. builds the production mesh (a ``DeviceMesh`` over the fake world) and
     the sharding ctx (logical -> physical rules, the decode overrides),
  2. builds the model under the fake mode and makes each parameter, the
     optimizer state, the int8 residual, the batch and the caches a DTensor
     whose local block is rank 0's shard,
  3. runs the step once (the train step with grad accumulation and AdamW,
     ``apply``, or ``decode_step``) in a fake mode that hands rank 0's
     local ops to a census (`LocalCensus`): its live bytes, its flops and
     its collectives,
  4. records a JSON row with the reference's keys.

What the row's numbers are:

* ``memory.argument_bytes``: the exact sum of rank 0's local shard bytes
  of every argument; ``temp_bytes``: the peak of rank 0's live bytes
  allocated during the step (the arguments excluded); ``output_bytes``:
  the local bytes of the step's outputs; ``code_bytes``: 0.
* ``xla_cost.flops_body_once``: rank 0's flops over every executed op (the
  products PyTorch's flop counter knows, and the attention op's formula
  for its forward; its backward recomputes the chunk loop op by op);
  every layer runs, and the gradient-accumulation loop's body runs once
  (``grad_accum`` stays the reference's; ``microbatches_run`` says 1), as
  XLA's analysis counts a scan body once; ``bytes_body_once``: -1 (not
  measured).
* ``collectives``: rank 0's collectives by the reference's five names,
  counts and output bytes, every executed one.
* ``lower_s``: building the cell; ``compile_s``: running the step;
  ``seconds`` (the CLI's rows): both, the world's set-up included.

The fake group's collectives do nothing, so no value computed here means
anything, and DTensor's sharding propagation is not GSPMD's: the census
will not match the reference's HLO op for op.  A cell that fails is a row
with ``"status": "error"``; an inapplicable one, ``"skipped"``.

Usage:
  python -m repro_torch.launch.dryrun --device cpu --arch gemma-2b --shape train_4k --no-analyze
  python -m repro_torch.launch.dryrun --all --both-meshes --no-analyze --out rows.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, SkipCell
from repro_torch.configs.registry import ARCHS, get_config, get_module
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh, mesh_devices_required
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import ShardingCtx, use_ctx
from repro_torch.sharding.ctx import DEFAULT_RULES, is_dtensor
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

LM_ARCHS = [a for a in ARCHS if a != "ising-qmc"]

# Per-(arch, shape) gradient-accumulation factors: the reference's memory levers.
GRAD_ACCUM: Dict[tuple, int] = {
    ("qwen2.5-14b", "train_4k"): 4,
    ("deepseek-coder-33b", "train_4k"): 8,
    ("gemma-2b", "train_4k"): 4,
    ("command-r-35b", "train_4k"): 8,
    ("zamba2-1.2b", "train_4k"): 4,
    ("rwkv6-1.6b", "train_4k"): 4,
    ("deepseek-v3-671b", "train_4k"): 16,
    ("llama4-scout-17b-a16e", "train_4k"): 8,
    ("internvl2-26b", "train_4k"): 8,
    ("whisper-tiny", "train_4k"): 4,
}

# torch's functional collectives -> the reference's HLO names.
COLLECTIVE = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def init_fake_world(multi_pod: bool) -> int:
    """Make this process rank 0 of a fake world of the production mesh's size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = mesh_devices_required(multi_pod)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            dist.destroy_process_group()
        else:
            return n
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return n


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local(t):
    return t._local_tensor if is_dtensor(t) else t


def local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor leaf of ``tree`` (a DTensor's local block)."""
    return sum(_local(t).numel() * _local(t).element_size() for t in _leaves(tree))


class LocalCensus:
    """Rank 0's local ops, as the fake mode runs them: the peak of the
    bytes allocated while it records (storages alive at once), the
    products' flops, and the collectives (counts and output bytes).

    The fake mode also runs DTensor's sharding propagation, on stand-ins
    of the global shapes that ``empty_strided`` makes: an op counts only
    when one of its inputs lies on a storage of rank 0's (an argument's
    block or a counted op's output), or when it makes a tensor from
    nothing (``zeros``, ``arange``, ...) other than by ``empty_strided``."""

    def __init__(self, known=()):
        from torch.utils.weak import WeakIdKeyDictionary

        self.live = self.peak = self.flops = 0
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self._seen = WeakIdKeyDictionary()
        for t in known:  # the arguments' storages: views of them allocate nothing
            self._seen[_local(t).untyped_storage()] = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        ins = _tensors(args) + _tensors(kwargs.values())
        if ins:
            if not any(t.untyped_storage() in self._seen for t in ins):
                return  # DTensor's sharding propagation, on global-shaped stand-ins
        elif func is torch.ops.aten.empty_strided.default:
            return  # the stand-ins themselves
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        kind = _KIND.get(func)
        if kind is None:
            ns, _, name = func._schema.name.partition("::")
            kind = _KIND[func] = ("wait" if func is torch.ops._c10d_functional.wait_tensor.default
                                  else COLLECTIVE.get(name) if ns == "_c10d_functional"
                                  else "flops" if func._overloadpacket in flop_registry else "")
        if kind == "wait":
            for t in outs:  # the collective's own output, waited for: no new bytes
                self._seen.setdefault(t.untyped_storage(), 0)
            return
        if kind == "flops":
            self.flops += int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
        elif kind:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + sum(t.numel() * t.element_size()
                                                           for t in outs)
        for t in outs:
            self._track(t)


_KIND: Dict[Any, str] = {}


def _tensors(seq) -> list:
    """The tensors of ``seq``, one level of lists and tuples down (aten's arguments)."""
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class CensusFakeMode(FakeTensorMode):
    """A fake mode that hands each op it runs to ``census`` (when set).
    Its ops are rank 0's local ones: a DTensor op is not the fake mode's
    to run, and DTensor runs its local ops on the fake local blocks."""

    census: LocalCensus | None = None
    _depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self.census is not None and self._depth == 0 and out is not NotImplemented:
            self.census.record(func, args, kwargs, out)
        return out


@dataclasses.dataclass
class Cell:
    """One built cell: ``run()`` runs its step on ``args``."""

    meta: dict
    ctx: ShardingCtx
    run: Any
    args: dict  # name -> argument tree (DTensors)
    leaves: list  # [{"path", "shape", "dtype", "spec"}] of every argument leaf


def _decode_rules(cfg, shape, mesh_shape) -> dict:
    rules = dict(DEFAULT_RULES)
    model_size = mesh_shape["model"]
    if shape.global_batch == 1:
        # long-context single request: shard the cache sequence over
        # every available axis (batch unshardable).
        rules["cache_seq"] = ("data", "model")
    elif cfg.attn_kind == "mla" or cfg.num_kv_heads % model_size != 0:
        # KV heads don't divide the model axis (qwen kv=8 on 16), or the
        # cache is MLA's per-token latent: shard the cache's minor dim
        # (head_dim / latent rank) over "model".
        rules["cache_head_dim"] = ("model",)
    return rules


class _Maker:
    """Makes rank 0's local block of each argument: a fake tensor, or (for
    a run on the card) a real one drawn from a seeded generator."""

    def __init__(self, fake_mode, device, generator=None):
        self.fake_mode, self.device, self.gen = fake_mode, torch.device(device), generator

    def local(self, shape, dtype, *, high=None, zero=False):
        if self.gen is None:
            with self.fake_mode:
                return torch.empty(shape, dtype=dtype, device=self.device)
        if zero:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if not dtype.is_floating_point:
            return torch.randint(0, high or 2, shape, generator=self.gen, device=self.device,
                                 dtype=dtype)
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return x.mul_(0.02).to(dtype)

    def dtensor(self, sharding, shape, dtype, **kw):
        from torch.distributed.tensor import DTensor

        loc = self.local(sharding.shard_shape(shape), dtype, **kw)
        return DTensor.from_local(loc, sharding.mesh, sharding.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())


def _clear_device_caches():
    """The layers cache small per-device tables (RoPE frequencies, whisper's
    sinusoids); one made under the fake mode must not outlive it."""
    from repro_torch.models import encdec
    from repro_torch.nn import basic

    basic._rope_frequencies_on.cache_clear()
    encdec._positions_on.cache_clear()


def _distribute_params(model, ctx, maker, serving: bool, requires_grad: bool):
    """Replace each parameter by a DTensor of its sharding; returns
    ``({name: parameter}, {name: NamedSharding})``."""
    logical = model.logical_axes()
    named = dict(model.named_parameters())
    shard = S.param_shardings(ctx, named, logical)
    for name, p in named.items():
        dtype = torch.bfloat16 if serving and p.dtype == torch.float32 else p.dtype
        d = maker.dtensor(shard[name], tuple(p.shape), dtype)
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, torch.nn.Parameter(d, requires_grad=requires_grad))
    return dict(model.named_parameters()), shard


def _record(leaves, group, tree, shard):
    """Leaf records of ``tree`` (dicts and NamedTuples of tensors) with the
    matching ``shard`` tree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in tree:
            _record(leaves, f"{group}.{k}", tree[k], shard[k])
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, t, s in zip(tree._fields, tree, shard):
            _record(leaves, f"{group}.{f}", t, s)
        return
    leaves.append({"path": group, "shape": list(tree.shape),
                   "dtype": str(tree.dtype).replace("torch.", ""), "spec": list(shard.spec)})


def build_cell(arch: str, shape_name: str, multi_pod: bool, device="cuda", *,
               generator: torch.Generator | None = None) -> Cell:
    """Build one cell over the fake world (`init_fake_world`).  With a
    ``generator`` the local blocks are real tensors on ``device`` (rank 0's
    share, run for real); without, fake ones."""
    from repro_torch.models import decoder, encdec

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    kind, inputs = get_module(arch).input_specs(shape)

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    mesh_shape = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    rules = _decode_rules(cfg, shape, mesh_shape) if kind == "decode" else dict(DEFAULT_RULES)
    ctx = ShardingCtx.over(mesh, rules)
    fake = CensusFakeMode(allow_non_fake_inputs=True)  # the mesh's rank table is real
    maker = _Maker(fake, device, generator)
    meta = {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "mesh": mesh_shape,
        "multi_pod": multi_pod,
        "params": int(cfg.num_params()),
        "active_params": int(cfg.num_active_params()),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
    }

    init_fn = encdec.init_params if cfg.encdec else decoder.init_params
    _clear_device_caches()
    with fake:
        model = init_fn(torch.Generator(device=device), cfg, device)
    leaves: list = []
    with use_ctx(ctx):
        named, p_shard = _distribute_params(model, ctx, maker, serving=kind != "train",
                                            requires_grad=kind == "train")

        def batch_of(tree):
            shard = S.batch_shardings(ctx, tree)
            return {k: maker.dtensor(shard[k], tuple(v.shape), v.dtype, high=cfg.vocab_size)
                    for k, v in tree.items()}, shard

        if kind == "train":
            accum = GRAD_ACCUM.get((arch, shape_name), 1)
            # Each microbatch must still cover every batch shard.
            batch_shards = 1
            for a in ("pod", "data"):
                batch_shards *= mesh_shape.get(a, 1)
            accum = max(1, min(accum, shape.global_batch // batch_shards))
            tc = TrainConfig(optimizer=AdamWConfig(), grad_accum=accum,
                             grad_compression="int8_ef" if multi_pod else "none")
            meta["grad_accum"] = accum
            if generator is None:
                with fake:
                    state = init_train_state(model, tc)
            else:
                state = init_train_state(model, tc)
            batch, b_shard = batch_of(inputs)
            # The accumulation loop's body runs once in a fake run (`make_train_step`).
            once = generator is None
            meta["microbatches_run"] = 1 if once else accum
            step = make_train_step(cfg, tc, param_specs={n: s.spec for n, s in p_shard.items()},
                                   microbatches=1 if once else None)
            run = lambda: step(state, batch)  # noqa: E731
            args = {"params": named, "opt": state.opt, "ef_residual": state.ef_residual,
                    "step": state.step, "batch": batch}
            _record(leaves, "params", named, p_shard)
            _record(leaves, "opt.m", state.opt.m, p_shard)
            _record(leaves, "opt.v", state.opt.v, p_shard)
            _record(leaves, "ef_residual", state.ef_residual, p_shard)
            _record(leaves, "step", state.step, S.scalar_sharding(ctx))
            _record(leaves, "batch", batch, b_shard)
        elif kind == "prefill":
            batch, b_shard = batch_of(inputs)
            if cfg.encdec:
                run = lambda: encdec.apply(model, batch["tokens"], batch["frames"], cfg)  # noqa
            else:
                run = lambda: decoder.apply(  # noqa: E731
                    model, batch["tokens"], cfg, visual_embeds=batch.get("visual_embeds"))
            args = {"params": named, "batch": batch}
            _record(leaves, "params", named, p_shard)
            _record(leaves, "batch", batch, b_shard)
        else:  # decode
            c_shard = S.cache_shardings(ctx, inputs["caches"])
            caches = _distribute_tree(inputs["caches"], c_shard, maker)
            token, t_shard = batch_of({"token": inputs["token"]})
            cfg_d = dataclasses.replace(cfg, max_target_length=shape.seq_len + 8)
            cur_len = shape.seq_len
            step_fn = encdec.decode_step if cfg.encdec else decoder.decode_step
            run = lambda: step_fn(model, token["token"], caches, cur_len, cfg_d)  # noqa: E731
            # cur_len: rank 0 holds the reference's int32 scalar; the port's
            # decode step takes its value as an int.
            cur = maker.dtensor(S.scalar_sharding(ctx), (), torch.int32, zero=True)
            args = {"params": named, "token": token, "caches": caches, "cur_len": cur}
            _record(leaves, "params", named, p_shard)
            _record(leaves, "token", token["token"], t_shard["token"])
            _record(leaves, "caches", caches, c_shard)
            _record(leaves, "cur_len", cur, S.scalar_sharding(ctx))
    return Cell(meta, ctx, run, args, leaves)


def _distribute_tree(tree, shard, maker):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_distribute_tree(t, s, maker) for t, s in zip(tree, shard)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_distribute_tree(t, s, maker) for t, s in zip(tree, shard))
    return maker.dtensor(shard, tuple(tree.shape), tree.dtype, zero=True)


def run_step(cell: Cell, *, fake: bool = True):
    """Run the cell's step once in its ctx; fake cells under a `LocalCensus`
    (returned), real ones plainly (None)."""
    grad = cell.meta["kind"] == "train"
    # Under the mesh ctx, tensors the step makes itself (positions, masks,
    # scalars) are the same on every device: replicated (`use_ctx`).
    with use_ctx(cell.ctx), torch.set_grad_enabled(grad):
        if not fake:
            out = cell.run()
            return None, out
        census = LocalCensus(known=_leaves(cell.args))
        fake_mode = _fake_mode_of(cell.args)
        fake_mode.census = census
        try:
            with fake_mode:
                out = cell.run()
        finally:
            fake_mode.census = None
            _clear_device_caches()
        return census, out


def _fake_mode_of(args):
    for t in _leaves(args):
        mode = getattr(_local(t), "fake_mode", None)
        if mode is not None:
            return mode
    raise ValueError("the cell's arguments are not fake tensors")


def run_cell(arch: str, shape_name: str, multi_pod: bool, analyze: bool = True,
             device="cuda") -> dict:
    if analyze:
        raise ValueError("analyze=True reads benchmarks/hlo_analysis.py's jaxpr analyzer, "
                         "which is not ported (ROADMAP item 1): pass --no-analyze")
    init_fake_world(multi_pod)
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape_name, multi_pod, device)
    except SkipCell as e:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": str(e)}
    t_build = time.perf_counter() - t0
    census, out = run_step(cell)
    t_run = time.perf_counter() - t0 - t_build
    arg_bytes = local_bytes(cell.args)
    row = dict(cell.meta)
    row.update(
        status="ok",
        device=str(torch.device(device).type),
        lower_s=round(t_build, 1),
        compile_s=round(t_run, 1),
        memory={
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(local_bytes(out)),
            "temp_bytes": int(census.peak),
            "code_bytes": 0,
        },
        xla_cost={
            "flops_body_once": float(census.flops),
            "bytes_body_once": -1.0,
        },
        collectives={"counts": dict(census.counts), "bytes_once": dict(census.bytes)},
    )
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-analyze", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = LM_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    rows = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                print(f"=== {arch} x {shape} x {'2x16x16' if mp else '16x16'} ===", flush=True)
                t0 = time.perf_counter()
                try:
                    row = run_cell(arch, shape, mp, analyze=not args.no_analyze,
                                   device=args.device)
                except Exception as e:  # noqa: BLE001 - report and continue
                    traceback.print_exc()  # to stderr; the row goes to stdout
                    row = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error", "error": f"{type(e).__name__}: {e}"[:1500]}
                row["seconds"] = round(time.perf_counter() - t0, 2)
                print(json.dumps(row), flush=True)  # whole: one JSON row a line
                rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {len(rows)} rows to {args.out}")
    return rows


if __name__ == "__main__":
    main()
