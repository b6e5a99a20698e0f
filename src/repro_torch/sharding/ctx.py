"""Logical-axis sharding context (MaxText-style rules, hand-rolled).

Model code names the logical axes of its tensors ("batch", "embed",
"heads", "mlp", "experts", ...).  A ``ShardingCtx`` binds a mesh shape
(``{mesh axis: size}``), optionally the ``DeviceMesh`` it describes, and a
logical -> physical mapping; ``spec`` resolves a tuple of logical names to
a partition spec: a tuple with one entry a dimension, ``None``
(replicated), a mesh axis name, or a tuple of mesh axis names.

Divisibility guard: a logical axis only maps to a physical mesh axis when
the dimension size divides evenly; otherwise it falls back to replication
(gemma's single KV head on a 16-wide model axis).  A mesh axis already
claimed by an earlier dimension is dropped: earlier dims win.

The reference's JAX pieces map onto DTensor:

* ``NamedSharding(mesh, spec)`` -> `NamedSharding` here, a frozen
  ``(mesh, spec, placements)``: one placement a mesh dimension,
  ``Shard(d)`` where the spec puts tensor dim ``d`` on that mesh axis.  A
  spec entry of several axes (``("pod", "data")``) shards one dim over
  them major to minor; DTensor's ``[Shard(0), Shard(0)]`` shards over the
  mesh dims in mesh order, so the two agree only while the tuple is in
  mesh order.  A tuple out of mesh order is refused (ValueError), never
  reordered.
* ``with_sharding_constraint`` -> ``DTensor.redistribute``: `shard_constraint`
  redistributes a DTensor when the active ctx has a mesh, and returns any
  other tensor unchanged (one device runs every tensor whole, the same
  model code).
* ``shard_map`` -> ``torch.distributed.tensor.experimental.local_map``:
  `shard_map` takes the reference's specs.  Inside, `axis_index`, `psum`,
  `pmean` and `all_gather` are the named-axis collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

# Default logical -> physical mapping.  "pod" multiplies the batch axes when
# present (multi-pod meshes); tensor-parallel axes all map to "model".
DEFAULT_RULES: Mapping[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),  # replicated by default; long-context configs override
    "seq_shard": ("data",),  # explicit sequence parallelism
    # Params' embed dim shards over the data axis: FSDP/ZeRO-style — weights
    # and optimizer state distribute over BOTH mesh axes, gathered on use.
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "lora": ("data",),  # MLA low-rank dims: FSDP-shard like embed
    "cache_seq": (),
    "cache_head_dim": (),  # decode fallback when kv_heads don't divide
    "qkv": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "layers": (),
    "conv": (),
    "ssm_heads": ("model",),
    "state": (),
}


def _dtensor():
    import torch.distributed.tensor as dt

    return dt


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor().DTensor)


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def spec_placements(mesh, spec) -> tuple:
    """One DTensor placement a mesh dim for the partition ``spec``.

    Raises ValueError for an axis the mesh does not have, an axis used
    twice, or a multi-axis entry out of mesh order."""
    dt = _dtensor()
    axes = mesh_axes(mesh)
    out = [dt.Replicate() for _ in axes]
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in names:
            if a not in axes:
                raise ValueError(f"spec {spec}: mesh {axes} has no axis {a!r}")
            if a in seen:
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            seen.add(a)
            idx.append(axes.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: {names} is out of mesh order {axes}; DTensor shards a dim "
                f"over mesh dims in mesh order, so the tuple must follow it")
        for i in idx:
            out[i] = dt.Shard(dim)
    return tuple(out)


def local_shape(mesh, spec, shape) -> tuple:
    """The shape of one device's block of a tensor of global ``shape``
    (the specs here shard only dims they divide)."""
    sizes = dict(zip(mesh_axes(mesh), mesh.mesh.shape))
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            if out[dim] % sizes[a]:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not divide over {a!r}")
            out[dim] //= sizes[a]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding``: a mesh, a partition spec, and the
    DTensor placements the spec gives on that mesh."""

    mesh: Any
    spec: tuple
    placements: tuple

    def shard_shape(self, shape) -> tuple:
        return local_shape(self.mesh, self.spec, shape)

    def index(self, coordinate, shape) -> tuple:
        """The slices of a tensor of ``shape`` held by the device at mesh
        ``coordinate`` (DTensor's own offsets, for any coordinate)."""
        from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

        lshape, offset = _compute_local_shape_and_global_offset(
            tuple(shape), tuple(self.mesh.mesh.shape), list(coordinate), self.placements)
        return tuple(slice(o, o + n) for o, n in zip(offset, lshape))


@dataclasses.dataclass
class ShardingCtx:
    mesh_shape: Optional[Mapping[str, int]] = None  # mesh axis -> size, in mesh order
    rules: Mapping[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )
    mesh: Any = None  # a torch.distributed DeviceMesh, or None (shape-only)

    def __post_init__(self):
        if self.mesh is not None:
            shape = dict(zip(mesh_axes(self.mesh), (int(n) for n in self.mesh.mesh.shape)))
            if self.mesh_shape is not None and dict(self.mesh_shape) != shape:
                raise ValueError(f"mesh_shape {dict(self.mesh_shape)} is not the mesh's {shape}")
            self.mesh_shape = shape
        if self.mesh_shape is None:
            raise ValueError("a ShardingCtx needs a mesh_shape or a DeviceMesh")

    @classmethod
    def over(cls, mesh, rules: Optional[Mapping[str, Tuple[str, ...]]] = None) -> "ShardingCtx":
        """The context of a ``DeviceMesh`` (the reference's ``ShardingCtx(mesh, rules)``)."""
        return cls(None, dict(DEFAULT_RULES) if rules is None else dict(rules), mesh)

    def axis_size(self, names: Sequence[str]) -> int:
        size = 1
        for nm in names:
            if nm in self.mesh_shape:
                size *= self.mesh_shape[nm]
        return size

    def spec(self, logical: Sequence[Optional[str]], dims: Sequence[int] | None = None) -> tuple:
        """Partition spec for a tuple of logical names (None = replicated).

        When ``dims`` is given, any logical axis whose physical shard count
        does not divide the dim size falls back to replication.  A mesh axis
        already claimed by an earlier dim is dropped (a spec may not repeat
        axes) — earlier dims win.
        """
        parts = []
        used: set = set()
        for k, name in enumerate(logical):
            if name is None:
                parts.append(None)
                continue
            phys = tuple(
                a
                for a in self.rules.get(name, ())
                if a in self.mesh_shape and a not in used
            )
            if not phys:
                parts.append(None)
                continue
            if dims is not None:
                n = self.axis_size(phys)
                if n <= 1 or dims[k] % n != 0:
                    parts.append(None)
                    continue
            used.update(phys)
            parts.append(phys if len(phys) > 1 else phys[0])
        return tuple(parts)

    def _need_mesh(self):
        if self.mesh is None:
            raise ValueError("this ShardingCtx has a mesh shape but no DeviceMesh")
        return self.mesh

    def placements(self, spec) -> tuple:
        """One placement a mesh dim for ``spec`` (`spec_placements`)."""
        return spec_placements(self._need_mesh(), spec)

    def sharding(self, logical: Sequence[Optional[str]], dims=None) -> NamedSharding:
        spec = self.spec(logical, dims)
        return NamedSharding(self._need_mesh(), spec, self.placements(spec))

    def spec_sharding(self, spec) -> NamedSharding:
        """The `NamedSharding` of an explicit partition spec."""
        return NamedSharding(self._need_mesh(), tuple(spec), self.placements(spec))


_local = threading.local()


def set_ctx(ctx: Optional[ShardingCtx]) -> None:
    _local.ctx = ctx


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardingCtx]):
    """Make ``ctx`` the active context.  Under a ctx with a ``DeviceMesh``
    a plain tensor meeting a DTensor is taken as replicated
    (``implicit_replication``): the positions, masks and scalars a step
    makes are the same on every device."""
    prev = current_ctx()
    set_ctx(ctx)
    # implicit_replication() turns the flag off when it exits, nested or
    # not: only a thread's outermost mesh context enters it.
    outermost = ctx is not None and ctx.mesh is not None and not getattr(_local, "replicating",
                                                                          False)
    try:
        if outermost:
            from torch.distributed.tensor.experimental import implicit_replication

            _local.replicating = True
            try:
                with implicit_replication():
                    yield ctx
            finally:
                _local.replicating = False
        else:
            yield ctx
    finally:
        set_ctx(prev)


def shard_constraint(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute a DTensor ``x`` to the active ctx's sharding of
    ``logical`` (the reference's ``with_sharding_constraint``); any other
    ``x``, or no ctx with a mesh, returns ``x`` itself."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not is_dtensor(x):
        return x
    return _Constrain.apply(x, ctx.mesh, ctx.placements(ctx.spec(logical, tuple(x.shape))))


class _Constrain(torch.autograd.Function):
    """A redistribution whose cotangent takes the same placements (the
    transpose of ``with_sharding_constraint`` is the same constraint)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x if tuple(x.placements) == want else x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor
    and ``t`` is not (a table the step made, the same on every device);
    otherwise ``t``.  Implicit replication covers a plain tensor in the
    forward, but an op's backward may run on autograd's device thread,
    which does not see it: a plain tensor an op saves for its backward
    (RoPE's cos and sin) must be a DTensor there."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    dt = _dtensor()
    return dt.DTensor.from_local(t, x.device_mesh, [dt.Replicate()] * x.device_mesh.ndim,
                                 run_check=False)


def replicate_dims(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """A DTensor ``x`` redistributed so that none of ``dims`` is sharded
    (the other placements kept); any other ``x`` unchanged.  For a product
    that merges a sharded minor dim into a major one, which DTensor's view
    rules cannot shard."""
    if not is_dtensor(x):
        return x
    dt = _dtensor()
    dims = {d % x.dim() for d in dims}
    want = tuple(dt.Replicate() if getattr(pl, "dim", None) in dims else pl
                 for pl in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def _reshape_groups(src, dst):
    """Pair the dims of shapes ``src`` and ``dst`` (size-1 dims left out:
    a spec never shards them) into groups of equal products:
    ``[(src dims, dst dims)]``."""
    si = [i for i, n in enumerate(src) if n != 1]
    dj = [j for j, n in enumerate(dst) if n != 1]
    groups, a, b = [], 0, 0
    while a < len(si) and b < len(dj):
        gi, gj = [si[a]], [dj[b]]
        pi, pj = src[si[a]], dst[dj[b]]
        a, b = a + 1, b + 1
        while pi != pj:
            if pi < pj:
                pi *= src[si[a]]
                gi.append(si[a])
                a += 1
            else:
                pj *= dst[dj[b]]
                gj.append(dj[b])
                b += 1
        groups.append((gi, gj))
    return groups


def reshape(x: torch.Tensor, shape) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor is first gathered on each sharded
    dim that DTensor's view rules cannot carry over: a dim merged into a
    major one, a dim split into parts whose major one its shards do not
    divide, a dim in a group that is both.  Its gradient is reshaped back
    the same way."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, g):
        return (_reshape_dtensor(g, ctx.in_shape) if is_dtensor(g) else g.reshape(ctx.in_shape),
                None)


def _reshape_dtensor(x, shape):
    shape = tuple(shape)
    if -1 in shape:
        known = 1
        for n in shape:
            known *= n if n != -1 else 1
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    sizes = dict(enumerate(int(n) for n in x.device_mesh.mesh.shape))
    shards = {}
    for m, pl in enumerate(x.placements):
        if getattr(pl, "dim", None) is not None and pl.is_shard():
            shards[pl.dim] = shards.get(pl.dim, 1) * sizes[m]
    gather = []
    for gi, gj in _reshape_groups(tuple(x.shape), shape):
        for k, d in enumerate(gi):
            if d not in shards:
                continue
            if len(gi) == 1 and shape[gj[0]] % shards[d] == 0:
                continue  # kept, or split with the major part divisible
            if len(gj) == 1 and k == 0:
                continue  # the major dim of a merge
            gather.append(d)
    if gather:
        x = replicate_dims(x, gather)
    if any(pl.is_partial() for pl in x.placements):
        # A partial sum is summed first: a reshape that copies would
        # otherwise scatter it over a dim DTensor picks (the sequence).
        dt = _dtensor()
        x = x.redistribute(x.device_mesh, tuple(dt.Replicate() if pl.is_partial() else pl
                                                for pl in x.placements))
    return x.reshape(shape)


def gather_on_use(p: torch.Tensor) -> torch.Tensor:
    """A DTensor parameter with its shards over the batch axes ("pod",
    "data") gathered, its tensor-parallel ("model") shards kept: the
    rules' FSDP/ZeRO layout, "gathered on use".  The gradient is
    scattered back over those axes (a reduce-scatter).  Any other tensor
    unchanged.  Left to DTensor, a product of a batch-sharded activation
    and a data-sharded weight may shard its output over the sequence,
    whose gradient its products cannot shard (ROADMAP §3)."""
    if not is_dtensor(p):
        return p
    dt = _dtensor()
    names = mesh_axes(p.device_mesh)
    want = tuple(dt.Replicate() if names[i] in ("pod", "data") and pl.is_shard() else pl
                 for i, pl in enumerate(p.placements))
    return p if want == tuple(p.placements) else p.redistribute(p.device_mesh, want)


def logical_sharding(shape: Sequence[int], logical: Sequence[Optional[str]]):
    """`NamedSharding` for a parameter of known shape; None without a ctx
    with a mesh."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return None
    return ctx.sharding(logical, tuple(shape))


# --- shard_map and the named-axis collectives ----------------------------------------


def _placements_tree(mesh, specs):
    """Placements for one spec, or a tuple of them for a tuple of `P`s."""
    if specs is None:
        return None
    if (isinstance(specs, (list, tuple)) and not isinstance(specs, P) and specs
            and all(isinstance(s, P) or s is None for s in specs)):
        return tuple(None if s is None else spec_placements(mesh, s) for s in specs)
    return list(spec_placements(mesh, specs))  # local_map: a list for one output


class P(tuple):
    """The reference's ``PartitionSpec``: ``P("model", None)``.  A tuple of
    `P`s is a tuple of specs (one an output), any other tuple one spec."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def shard_map(f, mesh, *, in_specs, out_specs):
    """``f`` over each device's local blocks (``local_map``): DTensor
    arguments are redistributed to ``in_specs`` (a spec a positional
    argument; None for an argument that is not a tensor) and ``f``'s
    local outputs become DTensors of ``out_specs``.  ``f`` reaches the
    other devices only through `psum`, `pmean` and `all_gather`.  Called
    with no DTensor argument, ``f`` runs on the tensors as given (each
    device's own block) and its outputs stay plain.

    Gradients are partial sums, as JAX transposes ``shard_map``: an
    argument replicated over a mesh axis may be used differently on each
    device of it (the KV heads each query-head block reads, the routing of
    each device's experts), so its gradient is the sum of every device's
    (``Partial`` over that axis).  An output replicated over an axis is
    the same on each device of it, and only the first device of the axis
    takes its cotangent; `psum`'s gradient is the sum of its cotangents."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    in_placements = tuple(None if s is None else spec_placements(mesh, s) for s in in_specs)
    out_placements = _placements_tree(mesh, out_specs)
    sizes = tuple(int(n) for n in mesh.mesh.shape)
    grad_placements = tuple(
        None if p is None else tuple(Partial() if isinstance(q, Replicate) and n > 1 else q
                                     for q, n in zip(p, sizes))
        for p in in_placements)
    single = isinstance(out_placements, list)

    def local(*args):
        out = f(*args)
        if single:
            return _first_takes_cotangent(out, mesh, out_placements)
        return tuple(o if p is None else _first_takes_cotangent(o, mesh, p)
                     for o, p in zip(out, out_placements))

    mapped = local_map(local, out_placements=out_placements, in_placements=in_placements,
                       in_grad_placements=grad_placements, device_mesh=mesh,
                       redistribute_inputs=True)

    def run(*args):
        return mapped(*args) if any(is_dtensor(a) for a in args) else f(*args)

    return run


def _first_takes_cotangent(y, mesh, placements):
    """``y``, whose cotangent is kept on the first device of each mesh axis
    (of size > 1) that ``placements`` replicate it over, zero elsewhere."""
    from torch.distributed.tensor import Replicate

    if not (isinstance(y, torch.Tensor) and y.requires_grad):
        return y
    axes = mesh_axes(mesh)
    first = all(mesh.get_local_rank(axes[i]) == 0 for i, q in enumerate(placements)
                if isinstance(q, Replicate) and int(mesh.mesh.shape[i]) > 1)
    return y if first else _ZeroCotangent.apply(y)


class _ZeroCotangent(torch.autograd.Function):
    """The identity, whose cotangent is zero."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def blockwise(fn, logical, out=0):
    """``fn`` made to run on each device's block under a mesh ctx: when the
    active ctx has a ``DeviceMesh`` and the first argument is a DTensor,
    ``fn`` runs through `shard_map` with the ctx's spec of each argument's
    ``logical`` axes (None for an argument that is not a tensor), and its
    output takes the spec of argument ``out`` (a tuple of indices: one an
    output).  For a region that is independent across the dims it shards
    (a scan over the sequence, per batch row and head): DTensor's rules
    would merge sharded batch dims into strided shards its products
    refuse, and a Python loop of DTensor ops is slow to trace.  Otherwise
    ``fn`` itself."""
    def run(*args):
        ctx = current_ctx()
        if ctx is None or ctx.mesh is None or not is_dtensor(args[0]):
            return fn(*args)
        specs = tuple(None if lg is None else P(*ctx.spec(lg, tuple(a.shape)))
                      for a, lg in zip(args, logical))
        out_specs = tuple(specs[i] for i in out) if isinstance(out, tuple) else specs[out]
        return shard_map(fn, ctx.mesh, in_specs=specs, out_specs=out_specs)(*args)

    return run


def axis_size(mesh, names) -> int:
    axes = mesh_axes(mesh)
    n = 1
    for a in (names,) if isinstance(names, str) else names:
        n *= int(mesh.mesh.shape[axes.index(a)])
    return n


def axis_index(mesh, name: str) -> int:
    """This device's index along the mesh axis ``name`` (``lax.axis_index``)."""
    return int(mesh.get_local_rank(name))


def _all_reduce(x, mesh, names):
    import torch.distributed._functional_collectives as funcol

    for a in names:
        x = funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, mesh_axes(mesh).index(a))))
    return x


class _PSum(torch.autograd.Function):
    """A sum over mesh axes whose gradient is the sum of the cotangents
    over the same axes (`shard_map`'s gradients are partial sums)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return _all_reduce(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.names), None, None


def psum(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """Sum ``x`` over the mesh axes ``names`` (``lax.psum``), one axis at
    a time in the order given; axes of size 1 are skipped."""
    names = (names,) if isinstance(names, str) else tuple(names)
    names = tuple(a for a in names if axis_size(mesh, a) > 1)
    if not names:
        return x
    return _PSum.apply(x, mesh, names)


def pmax(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """The max of ``x`` over the mesh axes ``names`` (no gradient)."""
    import torch.distributed._functional_collectives as funcol

    names = (names,) if isinstance(names, str) else tuple(names)
    for a in names:
        if axis_size(mesh, a) > 1:
            x = funcol.wait_tensor(funcol.all_reduce(x.detach(), "max",
                                                     (mesh, mesh_axes(mesh).index(a))))
    return x


def pmean(x: torch.Tensor, mesh, names) -> torch.Tensor:
    return psum(x, mesh, names) / axis_size(mesh, names)


def all_gather(x: torch.Tensor, mesh, name: str, dim: int = 0) -> torch.Tensor:
    """Concatenate every device's ``x`` along ``dim`` in mesh order over
    the axis ``name`` (``lax.all_gather(..., tiled=True)``); the gradient
    is the reduce-scatter of the cotangent."""
    if axis_size(mesh, name) == 1:
        return x
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(
        funcol.all_gather_tensor_autograd(x.contiguous(), dim, (mesh, mesh_axes(mesh).index(name))))
