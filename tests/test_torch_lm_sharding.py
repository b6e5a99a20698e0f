"""The port's sharding rules (`repro_torch.sharding`) against the
reference's: ``tests/test_sharding.py``'s cases on both contexts (the
reference's over a fake mesh, the port's over the same mesh shape), every
pair of rule names over a grid of dims, and the hypothesis property over
random names and dims (where hypothesis is installed)."""

import itertools

import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch
from hypothesis import given
from jax.sharding import Mesh, PartitionSpec as P

from repro.sharding import ShardingCtx as JCtx
from repro.sharding.ctx import DEFAULT_RULES as JRULES
from repro_torch.sharding import ShardingCtx, current_ctx, set_ctx, shard_constraint, use_ctx
from repro_torch.sharding.ctx import DEFAULT_RULES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def fake_mesh(shape=(2, 2), axes=("data", "model")):
    devs = np.asarray(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


def both(shape=(2, 2), axes=("data", "model")):
    return JCtx(fake_mesh(shape, axes)), ShardingCtx(dict(zip(axes, shape)))


def same(jctx, ctx, logical, dims):
    want = jctx.spec(logical, dims)
    got = ctx.spec(logical, dims)
    assert P(*got) == want, (logical, dims, got, want)
    return got


def test_rules_are_the_references():
    assert dict(DEFAULT_RULES) == dict(JRULES)


def test_basic_resolution():
    assert same(*both(), ("batch", None, "mlp"), (8, 4, 8)) == ("data", None, "model")


def test_divisibility_fallback():
    assert same(*both(), ("mlp",), (3,)) == (None,)
    assert same(*both(), ("mlp",), (4,)) == ("model",)


def test_axis_conflict_dedup():
    assert same(*both(), ("heads", "kv_heads"), (4, 4)) == ("model", None)


def test_missing_mesh_axis_ignored():
    assert same(*both(), ("batch",), (4,)) == ("data",)


def test_multi_axis_logical():
    ctxs = both((2, 2, 1), ("pod", "data", "model"))
    assert same(*ctxs, ("batch",), (8,)) == (("pod", "data"),)
    assert same(*ctxs, ("batch",), (6,)) == (None,)


def test_shard_constraint_noop_without_ctx():
    x = torch.ones((4, 4))
    assert shard_constraint(x, ("batch", None)) is x
    _, ctx = both()
    with use_ctx(ctx):
        assert current_ctx() is ctx
        assert shard_constraint(x, ("batch", None)) is x
    assert current_ctx() is None
    set_ctx(ctx)
    assert current_ctx() is ctx
    set_ctx(None)


@pytest.mark.parametrize("mesh", [((2, 2), ("data", "model")), ((2, 4, 3), ("pod", "data", "model")),
                                  ((16,), ("model",))], ids=["2x2", "pod", "model16"])
def test_every_pair_of_names_over_a_grid_of_dims(mesh):
    """Every ordered pair of rule names (and None), dims 1-33 by steps:
    the port's spec is the reference's."""
    jctx, ctx = both(*mesh)
    names = sorted(DEFAULT_RULES) + [None, "not-a-rule"]
    for a, b in itertools.product(names, names):
        for dims in ((1, 1), (2, 8), (3, 16), (4, 6), (12, 33), (24, 24), (16, 2), (48, 5)):
            same(jctx, ctx, (a, b), dims)
        same(jctx, ctx, (a, b), None)


@given(
    dims=st.tuples(st.integers(1, 33), st.integers(1, 33)),
    names=st.tuples(
        st.sampled_from(sorted(DEFAULT_RULES)), st.sampled_from(sorted(DEFAULT_RULES))
    ),
)
def test_spec_equals_the_references_property(dims, names):
    jctx, ctx = both()
    spec = same(jctx, ctx, names, dims)
    flat = []
    for part in spec:
        if part is None:
            continue
        flat.extend(part if isinstance(part, tuple) else (part,))
    assert len(flat) == len(set(flat))
    for d, part in zip(dims, spec):
        if part is not None:
            assert d % ctx.axis_size(part if isinstance(part, tuple) else (part,)) == 0
