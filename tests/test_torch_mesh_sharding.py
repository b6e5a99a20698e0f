"""Each device's block of every leaf over a mesh, against the reference's.

For every parameter, decode cache and batch leaf of two smoke configs
(gemma-2b, dense; deepseek-v3, MoE + MLA) on a ``(2, 4)`` ``("data",
"model")`` mesh and a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh, the
slices each mesh coordinate holds under the port's shardings
(`launch.specs` over ``ShardingCtx.over(mesh)``; DTensor's own offsets,
`sharding.NamedSharding.index`) equal the reference's
``NamedSharding.devices_indices_map`` index for index.  The reference needs
8 forced host devices and the port an 8-rank fake world, so each side
runs in one child (this file run as a script).  The reference's stacked
layer leaves hold every layer whole along their first axis.

In process: `shard_constraint` returns a plain tensor itself, with or
without a context; a spec tuple out of mesh order is refused.
"""

import json
import os
import sys
import types

import pytest
import torch

from torch_gloo import Child

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

ARCHS = ("gemma-2b", "deepseek-v3-671b")
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
B, S = 8, 16


def _coords(shape):
    import itertools

    return list(itertools.product(*(range(n) for n in shape)))


def _norm(index, shape):
    return [[s.start or 0, shape[i] if s.stop is None else s.stop] for i, s in enumerate(index)]


def _ref_side():
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs.registry import get_config
    from repro.launch import specs as J
    from repro.models import decoder
    from repro.nn.param import split_tree
    from repro.sharding import ShardingCtx

    assert len(jax.devices()) == 8
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        # Shapes and dtypes are all a sharding needs.
        values, logical = split_tree(jax.eval_shape(
            lambda: decoder.init_params(jax.random.PRNGKey(0), cfg)))
        caches = jax.eval_shape(lambda: decoder.init_decode_caches(cfg, B, S))
        batch = {"tokens": jax.numpy.zeros((B, S), jax.numpy.int32)}
        for mname, (shape, axes) in MESHES.items():
            mesh = Mesh(np.asarray(jax.devices()).reshape(shape), axes)
            ctx = ShardingCtx(mesh)
            trees = {"params": (values, J.param_shardings(ctx, values, logical)),
                     "caches": (caches, J.cache_shardings(ctx, caches)),
                     "batch": (batch, J.batch_shardings(ctx, batch))}
            leaves = {}
            for group, (vals, shards) in trees.items():
                flat = jax.tree_util.tree_flatten_with_path(vals)[0]
                for (path, leaf), sh in zip(flat, jax.tree_util.tree_leaves(shards)):
                    name = group + "." + ".".join(
                        str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", ""))))
                        for p in path)
                    dmap = sh.devices_indices_map(leaf.shape)
                    leaves[name] = {
                        ",".join(map(str, np.argwhere(mesh.devices == d)[0])): _norm(ix,
                                                                                    leaf.shape)
                        for d, ix in dmap.items()}
            out[f"{arch}/{mname}"] = leaves
    return out


def _port_side():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder
    from repro_torch.nn.param import STACKS, leaf_groups
    from repro_torch.sharding import ShardingCtx, shard_constraint, use_ctx

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        model = decoder.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        named = dict(model.named_parameters())
        caches = decoder.init_decode_caches(cfg, B, S, device="cpu")
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
        for mname, (shape, axes) in MESHES.items():
            ctx = ShardingCtx.over(make_mesh(shape, axes, "cpu"))
            with use_ctx(ctx):
                plain = torch.ones(3)
                out["constraint_keeps_plain"] = shard_constraint(plain, ("batch",)) is plain
            p_shard = specs.param_shardings(ctx, named, model.logical_axes())
            leaves = {}
            for ref, names in leaf_groups(named):
                stacked = ref.split(".")[0] in STACKS
                per = {}
                for c in _coords(shape):
                    idx = [_norm(p_shard[n].index(c, named[n].shape), named[n].shape)
                           for n in names]
                    assert all(i == idx[0] for i in idx), ref
                    per[",".join(map(str, c))] = ([[0, len(names)]] if stacked else []) + idx[0]
                leaves["params." + ref] = per
            c_shard = specs.cache_shardings(ctx, caches)
            for field in caches.kv._fields:
                t, sh = getattr(caches.kv, field), getattr(c_shard.kv, field)
                leaves[f"caches.kv.{field}"] = {",".join(map(str, c)): _norm(sh.index(c, t.shape),
                                                                              t.shape)
                                                for c in _coords(shape)}
            b_shard = specs.batch_shardings(ctx, batch)
            leaves["batch.tokens"] = {",".join(map(str, c)): _norm(
                b_shard["tokens"].index(c, (B, S)), (B, S)) for c in _coords(shape)}
            out[f"{arch}/{mname}"] = leaves
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """{side: what its child found}; the two children run at once."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _SRC, "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    with Child([sys.executable, __file__, "ref", str(tmp / "ref.json")], env) as ref, \
            Child([sys.executable, __file__, "port", str(tmp / "port.json")], env) as port:
        ref.wait()
        port.wait()
    out = {}
    for side in ("ref", "port"):
        with open(tmp / f"{side}.json") as f:
            out[side] = json.load(f)
    return out


@pytest.fixture(scope="module")
def ref(sides):
    return sides["ref"]


@pytest.fixture(scope="module")
def port(sides):
    return sides["port"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leafs_blocks_are_the_references(arch, mesh, ref, port):
    want, got = ref[f"{arch}/{mesh}"], port[f"{arch}/{mesh}"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_constraint_keeps_a_plain_tensor_over_a_mesh(port):
    assert port["constraint_keeps_plain"] is True


def test_constraint_keeps_a_plain_tensor_without_a_mesh():
    from repro_torch.sharding import ShardingCtx, shard_constraint, use_ctx

    x = torch.ones(4, 2)
    assert shard_constraint(x, ("batch", None)) is x
    with use_ctx(ShardingCtx({"data": 2, "model": 2})):
        assert shard_constraint(x, ("batch", None)) is x


def test_spec_tuples_out_of_mesh_order_are_refused():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.ctx import spec_placements

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert spec_placements(mesh, (("pod", "data"), None)) == (Shard(0), Shard(0), Replicate())
    assert spec_placements(mesh, (("data", "model"), None)) == (Replicate(), Shard(0), Shard(0))
    with pytest.raises(ValueError, match="out of mesh order"):
        spec_placements(mesh, (("data", "pod"), None))
    with pytest.raises(ValueError, match="out of mesh order"):
        spec_placements(mesh, (("model", "data"),))
    with pytest.raises(ValueError, match="used twice"):
        spec_placements(mesh, ("data", "data"))
    with pytest.raises(ValueError, match="no axis"):
        spec_placements(mesh, ("expert",))


if __name__ == "__main__":
    side, path = sys.argv[1], sys.argv[2]
    result = _ref_side() if side == "ref" else _port_side()
    with open(path, "w") as f:
        json.dump(result, f)
