"""Expert-parallel MoE (`repro_torch.nn.moe` over a mesh) against the reference's.

The port runs ``moe_apply`` on 4 gloo ranks (one process a rank, a
``(1, 4)`` ``("data", "model")`` mesh: each rank holds 2 of 8 experts) with
``combine="psum"`` and ``"gather"``; the reference runs its ``moe_apply``
under ``ShardingCtx(make_host_mesh(1, 4))`` on 4 forced host devices (one
child, this file run as a script), on the same numpy weights and tokens.

* the dropped (token, expert) pairs are the reference's, pair for pair;
* y and aux are within §3w's ``F32_LAYER`` of the reference's EP and local
  results (scaled error; aux relative);
* ``"gather"`` is the port's local path bit for bit: the compact outputs
  are gathered in expert order and combined as the local path combines;
* ``"psum"`` sums the ranks' partial outputs in gloo's order, not the local
  path's ascending-expert order: within ``F32_EP_SUM`` (2^-22 scaled) of
  the local path, and so of ``"gather"``.  Measured: 0 at top-2 (a sum of
  two is order-free), 6.7e-8 at top-3.

Two cases: softmax top-2 with a capacity that drops, and DeepSeek-V3's
sigmoid top-3 with a selection bias and normalized, scaled weights.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_gloo import Child, run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

#: The port's cross-rank sum of partial outputs against its local order.
F32_EP_SUM = 2.0 ** -22

CASES = {
    "softmax-drops": dict(num_experts=8, top_k=2, d_ff_expert=16, capacity_factor=0.25),
    "sigmoid-top3": dict(num_experts=8, top_k=3, d_ff_expert=32, capacity_factor=2.0,
                         routing="sigmoid", norm_topk=True, routed_scaling=2.5),
}
D, SHAPE = 16, (2, 32, 16)


def _inputs(name):
    """The case's weights (the reference's init, as numpy) and tokens."""
    import jax

    from repro.nn import moe as jmoe
    from repro.nn.param import split_tree

    jcfg = jmoe.MoEConfig(**CASES[name])
    values, _ = split_tree(jmoe.moe_init(jax.random.PRNGKey(3), D, jcfg))
    p = {k: np.asarray(v) for k, v in values.items()}
    if "router_bias" in p:
        p["router_bias"] = np.random.default_rng(4).normal(size=p["router_bias"].shape).astype(
            np.float32) * 0.1
    x = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    return p, x


def _ref_side(path):
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_host_mesh
    from repro.nn import moe as jmoe
    from repro.sharding import ShardingCtx, use_ctx

    assert len(jax.devices()) == 4
    out = {}
    for name in CASES:
        p, x = _inputs(name)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        for combine in ("psum", "gather"):
            jcfg = jmoe.MoEConfig(**CASES[name], combine=combine)
            with use_ctx(ShardingCtx(make_host_mesh(1, 4))):
                y, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, dtype=jnp.float32))(
                    jp, jnp.asarray(x))
            out[f"{name}/{combine}/y"], out[f"{name}/{combine}/aux"] = np.asarray(y), np.asarray(aux)
        jcfg = jmoe.MoEConfig(**CASES[name])
        y, aux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, dtype=jnp.float32))(
            jp, jnp.asarray(x))
        out[f"{name}/local/y"], out[f"{name}/local/aux"] = np.asarray(y), np.asarray(aux)
        x2d = jnp.asarray(x.reshape(-1, D))
        w, ids, _ = jmoe._route(jp, x2d, jcfg)
        _, st, _, _, dest_global, C = jmoe._dispatch(x2d, w, ids, jcfg, 0, jcfg.num_experts,
                                                     jnp.float32)
        flat = np.asarray(ids).reshape(-1)
        se = flat[np.argsort(flat, kind="stable")]
        drop = np.asarray(dest_global) == jcfg.num_experts * C
        pairs = np.stack([np.asarray(st)[drop], se[drop]], 1)
        out[f"{name}/dropped"] = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    np.savez(path, **out)


def _ep_rank(rank, n, path):
    """One rank of the port's expert-parallel run (every case, both
    combines): the forward on ``(1, n)``, and the gradients on ``(1, n)``
    and ``(2, n / 2)``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn import moe
    from repro_torch.sharding import ShardingCtx, use_ctx

    ctxs = {mesh: ShardingCtx.over(make_host_mesh(*shape, device="cpu"))
            for mesh, shape in GRAD_MESHES.items()}
    data = np.load(path + ".in.npz")
    out = {}
    for name in CASES:
        p = {k.split("/", 1)[1]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith(name + "/") and not k.endswith("/x")}
        x = torch.from_numpy(data[f"{name}/x"])
        for combine in ("psum", "gather"):
            cfg = moe.MoEConfig(**CASES[name], combine=combine)
            with use_ctx(ctxs["1x4"]), torch.no_grad():
                y, aux = moe.moe_apply(p, x, cfg, dtype=torch.float32)
            out[f"{name}/{combine}/y"], out[f"{name}/{combine}/aux"] = y.numpy(), aux.numpy()
            for mesh, ctx in ctxs.items():
                with use_ctx(ctx):
                    grads = _grads(p, x, cfg)
                out.update({f"{name}/{combine}/{mesh}/grad/{k}": v for k, v in grads.items()})
    if rank == 0:
        np.savez(path, **out)


#: The meshes of the gradient cases (4 ranks).
GRAD_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
#: (case, mesh) of each gradient case.
GRAD_CASES = [("softmax-drops", "1x4"), ("sigmoid-top3", "1x4"), ("sigmoid-top3", "2x2")]
#: Leaves the gradient cases differentiate (the router bias only selects).
GRAD_LEAVES = ("x", "router", "wi", "wg", "wo")


def _grads(p, x, cfg):
    """The gradients of ``sum(y * c) + aux`` (``c`` a fixed random
    cotangent) with respect to ``x`` and the experts' and router's weights."""
    from repro_torch.nn import moe

    leaves = {k: (x if k == "x" else p[k]).clone().requires_grad_(True) for k in GRAD_LEAVES}
    pp = dict(p, **{k: v for k, v in leaves.items() if k != "x"})
    y, aux = moe.moe_apply(pp, leaves["x"], cfg, dtype=torch.float32)
    c = torch.from_numpy(np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32))
    loss = torch.sum(y * c) + aux
    return {k: g.numpy() for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's): the reference's child runs
    while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("ep")
    path = str(tmp / "port.npz")
    inputs = {}
    for name in CASES:
        p, x = _inputs(name)
        inputs.update({f"{name}/{k}": v for k, v in p.items()})
        inputs[f"{name}/x"] = x
    np.savez(path + ".in.npz", **inputs)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _SRC, "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    with Child([sys.executable, __file__, str(tmp / "ref.npz")], env) as child:
        run_ranks(_ep_rank, 4, tmp, path)
        child.wait()
    return dict(np.load(tmp / "ref.npz")), dict(np.load(path))


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


def _local(name):
    from repro_torch.nn import moe

    p, x = _inputs(name)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    cfg = moe.MoEConfig(**CASES[name])
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, dtype=torch.float32)
    x2d = torch.from_numpy(x.reshape(-1, D))
    return y.numpy(), float(aux), moe.dropped_pairs(tp, x2d, cfg).numpy()


@pytest.mark.parametrize("combine", ["psum", "gather"])
@pytest.mark.parametrize("case", GRAD_CASES, ids="-".join)
def test_expert_parallel_gradients_are_the_local_paths(case, combine, port):
    """The gradients through either combine, on a mesh whose "model" axis
    splits the experts and (on ``2x2``) whose "data" axis splits the
    batch, are the local path's within ``F32_LAYER``: each device's
    gradient of a weight or input it holds replicated is a partial sum,
    summed over the axis (`sharding.shard_map`).  On ``2x2`` each batch
    shard has its own capacity, as in the reference, so only the case
    that drops nothing is the local path there."""
    from repro_torch.nn import moe
    from test_torch_lm_trap import F32_LAYER, scaled_error

    name, mesh = case
    p, x = _inputs(name)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    want = _grads(tp, torch.from_numpy(x), moe.MoEConfig(**CASES[name]))
    for k in GRAD_LEAVES:
        got = port[f"{name}/{combine}/{mesh}/grad/{k}"]
        assert got.shape == want[k].shape, k
        assert scaled_error(want[k], got) <= F32_LAYER, (k, scaled_error(want[k], got))


@pytest.mark.parametrize("name", list(CASES))
def test_dropped_pairs_are_the_references(name, ref):
    _, _, got = _local(name)
    np.testing.assert_array_equal(got, ref[f"{name}/dropped"])
    if name == "softmax-drops":
        assert len(got) > 0


@pytest.mark.parametrize("combine", ["psum", "gather"])
@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_is_the_references(name, combine, ref, port):
    from test_torch_lm_trap import F32_LAYER, scaled_error

    y, aux = port[f"{name}/{combine}/y"], float(port[f"{name}/{combine}/aux"])
    for want in (f"{name}/{combine}", f"{name}/local"):
        assert scaled_error(ref[want + "/y"], y) <= F32_LAYER, want
        assert abs(float(ref[want + "/aux"]) - aux) <= F32_LAYER * abs(float(ref[want + "/aux"]))


@pytest.mark.parametrize("name", list(CASES))
def test_gather_is_the_local_path_bit_for_bit(name, port):
    y, _, _ = _local(name)
    np.testing.assert_array_equal(port[f"{name}/gather/y"], y)


@pytest.mark.parametrize("name", list(CASES))
def test_psum_is_the_local_path_within_the_cross_rank_sum(name, port):
    from test_torch_lm_trap import F32_LAYER, scaled_error

    y, aux, _ = _local(name)
    assert scaled_error(y, port[f"{name}/psum/y"]) <= F32_EP_SUM
    assert scaled_error(port[f"{name}/gather/y"], port[f"{name}/psum/y"]) <= F32_EP_SUM
    assert abs(float(port[f"{name}/psum/aux"]) - aux) <= F32_LAYER * abs(aux)


def test_the_expert_parallel_path_needs_experts_the_axis_divides():
    """Experts that the "model" axis does not divide run the local path
    (the reference's condition), on a mesh-shape context too."""
    from repro_torch.nn import moe
    from repro_torch.sharding import ShardingCtx, use_ctx

    cfg = moe.MoEConfig(**CASES["softmax-drops"])
    with use_ctx(ShardingCtx({"data": 1, "model": 3})):
        assert moe._ep_mesh(cfg) is None
    assert moe._ep_mesh(cfg) is None


if __name__ == "__main__":
    _ref_side(sys.argv[1])
