"""The port's mixture of experts (`repro_torch.nn.moe`) against the
reference's (`repro.nn.moe`), on the reference's initial parameters and
the same numpy inputs: the cases of ``tests/test_moe.py``.  Routing ids and
the dropped (token, expert) pairs are equal, exactly; outputs and losses
are within ROADMAP §3w's ``F32_LAYER`` / ``BF16_LAYER`` on the scaled
error (`test_torch_lm_trap.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.nn import moe as jmoe
from repro.nn.param import split_tree as jsplit
from repro_torch.nn import moe
from test_torch_lm_trap import BF16_LAYER, F32_LAYER, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: The reference's layer, compiled once a config (eager JAX compiles op by op).
japply = jax.jit(jmoe.moe_apply, static_argnames=("cfg", "mlp_kind", "dtype"))
DT = {"float32": (jnp.float32, torch.float32, F32_LAYER),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_LAYER)}


def _params(cfg, d, seed):
    values, _ = jsplit(jmoe.moe_init(jax.random.PRNGKey(seed), d, cfg))
    values = jax.tree_util.tree_map(np.asarray, values)
    return (jax.tree_util.tree_map(jnp.asarray, values),
            jax.tree_util.tree_map(torch.from_numpy, values))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


def _cfg(jcfg):
    return moe.MoEConfig(**dataclasses.asdict(jcfg))


def dense_moe_oracle(p, x2d, cfg):
    """Every expert computes every token; combine with router weights
    (the reference's oracle, ``tests/test_moe.py``, on the port)."""
    w, ids, _ = moe._route(p, x2d, cfg)
    g = torch.einsum("td,edf->tef", x2d, p["wg"])
    up = torch.einsum("td,edf->tef", x2d, p["wi"])
    out_all = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * up, p["wo"])
    mask = torch.zeros((x2d.shape[0], cfg.num_experts)).scatter_(1, ids, w)
    return torch.einsum("ted,te->td", out_all, mask)


def _ref_dropped(jp, x2d, jcfg):
    """The reference's dropped (token, expert) pairs, from its own
    `_route` and `_dispatch`."""
    w, ids, _ = jmoe._route(jp, x2d, jcfg)
    _, st, _, _, dest_global, C = jmoe._dispatch(x2d, w, ids, jcfg, 0, jcfg.num_experts,
                                                 jnp.float32)
    se = np.asarray(ids).reshape(-1)[np.argsort(np.asarray(ids).reshape(-1), kind="stable")]
    drop = np.asarray(dest_global) == jcfg.num_experts * C
    pairs = np.stack([np.asarray(st)[drop], se[drop]], 1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("routing,topk", [("softmax", 2), ("sigmoid", 3)])
def test_dispatch_matches_dense_oracle_and_the_reference(routing, topk, dtype):
    jcfg = jmoe.MoEConfig(num_experts=8, top_k=topk, d_ff_expert=32, capacity_factor=8.0,
                          routing=routing, norm_topk=(routing == "sigmoid"))
    cfg = _cfg(jcfg)
    jp, tp = _params(jcfg, 16, 0)
    x = _x(1, 3, 7, 16)
    jdt, tdt, bound = DT[dtype]
    jy, jaux = japply(jp, jnp.asarray(x).astype(jdt), jcfg, dtype=jdt)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x).to(tdt), cfg, dtype=tdt)
    assert scaled_error(_np(jy), _np(y)) <= bound
    assert abs(float(jaux) - float(aux)) <= F32_LAYER * abs(float(jaux))
    if dtype == "float32":
        want = dense_moe_oracle(tp, torch.from_numpy(x).reshape(-1, 16), cfg).reshape(x.shape)
        assert scaled_error(want.numpy(), y.numpy()) <= F32_LAYER
    # The same experts, in the same order.
    _, jids, _ = jmoe._route(jp, jnp.asarray(x.reshape(-1, 16)), jcfg)
    _, ids, _ = moe._route(tp, torch.from_numpy(x.reshape(-1, 16)), cfg)
    np.testing.assert_array_equal(np.asarray(jids), ids.numpy())


@pytest.mark.parametrize("routing,experts,topk,cf", [("softmax", 2, 1, 0.01),
                                                     ("softmax", 4, 2, 0.3),
                                                     ("sigmoid", 8, 3, 0.25)])
def test_capacity_drops_the_references_pairs(routing, experts, topk, cf):
    """With a capacity small enough to drop, the port drops the same
    (token, expert) pairs as the reference, and its output equals the
    reference's; the dropped assignments are dropped, not corrupted."""
    base = jmoe.MoEConfig(num_experts=experts, top_k=topk, d_ff_expert=16,
                          capacity_factor=100.0, routing=routing)
    tiny = dataclasses.replace(base, capacity_factor=cf)
    jp, tp = _params(base, 8, 2)
    x = _x(3, 1, 64, 8)
    want = _ref_dropped(jp, jnp.asarray(x[0]), tiny)
    got = moe.dropped_pairs(tp, torch.from_numpy(x[0]), _cfg(tiny)).numpy()
    assert len(want) > 0
    np.testing.assert_array_equal(want, got)
    assert len(moe.dropped_pairs(tp, torch.from_numpy(x[0]), _cfg(base))) == 0
    y_full, _ = moe.moe_apply(tp, torch.from_numpy(x), _cfg(base), dtype=torch.float32)
    y_tiny, _ = moe.moe_apply(tp, torch.from_numpy(x), _cfg(tiny), dtype=torch.float32)
    jy, _ = japply(jp, jnp.asarray(x), tiny, dtype=jnp.float32)
    assert scaled_error(_np(jy), y_tiny.numpy()) <= F32_LAYER
    assert float(y_tiny.norm()) < float(y_full.norm())
    assert torch.isfinite(y_tiny).all()
    # A token whose every assignment was dropped gets exactly zero.
    all_dropped = [t for t in range(64) if (got[:, 0] == t).sum() == topk]
    if all_dropped:
        assert float(y_tiny[0, all_dropped].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", list(DT))
def test_shared_expert_branch(dtype):
    jcfg = jmoe.MoEConfig(num_experts=4, top_k=1, d_ff_expert=16, num_shared_experts=1,
                          capacity_factor=4.0)
    jp, tp = _params(jcfg, 8, 4)
    x = _x(5, 2, 5, 8)
    jdt, tdt, bound = DT[dtype]
    jy, _ = japply(jp, jnp.asarray(x).astype(jdt), jcfg, dtype=jdt)
    y, _ = moe.moe_apply(tp, torch.from_numpy(x).to(tdt), _cfg(jcfg), dtype=tdt)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert scaled_error(_np(jy), _np(y)) <= bound


def test_load_balance_and_z_losses_are_the_references():
    cfg = jmoe.MoEConfig(num_experts=4, top_k=1, d_ff_expert=8, aux_loss_weight=1.0,
                         z_loss_weight=0.0)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (64, 8), jnp.float32))
    routers = {"uniform": np.zeros((8, 4), np.float32),
               "collapsed": np.concatenate([np.full((8, 1), 10.0), np.full((8, 3), -10.0)],
                                           1).astype(np.float32),
               "random": _x(9, 8, 4)}
    got = {}
    for name, r in routers.items():
        for c in (cfg, dataclasses.replace(cfg, aux_loss_weight=0.0, z_loss_weight=1.0),
                  dataclasses.replace(cfg, routing="sigmoid", top_k=2, norm_topk=True,
                                      routed_scaling=2.5, z_loss_weight=1e-4)):
            jp = {"router": jnp.asarray(r), "router_bias": jnp.zeros((4,), jnp.float32)}
            tp = {"router": torch.from_numpy(r), "router_bias": torch.zeros(4)}
            jw, jids, jaux = jmoe._route(jp, jnp.asarray(x), c)
            w, ids, aux = moe._route(tp, torch.from_numpy(x), _cfg(c))
            np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
            assert scaled_error(np.asarray(jw), w.numpy()) <= F32_LAYER
            assert abs(float(jaux) - float(aux)) <= F32_LAYER * max(abs(float(jaux)), 1e-30)
            got[name, c] = float(aux)
    assert got["uniform", cfg] < got["collapsed", cfg]


@pytest.mark.parametrize("combine", ["psum", "gather"])
def test_the_expert_parallel_paths_reduce_to_the_local_path(combine):
    """On one device the reference's ``shard_map`` paths (a 1x1 mesh,
    ``combine="psum"|"gather"``) compute its local path; the port runs the
    local path, which equals both."""
    from repro.launch.mesh import make_host_mesh
    from repro.sharding import ShardingCtx, use_ctx

    jcfg = jmoe.MoEConfig(num_experts=4, top_k=2, d_ff_expert=16, capacity_factor=4.0,
                          combine=combine)
    jp, tp = _params(jcfg, 8, 6)
    x = _x(7, 2, 6, 8)
    y_local, _ = japply(jp, jnp.asarray(x), jcfg, dtype=jnp.float32)
    with use_ctx(ShardingCtx(make_host_mesh(1, 1))):  # read while tracing: a jit of its own
        y_ep, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, dtype=jnp.float32))(
            jp, jnp.asarray(x))
    y, _ = moe.moe_apply(tp, torch.from_numpy(x), _cfg(jcfg), dtype=torch.float32)
    assert scaled_error(_np(y_local), y.numpy()) <= F32_LAYER
    assert scaled_error(_np(y_ep), y.numpy()) <= F32_LAYER


def test_combine_is_deterministic_and_in_the_references_order(monkeypatch):
    """The port adds a token's k outputs one at a time in ascending
    expert order (the reference's scatter-add order), never with atomics.
    With both packages' experts replaced by the same exact function (times
    1.5), the bfloat16 outputs at top-8 equal the reference's bit for bit
    and are the same on every call."""
    jcfg = jmoe.MoEConfig(num_experts=16, top_k=8, d_ff_expert=16, capacity_factor=4.0)
    jp, tp = _params(jcfg, 16, 10)
    x = _x(11, 2, 8, 16)
    monkeypatch.setattr(jmoe, "_expert_ffn", lambda h, *_: h * jnp.asarray(1.5, h.dtype))
    monkeypatch.setattr(moe, "_expert_ffn", lambda h, *_: h * 1.5)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg, dtype=jnp.bfloat16)
    ys = [moe.moe_apply(tp, torch.from_numpy(x).bfloat16(), _cfg(jcfg), dtype=torch.bfloat16)[0]
          for _ in range(3)]
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    np.testing.assert_array_equal(_np(jy), _np(ys[0]))


def test_moe_module_holds_the_router_in_float32():
    from repro_torch.nn.basic import hold_in

    cfg = moe.MoEConfig(num_experts=4, top_k=2, d_ff_expert=8, num_shared_experts=1,
                        routing="sigmoid")
    m = moe.MoE(torch.Generator().manual_seed(0), 8, cfg, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(_x(12, 2, 3, 8)).bfloat16()
    want, _ = m(x)
    hold_in(m, torch.bfloat16)
    assert m.router.dtype == m.router_bias.dtype == torch.float32
    assert m.wi.dtype == m.shared.wi.dtype == torch.bfloat16
    assert torch.equal(want, m(x)[0])
    assert set(m.logical_axes()) == {"router", "router_bias", "wi", "wg", "wo", "shared.wi",
                                     "shared.wg", "shared.wo"}
