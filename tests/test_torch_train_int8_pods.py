"""The int8 error-feedback gradient sync over several pods, against the reference's.

The port's sync (`train.step.pod_sync_local`, run by the train step through
``shard_map`` over a ``("pod", "data", "model")`` mesh) runs on P gloo ranks,
one pod a rank; the reference's ``_pod_compressed_allreduce`` runs inside
its ``shard_map`` on a ``(P, 1, 1)`` mesh of forced host devices (one
child, this file run as a script), each pod's gradient block its own.

* At 2 pods the synced gradients and each pod's residual are the
  reference's bit for bit (its sync run eagerly; jitted, XLA contracts the
  residual's ``(g + r) - q * scale`` into an FMA, §3c): each device
  quantizes its own block at ``max(|g + r|, 1e-8) / 127``, and a sum of
  two dequantized values is order-free.
* At 4 pods the residuals are bit-equal and the synced gradients within
  ``F32_POD_SUM`` (2^-22 scaled; the sum's order is gloo's, not XLA's).
* Three train steps on a tiny dense config with ``int8_ef`` on a ``(2, 1,
  1)`` mesh (replicated parameters, the batch split over the pods), the
  port's on 2 gloo ranks against the reference's jitted step: losses,
  Adam's m and the residuals within the bounds named below, every leaf,
  after one step and after three.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_gloo import Child, run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

#: A sum of four pods' dequantized gradients in gloo's order against XLA's.
F32_POD_SUM = 2.0 ** -22
#: A gradient within F32_GRAD of the reference's may round to the
#: neighbouring int8 level, moving that element's synced value by one
#: quantum (max|g + r| / 127 of its leaf) ...
INT8_QUANTUM = 1.0 / 127
#: ... and its residual by the same quantum, about twice the residual's
#: own max (a residual lies within half a quantum of zero): a leaf's
#: residual is held within 2.5 of its max |r| (2.05 measured).
INT8_RESIDUAL = 2.5
#: After three steps (each Adam step moves the parameters within §3aa's
#: F32_STEP of its update, and the next gradients with them): the loss
#: (6.7e-4 measured) and Adam's m (0.062 of its max measured).
INT8_STEPS_LOSS = 2.0 ** -10
INT8_STEPS_M = 2.0 ** -3

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=128, q_chunk=16, kv_chunk=16,
               dtype="float32")
STEPS, B, S = 3, 4, 16
LEAVES = {"w": (3, 40), "b": (17,), "m": (2, 5, 6)}


def _grads(pods, seed):
    """Per-pod gradients (pods, *shape) of very different scales, and residuals."""
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal((pods,) + s) * 10.0 ** rng.integers(-3, 2, (pods,) + (1,) * len(s))
             ).astype(np.float32) for k, s in LEAVES.items()}
    r = {k: (rng.standard_normal((pods,) + s) * 1e-3).astype(np.float32) for k, s in LEAVES.items()}
    return g, r


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 128, (B, S)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    return out


def _tc(step_mod, adamw_mod):
    return step_mod.TrainConfig(
        optimizer=adamw_mod.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10),
        grad_compression="int8_ef")


def _ref_side(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs.base import ModelConfig
    from repro.models import decoder
    from repro.nn.param import split_tree
    from repro.optim import adamw as jadamw
    from repro.sharding import ShardingCtx, shard_map, use_ctx
    from repro.train import step as jstep

    assert len(jax.devices()) == 4
    out = {}
    for pods in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:pods]).reshape(pods, 1, 1), ("pod", "data", "model"))
        g, r = _grads(pods, pods)
        spec = {k: P("pod") for k in LEAVES}
        # Eager, as the one-pod case of test_torch_train_infra.py: jitted,
        # XLA contracts ``(g + r) - q * scale`` into an FMA (ROADMAP §3c).
        synced, new_r = shard_map(jstep._pod_compressed_allreduce, mesh,
                                  in_specs=(spec, spec), out_specs=(spec, spec))(
            {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in r.items()})
        for k in LEAVES:
            out[f"sync{pods}/{k}/synced"] = np.asarray(synced[k])
            out[f"sync{pods}/{k}/residual"] = np.asarray(new_r[k])
    # Three train steps on a (2, 1, 1) mesh.
    cfg = ModelConfig(**TINY_KW)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1, 1), ("pod", "data", "model"))
    values, _ = split_tree(decoder.init_params(jax.random.PRNGKey(0), cfg))
    tc = _tc(jstep, jadamw)
    with use_ctx(ShardingCtx(mesh)):
        state = jstep.init_train_state(values, tc)
        step = jax.jit(jstep.make_train_step(cfg, tc))
        bsh = NamedSharding(mesh, P(("pod", "data")))
        for i, batch in enumerate(_batches()):
            batch = {k: jax.device_put(jnp.asarray(v), bsh) for k, v in batch.items()}
            state, metrics = step(state, batch)
            out[f"train/loss{i}"] = np.asarray(metrics["loss"])
            names = [jax.tree_util.keystr(p)
                     for p, _ in jax.tree_util.tree_flatten_with_path(values)[0]]
            for group, tree in (("m", state.opt.m), ("residual", state.ef_residual)):
                for n, leaf in zip(names, jax.tree_util.tree_leaves(tree)):
                    out[f"train/{i}/{group}/{n}"] = np.asarray(leaf)
    np.savez(path, **out)


def _sync_rank(rank, pods, path):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import pod_sync_local

    mesh = make_mesh((pods, 1, 1), ("pod", "data", "model"), "cpu")
    g, r = _grads(pods, pods)
    out = {}
    for k in LEAVES:
        synced, new_r = pod_sync_local(torch.from_numpy(g[k][rank]), torch.from_numpy(r[k][rank]),
                                       mesh)
        out[f"{k}/synced"], out[f"{k}/residual"] = synced.numpy(), new_r.numpy()
    np.savez(f"{path}.{rank}.npz", **out)


def _train_rank(rank, pods, path):
    """The port's three int8 steps: replicated DTensor parameters (the
    reference's init, from ``path + ".init.npz"``), this rank's half of
    each batch."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import convert
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.param import STACKS, leaf_groups
    from repro_torch.optim import adamw as tadamw
    from repro_torch.sharding import ShardingCtx, use_ctx
    from repro_torch.train import step as tstep

    mesh = make_mesh((pods, 1, 1), ("pod", "data", "model"), "cpu")
    cfg = ModelConfig(**TINY_KW)
    model = convert.lm_params_from_arrays(_unflatten(dict(np.load(path + ".init.npz"))), cfg,
                                          "cpu")
    rep = [Replicate()] * 3
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, torch.nn.Parameter(DTensor.from_local(p.detach().clone(), mesh, rep,
                                                                 run_check=False)))
    tc = _tc(tstep, tadamw)
    out = {}
    with use_ctx(ShardingCtx.over(mesh)):
        state = tstep.init_train_state(model, tc)
        step = tstep.make_train_step(cfg, tc)
        for i, batch in enumerate(_batches()):
            half = B // pods
            batch = {k: DTensor.from_local(torch.from_numpy(v[rank * half:(rank + 1) * half]),
                                           mesh, [Shard(0), Replicate(), Replicate()],
                                           run_check=False) for k, v in batch.items()}
            state, metrics = step(state, batch)
            out[f"loss{i}"] = metrics["loss"].full_tensor().numpy()
            for group, tree in (("m", state.opt.m), ("residual", state.ef_residual)):
                for ref, names in leaf_groups(tree):
                    # Copies: a replicated DTensor's full tensor is its local
                    # block, which the next step updates in place.
                    leaves = [tree[n].full_tensor().detach().numpy().copy() for n in names]
                    out[f"{i}/{group}/{ref}"] = (np.stack(leaves) if ref.split(".")[0] in STACKS
                                                 else leaves[0])
    if rank == 0:
        np.savez(path, **out)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _reference_init():
    """The reference's tiny model at PRNGKey(0), as nested dicts of arrays."""
    import jax

    from repro.configs.base import ModelConfig
    from repro.models import decoder
    from repro.nn.param import split_tree

    values, _ = split_tree(decoder.init_params(jax.random.PRNGKey(0), ModelConfig(**TINY_KW)))
    return jax.tree_util.tree_map(np.asarray, values)


def _two_pods_rank(rank, pods, sync_path, train_path):
    """A rank of the 2-pod world: the sync, then the three train steps."""
    _sync_rank(rank, pods, sync_path)
    _train_rank(rank, pods, train_path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, the port's syncs {pods: per rank}, the
    port's train steps): the reference's child runs while the port's
    ranks do."""
    tmp = tmp_path_factory.mktemp("int8")
    train = str(tmp / "train.npz")
    np.savez(train + ".init.npz", **_flatten(_reference_init()))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _SRC, "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    with Child([sys.executable, __file__, str(tmp / "ref.npz")], env) as child:
        run_ranks(_two_pods_rank, 2, tmp, str(tmp / "sync2"), train)
        run_ranks(_sync_rank, 4, tmp, str(tmp / "sync4"))
        child.wait()
    syncs = {pods: [dict(np.load(tmp / f"sync{pods}.{r}.npz")) for r in range(pods)]
             for pods in (2, 4)}
    return dict(np.load(tmp / "ref.npz")), syncs, dict(np.load(train))


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_sync(runs):
    return runs[1]


@pytest.fixture(scope="module")
def port_train(runs):
    return runs[2]


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_two_pods_are_the_references_bit_for_bit(leaf, ref, port_sync):
    for rank, got in enumerate(port_sync[2]):
        np.testing.assert_array_equal(got[f"{leaf}/synced"], ref[f"sync2/{leaf}/synced"][rank])
        np.testing.assert_array_equal(got[f"{leaf}/residual"], ref[f"sync2/{leaf}/residual"][rank])


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_four_pods_are_the_references_within_the_sum_order(leaf, ref, port_sync):
    from test_torch_lm_trap import scaled_error

    for rank, got in enumerate(port_sync[4]):
        np.testing.assert_array_equal(got[f"{leaf}/residual"], ref[f"sync4/{leaf}/residual"][rank])
        assert scaled_error(ref[f"sync4/{leaf}/synced"][rank], got[f"{leaf}/synced"]) <= F32_POD_SUM
    # Every pod holds the same mean.
    for got in port_sync[4][1:]:
        np.testing.assert_array_equal(got[f"{leaf}/synced"], port_sync[4][0][f"{leaf}/synced"])


def _errors(ref, port, i):
    """{leaf: (max |port - ref|, max |ref|)} of m and the residuals after step i."""
    out = {}
    for k, v in port.items():
        parts = k.split("/")
        if len(parts) == 3 and parts[0] == str(i):
            name = "".join(f"['{p}']" for p in parts[2].split("."))
            want = ref[f"train/{i}/{parts[1]}/{name}"]
            assert want.shape == v.shape, k
            out[f"{parts[1]}/{name}"] = (float(np.abs(v - want).max()),
                                         float(np.abs(want).max()))
    return out


def _held(errors, m_bound):
    for k, (err, scale) in errors.items():
        bound = (m_bound if k.startswith("m/") else INT8_RESIDUAL) * max(scale, 1e-30)
        assert err <= bound, (k, err, bound)


def test_one_int8_step_at_two_pods_is_the_references(ref, port_train):
    """After one step: the loss within ``F32_GRAD``; each leaf's m within
    ``F32_GRAD`` plus one int8 quantum of its max, its residual within
    ``INT8_RESIDUAL`` of its max."""
    from test_torch_lm_trap import F32_GRAD, scaled_error

    assert scaled_error(float(ref["train/loss0"]), float(port_train["loss0"])) <= F32_GRAD
    errors = _errors(ref, port_train, 0)
    assert len(errors) == 2 * len([k for k in ref if k.startswith("train/0/m/")])
    _held(errors, F32_GRAD + INT8_QUANTUM)
    assert any(scale > 0 for k, (_, scale) in errors.items() if k.startswith("residual"))


def test_three_int8_steps_at_two_pods_stay_with_the_references(ref, port_train):
    from test_torch_lm_trap import scaled_error

    for i in range(STEPS):
        assert scaled_error(float(ref[f"train/loss{i}"]),
                            float(port_train[f"loss{i}"])) <= INT8_STEPS_LOSS
    _held(_errors(ref, port_train, STEPS - 1), INT8_STEPS_M)


if __name__ == "__main__":
    _ref_side(sys.argv[1])
