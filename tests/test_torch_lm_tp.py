"""The LM over a mesh whose axes are larger than 1, against the reference's.

The port runs on 4 gloo ranks (one process a rank) on a ``(2, 2)``
``("data", "model")`` mesh, and qwen2.5-14b also on a ``(1, 4)`` one, its
parameters distributed with `launch.specs`' shardings and its batch split
over ``"data"``: the heads, the vocab, the MLP's hidden dim and the SSM
heads shard over ``"model"``.  It runs each arch's forward, its loss and
its gradients (the vocab-parallel cross entropy's label offset; the
chunked attention per (batch, head) block: gemma-2b's one KV head and, on
``(1, 4)``, qwen2.5-14b's two KV heads indexed by query head, on ``(2,
2)`` qwen's KV heads sharded; norms gathering their dim; the blockwise
Mamba2 and RWKV6 scans), and three decode steps with each of the dry
run's decode overrides: the cache sequence over ``("data", "model")``
(one request) and the cache's head dim over ``"model"`` (KV heads the axis
does not divide).

The reference runs the same steps jitted under its ``ShardingCtx`` on a
``(2, 2)`` mesh of 4 forced host devices (one child, this file run as a
script), from its own init, whose values the port loads (`core.convert`);
zamba2-1.2b's step there compiles for 15 s, so zamba2 is held against the
port's one device only (whose own step is held against the reference's in
`test_torch_train_archs_families.py`).  In float32:

* against the reference's: logits within ``F32_LOGITS``, the loss and every
  gradient leaf within ``F32_GRAD`` (scaled errors, ROADMAP §3w, §3aa;
  1.2e-5 measured);
* against the port's one device: logits, loss and gradients within
  ``F32_GRAD`` (the mesh's partial sums add over ranks in gloo's order,
  §3aa; 9.7e-6 measured, zamba2's ``dt_bias``).

"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_gloo import Child, run_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: (arch, mesh) of each forward-and-gradient case.
CASES = [("gemma-2b", "2x2"), ("qwen2.5-14b", "2x2"), ("qwen2.5-14b", "1x4"),
         ("zamba2-1.2b", "2x2"), ("rwkv6-1.6b", "2x2")]
ARCHS = tuple(dict.fromkeys(a for a, _ in CASES))
#: The archs the reference runs on its mesh.
REF_ARCHS = ("gemma-2b", "qwen2.5-14b", "rwkv6-1.6b")
B, S = 4, 32
#: Decode cases: (arch, batch, the dry run's decode override).
DECODE = {"seq": ("qwen2.5-14b", 1, {"cache_seq": ("data", "model")}),
          "head_dim": ("gemma-2b", 2, {"cache_head_dim": ("model",)})}
DECODE_LEN, DECODE_STEPS = 16, 3


def _batch(vocab):
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _decode_tokens(vocab, batch):
    return np.random.default_rng(12).integers(0, vocab, (DECODE_STEPS, batch, 1)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _tree(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _reference_init():
    """The reference's init of each arch (PRNGKey(0), jitted), as flat arrays."""
    import jax

    from repro.configs.registry import get_config
    from repro.models import decoder
    from repro.nn.param import split_tree

    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        values = jax.jit(lambda key: split_tree(decoder.init_params(key, cfg))[0])(
            jax.random.PRNGKey(0))
        out.update({f"{arch}/init/{k}": v for k, v in _flat(values).items()})
    return out


def _init_of(init, arch):
    return _tree({k[len(arch) + 6:]: v for k, v in init.items() if k.startswith(f"{arch}/init/")})


def _ref_side(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs.registry import get_config
    from repro.models import decoder
    from repro.sharding import ShardingCtx, use_ctx
    from repro.sharding.ctx import DEFAULT_RULES
    from repro.train import step as jstep

    assert len(jax.devices()) == 4
    mesh = Mesh(np.asarray(jax.devices()).reshape(MESHES["2x2"]), ("data", "model"))
    init = dict(np.load(path + ".init.npz"))
    out = {}
    for arch in REF_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        values = jax.tree_util.tree_map(jnp.asarray, _init_of(init, arch))
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}

        def loss(params, batch):
            logits, aux = decoder.apply(params, batch["tokens"], cfg)
            total, _ = jstep.cross_entropy_loss(logits, batch["labels"])
            return total + aux, logits

        with use_ctx(ShardingCtx(mesh)):
            (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(values,
                                                                                   batch)
        out[f"{arch}/loss"], out[f"{arch}/logits"] = np.asarray(value), np.asarray(logits)
        out.update({f"{arch}/grad/{k}": v for k, v in _flat(grads).items()})
    for case, (arch, batch, override) in DECODE.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        values = jax.tree_util.tree_map(jnp.asarray, _init_of(init, arch))
        caches = decoder.init_decode_caches(cfg, batch, DECODE_LEN)
        step = jax.jit(lambda p, t, c, n: decoder.decode_step(p, t, c, n, cfg))
        logits = []
        with use_ctx(ShardingCtx(mesh, {**DEFAULT_RULES, **override})):
            for i, tok in enumerate(_decode_tokens(cfg.vocab_size, batch)):
                lg, caches = step(values, jnp.asarray(tok), caches, jnp.int32(i))
                logits.append(np.asarray(lg))
        out[f"decode/{case}/logits"] = np.stack(logits)
    np.savez(path + ".ref.npz", **out)


def _cfg(arch):
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _model(init, arch):
    from repro_torch.core import convert

    return convert.lm_params_from_arrays(_init_of(init, arch), _cfg(arch), "cpu")


def _grads_as_arrays(named, grads):
    """Gradients ``{port name: tensor}`` as the reference's flat leaves."""
    from repro_torch.nn.param import STACKS, leaf_groups

    out = {}
    for ref, names in leaf_groups(named):
        arrays = [grads[n].detach().float().numpy() for n in names]
        out[ref] = np.stack(arrays) if ref.split(".")[0] in STACKS else arrays[0]
    return out


def _loss_and_grads(model, batch, cfg):
    """(loss, logits, {port name: gradient}) of one batch, as plain tensors."""
    from repro_torch.models import decoder
    from repro_torch.train import step as tstep

    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    logits, aux = decoder.apply(model, batch["tokens"], cfg)
    total, _ = tstep.cross_entropy_loss(logits, batch["labels"])
    loss = total + aux
    grads = torch.autograd.grad(loss, list(named.values()))
    return (full(loss).detach(), full(logits).detach(),
            {n: full(g) for n, g in zip(named, grads)})


def _decode(model, cfg, batch, device_tree=lambda caches: caches, tok=lambda t: t):
    from repro_torch.models import decoder

    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    caches = device_tree(decoder.init_decode_caches(cfg, batch, DECODE_LEN, device="cpu"))
    logits = []
    with torch.no_grad():
        for i, t in enumerate(_decode_tokens(cfg.vocab_size, batch)):
            lg, caches = decoder.decode_step(model, tok(torch.from_numpy(t)), caches, i, cfg)
            logits.append(full(lg).numpy())
    return np.stack(logits)


def _distribute(tree, shard):
    """``tree`` (NamedTuples and tuples of tensors, None) distributed with ``shard``."""
    from torch.distributed.tensor import distribute_tensor

    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_distribute(t, s) for t, s in zip(tree, shard)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_distribute(t, s) for t, s in zip(tree, shard))
    return distribute_tensor(tree, shard.mesh, shard.placements)


def _on_mesh(model, ctx, requires_grad):
    """``model`` with each parameter distributed with its sharding under ``ctx``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import specs

    named = dict(model.named_parameters())
    shard = specs.param_shardings(ctx, named, model.logical_axes())
    for name, p in named.items():
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = distribute_tensor(p.detach(), ctx.mesh, shard[name].placements)
        setattr(mod, attr, torch.nn.Parameter(d, requires_grad=requires_grad))
    return model


def _tp_rank(rank, n, path):
    """One rank of the port's runs: forward, loss and gradients of each
    case, and the decode cases on ``(2, 2)``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import ShardingCtx, use_ctx
    from repro_torch.sharding.ctx import DEFAULT_RULES

    init = dict(np.load(path + ".init.npz"))
    meshes = {name: make_host_mesh(*shape, device="cpu") for name, shape in MESHES.items()}
    out = {}
    for arch, mname in CASES:
        mesh = meshes[mname]
        ctx = ShardingCtx.over(mesh)
        cfg = _cfg(arch)
        model = _on_mesh(_model(init, arch), ctx, True)
        raw = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
        bshard = specs.batch_shardings(ctx, raw)
        batch = {k: distribute_tensor(v, mesh, bshard[k].placements) for k, v in raw.items()}
        with use_ctx(ctx):
            loss, logits, grads = _loss_and_grads(model, batch, cfg)
        out[f"{mname}/{arch}/loss"], out[f"{mname}/{arch}/logits"] = loss.numpy(), logits.numpy()
        out.update({f"{mname}/{arch}/grad/{k}": v
                    for k, v in _grads_as_arrays(dict(model.named_parameters()), grads).items()})
    mesh = meshes["2x2"]
    for case, (arch, batch, override) in DECODE.items():
        ctx = ShardingCtx.over(mesh, {**DEFAULT_RULES, **override})
        cfg = _cfg(arch)
        model = _on_mesh(_model(init, arch), ctx, False)
        tshard = specs.batch_shardings(ctx, {"token": torch.zeros((batch, 1))})["token"]
        with use_ctx(ctx):
            out[f"decode/{case}/logits"] = _decode(
                model, cfg, batch, lambda c: _distribute(c, specs.cache_shardings(ctx, c)),
                lambda t: distribute_tensor(t, mesh, tshard.placements))
    if rank == 0:
        np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(init, the reference's results, the port's on the mesh): the
    reference's child runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("tp")
    path = str(tmp / "run.npz")
    init = _reference_init()
    np.savez(path + ".init.npz", **init)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _SRC, "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    with Child([sys.executable, __file__, path], env) as child:
        run_ranks(_tp_rank, 4, tmp, path)
        child.wait()
    return init, dict(np.load(path + ".ref.npz")), dict(np.load(path))


@pytest.fixture(scope="module")
def refs(runs):
    return runs[1]


@pytest.fixture(scope="module")
def port(runs):
    return runs[2]


@pytest.fixture(scope="module")
def one_device(runs):
    return _one_device(runs[0])


def _one_device(init):
    """The port's results on one device (no mesh), from the same weights."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = _model(init, arch)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
        loss, logits, grads = _loss_and_grads(model, batch, cfg)
        out[f"{arch}/loss"], out[f"{arch}/logits"] = loss.numpy(), logits.numpy()
        named = dict(model.named_parameters())
        out.update({f"{arch}/grad/{k}": v for k, v in _grads_as_arrays(named, grads).items()})
    for case, (arch, batch, _) in DECODE.items():
        out[f"decode/{case}/logits"] = _decode(_model(init, arch), _cfg(arch), batch)
    return out


def _held(want, got, arch, logits_bound, grad_bound):
    from test_torch_lm_trap import scaled_error

    assert scaled_error(want[f"{arch}/logits"], got["logits"]) <= logits_bound
    assert scaled_error(float(want[f"{arch}/loss"]), float(got["loss"])) <= grad_bound
    names = sorted(k for k in want if k.startswith(f"{arch}/grad/"))
    assert sorted(f"{arch}/grad/{k}" for k in got["grads"]) == names
    for k in names:
        g = got["grads"][k[len(arch) + 6:]]
        assert g.shape == want[k].shape, k
        assert scaled_error(want[k], g) <= grad_bound, k


def _on(port, mesh, arch):
    pre = f"{mesh}/{arch}/"
    return {"loss": port[pre + "loss"], "logits": port[pre + "logits"],
            "grads": {k[len(pre) + 5:]: v for k, v in port.items()
                      if k.startswith(pre + "grad/")}}


def _key(case):
    return "-".join(case)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in REF_ARCHS], ids=_key)
def test_forward_and_gradients_on_a_mesh_are_the_references(case, refs, port):
    from test_torch_lm_trap import F32_GRAD, F32_LOGITS

    arch, mesh = case
    _held(refs, _on(port, mesh, arch), arch, F32_LOGITS, F32_GRAD)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_forward_and_gradients_on_a_mesh_are_one_devices(case, one_device, port):
    from test_torch_lm_trap import F32_GRAD

    arch, mesh = case
    _held(one_device, _on(port, mesh, arch), arch, F32_GRAD, F32_GRAD)


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_with_the_dry_runs_overrides_is_the_references(case, refs, one_device, port):
    from test_torch_lm_trap import F32_GRAD, F32_LOGITS, scaled_error

    got = port[f"decode/{case}/logits"]
    assert got.shape == refs[f"decode/{case}/logits"].shape
    assert scaled_error(refs[f"decode/{case}/logits"], got) <= F32_LOGITS
    assert scaled_error(one_device[f"decode/{case}/logits"], got) <= F32_GRAD


if __name__ == "__main__":
    _ref_side(sys.argv[1])
