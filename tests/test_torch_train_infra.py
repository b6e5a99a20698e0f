"""The port's training substrate (`repro_torch.{data,optim,train,runtime}`)
against the reference's, case for case of ``tests/test_train_infra.py``:
the data pipeline byte for byte, the schedule, the loss, AdamW and the
global norm within ROADMAP §3aa's bounds (`test_torch_lm_trap.py`), the
int8 quantizer and its error feedback bit for bit, the fault-tolerance
runtime decision for decision, remat that changes no bit, and a resumed
run equal to an uninterrupted one."""

import dataclasses
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import pipeline as jpipe
from repro.models import decoder as jdec
from repro.nn.param import split_tree as jsplit
from repro.optim import adamw as jadamw
from repro.runtime import ft as jft
from repro.sharding import shard_map
from repro.train import step as jstep
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.data import pipeline as tpipe
from repro_torch.models import decoder, encdec
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state, lr_schedule
from repro_torch.runtime import ft
from repro_torch.sharding import ShardingCtx, use_ctx
from repro_torch.train import step as tstep
from test_torch_lm_trap import F32_GRAD, F32_STEP, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=128, q_chunk=16, kv_chunk=16)
TINY, JTINY = ModelConfig(**TINY_KW), JModelConfig(**TINY_KW)


def _values(cfg=JTINY, seed=0):
    values, _ = jsplit(jdec.init_params(jax.random.PRNGKey(seed), cfg))
    return jax.tree_util.tree_map(np.asarray, values)


def _model(cfg=TINY, seed=0, values=None):
    """The port's model holding the reference's init for ``seed``."""
    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    return convert.lm_params_from_arrays(_values(jcfg, seed) if values is None else values,
                                         cfg, "cpu")


def _batch(seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---- the data pipeline ----


@pytest.mark.parametrize("seed,step,hosts,extra", [
    (0, 0, 1, None), (3, 11, 1, None), (5, 7, 2, None), (1, 123456, 4, None),
    (2, 3, 1, {"frames": (6, 8)}), (4, 9, 2, {"visual_embeds": (3, 16), "frames": (5, 4)}),
])
def test_batch_at_is_the_references_byte_for_byte(seed, step, hosts, extra):
    for host in range(hosts):
        kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed, num_hosts=hosts,
                  host_id=host, extra_specs=extra)
        want = jpipe.SyntheticLMDataset(**kw).batch_at(step)
        got = tpipe.SyntheticLMDataset(**kw).batch_at(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), k


def test_data_determinism_and_host_sharding():
    full = tpipe.SyntheticLMDataset(vocab_size=64, seq_len=8, global_batch=8, seed=3)
    h0 = tpipe.SyntheticLMDataset(vocab_size=64, seq_len=8, global_batch=8, seed=3,
                                  num_hosts=2, host_id=0)
    h1 = tpipe.SyntheticLMDataset(vocab_size=64, seq_len=8, global_batch=8, seed=3,
                                  num_hosts=2, host_id=1)
    b_full = full.batch_at(11)
    assert b_full["tokens"].shape == (8, 8)
    np.testing.assert_array_equal(b_full["tokens"], full.batch_at(11)["tokens"])
    assert not np.array_equal(h0.batch_at(11)["tokens"], h1.batch_at(11)["tokens"])


def test_prefetch_iterator_resumable_and_the_references():
    ds = tpipe.SyntheticLMDataset(vocab_size=64, seq_len=8, global_batch=4, seed=0)
    it = tpipe.PrefetchIterator(ds, start_step=0)
    b0, b1 = next(it), next(it)
    st = it.state()
    it.close()
    assert st == {"step": 2, "seed": 0}
    it2 = tpipe.PrefetchIterator(ds, start_step=st["step"])
    b2 = next(it2)
    it2.close()
    np.testing.assert_array_equal(b2["tokens"], ds.batch_at(2)["tokens"])
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    jit_ = jpipe.PrefetchIterator(jpipe.SyntheticLMDataset(vocab_size=64, seq_len=8,
                                                           global_batch=4, seed=0), start_step=2)
    np.testing.assert_array_equal(next(jit_)["tokens"], b2["tokens"])
    assert jit_.state() == it2.state()
    jit_.close()


# ---- loss, schedule, optimizer ----


def test_cross_entropy_ignore_index():
    logits = torch.zeros((1, 4, 8), dtype=torch.float32)
    labels = torch.tensor([[1, 2, -100, -100]], dtype=torch.int32)
    total, ce = tstep.cross_entropy_loss(logits, labels, z_loss_weight=0.0)
    want_total, want_ce = jstep.cross_entropy_loss(jnp.zeros((1, 4, 8)), jnp.asarray(labels.numpy()),
                                                   z_loss_weight=0.0)
    np.testing.assert_allclose(float(ce), np.log(8), rtol=1e-5)
    assert float(total) == float(want_total) and float(ce) == float(want_ce)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[2] > lrs[3] > lrs[4] >= 0.1 - 1e-6


def test_adamw_weight_decay_pulls_to_zero():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones(4)}
    opt = init_opt_state(params)
    new, _, metrics = adamw_update(cfg, params, {"w": torch.zeros(4)}, opt, torch.tensor(0))
    assert float(new["w"][0]) < 1.0
    jnew, _, jm = jadamw.adamw_update(jadamw.AdamWConfig(lr=0.1, weight_decay=0.5,
                                                         warmup_steps=0, total_steps=10),
                                      {"w": jnp.ones(4)}, {"w": jnp.zeros(4)},
                                      jadamw.init_opt_state({"w": jnp.ones(4)}), jnp.int32(0))
    np.testing.assert_array_equal(np.asarray(jnew["w"]), new["w"].numpy())
    assert float(jm["lr"]) == float(metrics["lr"])


def test_adamw_consumes_the_gradients_and_updates_in_place():
    params = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    opt = init_opt_state(params, torch.bfloat16)
    grads = {"a": torch.full((3,), 0.5), "b": torch.full((2, 2), -0.25)}
    a, m = params["a"], opt.m["a"]
    new, new_opt, _ = adamw_update(AdamWConfig(warmup_steps=0), params, grads, opt, 0)
    assert grads == {} and new["a"] is a and new_opt.m["a"] is m
    assert m.dtype == torch.bfloat16 and float(m[0]) != 0.0


# ---- int8 error-feedback compression ----


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_quantizer_and_error_feedback_are_the_references(seed):
    """`_quantize_int8` (round half to even) and the per-leaf arithmetic of
    `_pod_compressed_allreduce`, bit for bit: the reference's inside
    ``shard_map`` over a one-pod mesh, the port's on one device."""
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(64,)).astype(np.float32),
         "b": (rng.normal(size=(4, 8)) * 1e-3).astype(np.float32),
         "z": np.zeros((5,), np.float32)}
    g["w"][:4] = [0.5, -0.5, 1.5, 2.5]  # halves: round to even
    r = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32) for k, v in g.items()}
    for scale in (float(np.abs(g["w"]).max()) / 127.0, 0.25, 1.0):
        np.testing.assert_array_equal(
            np.asarray(jstep._quantize_int8(jnp.asarray(g["w"]), scale)),
            tstep._quantize_int8(torch.from_numpy(g["w"]), scale).numpy())
    mesh = jax.make_mesh((1,), ("pod",))
    spec = {k: P() for k in g}
    want = shard_map(jstep._pod_compressed_allreduce, mesh, in_specs=(spec, spec),
                     out_specs=(spec, spec))(_j(g), _j(r))
    got = tstep._pod_compressed_allreduce(_t(g), _t(r))
    for w, t in zip(want, got):
        for k in g:
            np.testing.assert_array_equal(np.asarray(w[k]), t[k].numpy())


def test_int8_ef_compression_roundtrip():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
    scale = float(g.abs().max()) / 127.0
    deq = tstep._quantize_int8(g, scale).float() * scale
    assert float((deq - g).abs().max()) <= scale * 0.5 + 1e-6


def test_int8_ef_needs_a_pod_axis():
    """The reference asserts; the port raises ValueError naming the axis.
    On a one-pod context the step runs and carries the residual; several
    pods need the context's device mesh to sum over (a mesh shape alone is
    refused by name; `test_torch_train_int8_pods.py` runs the sync)."""
    tc = tstep.TrainConfig(grad_compression="int8_ef")
    state = tstep.init_train_state(_model(), tc)
    assert state.ef_residual is not None and set(state.ef_residual) == set(
        dict(state.params.named_parameters()))
    step = tstep.make_train_step(TINY, tc)
    with pytest.raises(ValueError, match="'pod'"):
        step(state, _t(_batch()))
    with use_ctx(ShardingCtx({"data": 1, "model": 1})), pytest.raises(ValueError, match="'pod'"):
        step(state, _t(_batch()))
    with use_ctx(ShardingCtx({"pod": 2, "data": 1})), pytest.raises(ValueError, match="mesh"):
        step(state, _t(_batch()))
    with use_ctx(ShardingCtx({"pod": 1, "data": 1, "model": 1})):
        state, metrics = step(state, _t(_batch()))
    assert int(state.step) == 1 and np.isfinite(float(metrics["loss"]))
    assert any(float(r.abs().max()) > 0 for r in state.ef_residual.values())
    jtc = jstep.TrainConfig(grad_compression="int8_ef")
    with pytest.raises(AssertionError, match="multi-pod"):
        jax.jit(jstep.make_train_step(JTINY, jtc))(jstep.init_train_state(_values(), jtc),
                                                   _j(_batch()))


# ---- the fault-tolerance runtime ----


@pytest.mark.parametrize("devices", [512, 256, 488, 240, 16, 8, 1024, 48, 4096])
@pytest.mark.parametrize("mp", [16, 8, 1])
def test_elastic_plan_is_the_references(devices, mp):
    for prefer in (True, False):
        try:
            want = jft.elastic_plan(devices, model_parallel=mp, prefer_pods=prefer)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ft.elastic_plan(devices, model_parallel=mp, prefer_pods=prefer)
        else:
            assert ft.elastic_plan(devices, model_parallel=mp, prefer_pods=prefer) == want


def test_elastic_plan_shrinks_mesh():
    assert ft.elastic_plan(512, model_parallel=16) == ((2, 16, 16), ("pod", "data", "model"))
    assert ft.elastic_plan(256, model_parallel=16) == ((16, 16), ("data", "model"))
    with pytest.raises(ValueError):
        ft.elastic_plan(488, model_parallel=16)
    assert ft.elastic_plan(240, model_parallel=16)[0] == (15, 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_decides_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    times = np.abs(1.0 + 0.02 * rng.standard_normal(200))
    times[rng.integers(5, 200, 8)] *= rng.uniform(1.05, 6.0, 8)
    kw = dict(alpha=0.1 + 0.1 * seed, threshold_sigma=3.0 - seed * 0.5, warmup_steps=3 + seed)
    want, got = jft.StragglerMonitor(**kw), ft.StragglerMonitor(**kw)
    for step, t in enumerate(times):
        assert got.record(step, float(t)) == want.record(step, float(t)), step
    assert got.flagged == want.flagged and got.mean == want.mean and got.var == want.var


def test_step_timer_feeds_the_monitor():
    mon = ft.StragglerMonitor(warmup_steps=1)
    for step in range(4):
        with ft.StepTimer(mon, step) as t:
            time.sleep(0.001)
        assert t.seconds >= 0.001 and t.is_straggler is False
    with ft.StepTimer(mon, 4) as t:
        time.sleep(0.05)
    assert t.is_straggler and mon.flagged[0][0] == 4


def test_preemption_handler_stops_the_loop_from_a_signal():
    """SIGTERM to this process sets the flag `launch.train` checks."""
    h = ft.PreemptionHandler(signals=(signal.SIGUSR2,))
    try:
        assert h.installed and not h.should_exit
        signal.raise_signal(signal.SIGUSR2)
        assert h.should_exit
    finally:
        h.uninstall()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("h", ft.PreemptionHandler()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out["h"].installed is False


# ---- the train step ----


def test_parameters_get_gradients_only_for_training():
    model = _model()
    assert not any(p.requires_grad for p in model.parameters())
    tstep.init_train_state(model, tstep.TrainConfig())
    assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("arch", [None, "deepseek-v3-671b", "zamba2-1.2b", "rwkv6-1.6b",
                                  "whisper-tiny", "internvl2-26b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_changes_no_bit(arch, dtype):
    """Loss and every gradient with remat off, "full" and "dots" (the
    selective checkpoint that saves the products) are equal bit for bit."""
    cfg = TINY if arch is None else get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    rng = np.random.default_rng(5)
    text = 16 - cfg.vlm_patches
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, text)).astype(np.int32))}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    if cfg.vlm_patches:
        batch["visual_embeds"] = torch.randn(2, cfg.vlm_patches, cfg.d_model,
                                             generator=torch.Generator().manual_seed(1))
    if cfg.encdec:
        batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model,
                                      generator=torch.Generator().manual_seed(2))
    init = (encdec if cfg.encdec else decoder).init_params
    base = init(torch.Generator().manual_seed(0), dataclasses.replace(cfg, remat=False), "cpu")
    state = base.state_dict()
    runs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        model = init(torch.Generator().manual_seed(9), c, "cpu")
        model.load_state_dict(state)
        model.requires_grad_(True)
        loss, _ = tstep.make_loss_fn(c, tstep.TrainConfig())(model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        runs.append((loss, [torch.zeros(()) if g is None else g for g in grads]))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


def test_train_step_matches_the_reference():
    """TINY, float32, warmup 0: one step from the same weights: loss and
    gradient norm within ``F32_GRAD``, m and v within ``F32_GRAD``, the
    parameters within ``F32_STEP`` of the update's size, the step count."""
    cfg, jcfg = (dataclasses.replace(c, dtype="float32") for c in (TINY, JTINY))
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    values = _values(jcfg)
    jstate = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, values),
                                    jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**kw)))
    jstate, jm = jax.jit(jstep.make_train_step(
        jcfg, jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**kw))))(jstate, _j(_batch()))
    tc = tstep.TrainConfig(optimizer=AdamWConfig(**kw))
    state = tstep.init_train_state(_model(cfg, values=values), tc)
    state, m = tstep.make_train_step(cfg, tc)(state, _t(_batch()))
    for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
        assert scaled_error(float(jm[k]), float(m[k])) <= F32_GRAD, k
    assert float(jm["lr"]) == float(m["lr"])
    want = jax.tree_util.tree_leaves(jstate)
    got = list(convert.train_state_to_arrays(state).values())
    n = (len(want) - 1) // 3
    assert int(want[0]) == int(got[0]) == 1
    p0 = jax.tree_util.tree_leaves(values)
    for i in range(n):
        update = max(np.abs(np.asarray(want[1 + i]) - p0[i]).max(), 1e-30)
        assert np.abs(np.asarray(want[1 + i]) - got[1 + i].numpy()).max() / update <= F32_STEP
        assert scaled_error(want[1 + n + i], got[1 + n + i].numpy()) <= F32_GRAD
        assert scaled_error(want[1 + 2 * n + i], got[1 + 2 * n + i].numpy()) <= 2 * F32_GRAD


def test_loss_decreases_over_steps():
    tc = tstep.TrainConfig(optimizer=AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=30))
    step = tstep.make_train_step(TINY, tc)
    state = tstep.init_train_state(_model(), tc)
    losses = []
    for _ in range(15):
        state, m = step(state, _t(_batch()))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_accum_equivalent_to_full_batch(dtype):
    """accum=2 over batch 8 == accum=1 over the same batch, compared by
    Adam's first moment (the reference's test and bound); float32 is
    equal within ``F32_GRAD``.  With accumulation the metrics hold no
    ce_loss / aux_loss (the reference's)."""
    cfg = dataclasses.replace(TINY, dtype=dtype)
    batch = _t(_batch(B=8))
    params = _model(cfg)
    outs = []
    for accum in (1, 2):
        tc = tstep.TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10),
                               grad_accum=accum)
        model = _model(cfg) if accum == 2 else params
        state, m = tstep.make_train_step(cfg, tc)(tstep.init_train_state(model, tc), batch)
        assert ("ce_loss" in m) == (accum == 1)
        outs.append(state.opt.m)
    bound = F32_GRAD if dtype == "float32" else 2e-2
    for name, x in outs[0].items():
        scale = max(float(x.abs().max()), 1e-6)
        assert float((x - outs[1][name]).abs().max()) / scale <= bound, name


def test_grad_accum_matches_the_reference():
    """float32, accum=2: the port's m against the reference's m (lax.scan
    over the microbatches)."""
    cfg, jcfg = (dataclasses.replace(c, dtype="float32") for c in (TINY, JTINY))
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    values = _values(jcfg)
    jtc = jstep.TrainConfig(optimizer=jadamw.AdamWConfig(**kw), grad_accum=2)
    jstate, jm = jax.jit(jstep.make_train_step(jcfg, jtc))(
        jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, values), jtc),
        _j(_batch(B=8)))
    tc = tstep.TrainConfig(optimizer=AdamWConfig(**kw), grad_accum=2)
    state, m = tstep.make_train_step(cfg, tc)(tstep.init_train_state(_model(cfg, values=values),
                                                                     tc), _t(_batch(B=8)))
    assert sorted(m) == sorted(jm) == ["grad_norm", "loss", "lr"]
    assert scaled_error(float(jm["loss"]), float(m["loss"])) <= F32_GRAD
    want = jax.tree_util.tree_leaves(jstate.opt.m)
    got = [v for k, v in convert.train_state_to_arrays(state).items() if k.startswith("opt.m.")]
    for w, g in zip(want, got):
        assert scaled_error(w, g.numpy()) <= F32_GRAD


def test_bf16_opt_state_trains():
    tc = tstep.TrainConfig(optimizer=AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=30,
                                                 state_dtype="bfloat16"))
    step = tstep.make_train_step(TINY, tc)
    state = tstep.init_train_state(_model(), tc)
    assert state.opt.m["final_norm.scale"].dtype == torch.bfloat16
    losses = []
    for _ in range(10):
        state, m = step(state, _t(_batch()))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3
    assert all(t.dtype == torch.bfloat16 for t in (*state.opt.m.values(), *state.opt.v.values()))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_train_resume_determinism(tmp_path, state_dtype):
    """train 4 steps == train 2, checkpoint, restore into a fresh state,
    train 2 (bitwise, every leaf)."""
    tc = tstep.TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                                                 state_dtype=state_dtype))
    step = tstep.make_train_step(TINY, tc)
    ds = tpipe.SyntheticLMDataset(vocab_size=128, seq_len=16, global_batch=4, seed=5)

    state_a = tstep.init_train_state(_model(seed=1), tc)
    for i in range(4):
        state_a, _ = step(state_a, _t(ds.batch_at(i)))

    state_b = tstep.init_train_state(_model(seed=1), tc)
    for i in range(2):
        state_b, _ = step(state_b, _t(ds.batch_at(i)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state_b)
    _, restored, _ = mgr.restore_latest(tstep.init_train_state(_model(seed=7), tc))
    assert int(restored.step) == 2
    for i in range(2, 4):
        restored, _ = step(restored, _t(ds.batch_at(i)))

    a, b = convert.train_state_to_arrays(state_a), convert.train_state_to_arrays(restored)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
