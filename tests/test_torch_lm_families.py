"""The port's decoder (`repro_torch.models.decoder`) for the families
beyond the dense one (deepseek-v3: MLA + MoE after dense head layers;
llama4-scout: GQA + MoE; zamba2: Mamba2 with a shared attention block;
rwkv6; whisper built as a dense decoder, as the reference's decoder builds
it) against the reference's, at the smoke sizes, with the reference's
initial weights carried across (`core.convert.lm_params_from_arrays`).

Bounds on the scaled error (`test_torch_lm_trap.py`): ``F32_LOGITS`` in
float32; in bfloat16 ``BF16_LOGITS``, but ``BF16_HYBRID_LOGITS`` for
zamba2 (6 blocks deep, ROADMAP §3w's drift with depth).  In bfloat16 a
MoE router may swap an expert whose selection score ties the k-th within
``BF16_ROUTE_TIE`` (ROADMAP §3z); a bfloat16 MoE comparison beyond its
bound must find such a tie at or before the step.  The dense archs' cases
of the same tests are in `test_torch_lm_decoder.py`; served tokens
against the reference's engine are in `test_torch_lm_families_serve.py`."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jget
from repro.models import decoder as jdec
from repro.nn.param import split_tree as jsplit
from repro_torch.configs.registry import get_config
from repro_torch.core import convert
from repro_torch.models import decoder
from repro_torch.nn import moe
from test_torch_lm_trap import (BF16_HYBRID_LOGITS, BF16_LOGITS, BF16_ROUTE_TIE, F32_LOGITS,
                                scaled_error)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ["deepseek-v3-671b", "llama4-scout-17b-a16e", "zamba2-1.2b", "rwkv6-1.6b",
            "whisper-tiny"]
PREFILL = {"deepseek-v3-671b", "llama4-scout-17b-a16e"}  # the attention families
TEACHER_FORCING = 0.06
#: The reference's forward and decode step, compiled once a config (eager
#: JAX compiles op by op: three times slower at these sizes).
japply = jax.jit(jdec.apply, static_argnames="cfg")
jdecode = jax.jit(jdec.decode_step, static_argnames="cfg")
jprefill = jax.jit(jdec.prefill, static_argnames=("cfg", "max_len"))


def bound(arch: str, dtype: str) -> float:
    if dtype == "float32":
        return F32_LOGITS
    return BF16_HYBRID_LOGITS if arch == "zamba2-1.2b" else BF16_LOGITS


def _cfgs(arch, dtype):
    return (dataclasses.replace(jget(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def models(arch, dtype, seed=0):
    jcfg, cfg = _cfgs(arch, dtype)
    values, _ = jsplit(jdec.init_params(jax.random.PRNGKey(seed), jcfg))
    values = jax.tree_util.tree_map(np.asarray, values)
    return jcfg, cfg, values, convert.lm_params_from_arrays(values, cfg, "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


class MoEWatch:
    """Hooks on every MoE layer of a model.  ``gap``: the smallest scaled
    gap, over the calls since `reset`, between the k-th and the (k+1)-th
    selection score (each row's scores scaled by their largest): below
    `BF16_ROUTE_TIE`, another rounding of the router's input may swap an
    expert.  ``first_drop``: the first sequence position (over the batch
    rows and the layers) of a token whose assignment capacity dropped, by
    the port's own `moe.dropped_pairs`, or None."""

    def __init__(self, model):
        self.reset()
        for m in model.modules():
            if isinstance(m, moe.MoE):
                m.register_forward_pre_hook(self._hook)

    def reset(self):
        self.gap, self.first_drop = np.inf, None

    def _hook(self, m, args):
        cfg, x = m.cfg, args[0]
        x2d = x.reshape(-1, x.shape[-1])
        logits = torch.matmul(x2d.float(), m.router.float())
        if cfg.routing == "sigmoid":
            sel = torch.sigmoid(logits) + m.router_bias.float()
        else:
            sel = torch.softmax(logits, -1)
        s = torch.sort(sel, -1, descending=True).values
        gap = (s[:, cfg.top_k - 1] - s[:, cfg.top_k]) / s.abs().max(-1).values
        self.gap = min(self.gap, float(gap.min()))
        dropped = moe.dropped_pairs(m.tree(), x2d, cfg)
        if len(dropped):
            first = int((dropped[:, 0] % x.shape[1]).min())
            self.first_drop = first if self.first_drop is None else min(self.first_drop, first)


def check(want, got, arch, dtype, what, ties: MoEWatch):
    """``got`` within the arch's bound of ``want``, or, for a bfloat16
    MoE, beyond it only after a routing tie."""
    err = scaled_error(_np(want), _np(got))
    if err > bound(arch, dtype):
        assert dtype == "bfloat16" and ties.gap < BF16_ROUTE_TIE, (what, arch, dtype, err,
                                                                   ties.gap)
    return err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_apply_prefill_and_decode_match_the_reference(arch, dtype):
    jcfg, cfg, values, model = models(arch, dtype)
    ties = MoEWatch(model)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    with torch.no_grad():
        jl, jaux = japply(values, jnp.asarray(toks), jcfg)
        tl, taux = decoder.apply(model, torch.from_numpy(toks), cfg)
        assert tl.shape == (2, 16, cfg.padded_vocab)
        check(jl, tl, arch, dtype, "apply", ties)
        assert abs(float(jaux) - float(taux)) <= bound(arch, dtype) * max(abs(float(jaux)), 1e-30)
        assert (cfg.moe is not None) == (float(taux) > 0)
        if arch in PREFILL:
            jl, jc, jn = jprefill(values, jnp.asarray(toks[:, :8]), jcfg, max_len=16)
            tl, tc, tn = decoder.prefill(model, torch.from_numpy(toks[:, :8]), cfg, max_len=16)
            assert tn == int(jn) == 8
            for jt, tt in zip(jc.kv, tc.kv):
                assert tuple(jt.shape) == tuple(tt.shape) and tt.dtype == cfg.compute_dtype
                check(jt, tt, arch, dtype, "prefill cache", ties)
            check(jl, tl, arch, dtype, "prefill logits", ties)
            start = 8
        else:
            with pytest.raises(NotImplementedError, match="attention-family"):
                decoder.prefill(model, torch.from_numpy(toks[:, :8]), cfg, max_len=16)
            jc = jdec.init_decode_caches(jcfg, 2, 16)
            tc = decoder.init_decode_caches(cfg, 2, 16, device="cpu")
            start = 0
        ties.reset()  # a decode step's failure needs a tie in the decode steps
        for t in range(start, start + 6):
            step = toks[:, t:t + 1]
            jd, jc = jdecode(values, jnp.asarray(step), jc, jnp.int32(t), jcfg)
            td, tc2 = decoder.decode_step(model, torch.from_numpy(step), tc, t, cfg)
            assert tc2.kv[0] is tc.kv[0]  # written in place
            check(jd, td, arch, dtype, f"decode {t}", ties)
        for jt, tt in zip(jax.tree_util.tree_leaves(jc), jax.tree_util.tree_leaves(tuple(tc))):
            assert tuple(jt.shape) == tuple(tt.shape) and jt.dtype.name == str(tt.dtype)[6:]
            check(jt, tt, arch, dtype, "decoded caches", ties)


#: Decode steps held to teacher forcing: the reference's 4 in bfloat16
#: (``tests/test_archs.py``; at 16 zamba2's bfloat16 drifts past 0.06 in
#: both packages, the reference's to 0.18, §3w), all 16 in float32.
TF_STEPS = {"bfloat16": 4, "float32": 16}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_teacher_forcing(arch, dtype):
    """The reference's test of its own decode (``tests/test_archs.py``:
    KV cache, SSM state, MLA-absorbed decode), on the port: decode from
    empty caches, and (attention families) prefill then decode, against
    one forward pass of 16 tokens.  MoE: capacity is computed from the
    forward's B*S tokens, so teacher forcing may drop an assignment a
    decode step keeps (§3z); the steps compared end before the first
    position whose assignment the forward (or the prefill) dropped, and
    include the reference's 4."""
    _, cfg, _, model = models(arch, dtype, seed=0)
    watch = MoEWatch(model)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
                            .astype(np.int32))
    steps = TF_STEPS[dtype]
    with torch.no_grad():
        lg_tf, _ = decoder.apply(model, toks, cfg)
        if watch.first_drop is not None:
            steps = min(steps, watch.first_drop)
        assert steps >= 4, (arch, watch.first_drop)
        caches = decoder.init_decode_caches(cfg, 2, 16, device="cpu")
        watch.reset()
        errs = []
        for t in range(steps):
            lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
            errs.append(scaled_error(_np(lg_tf[:, t]), _np(lg[:, 0])))
            if errs[-1] >= TEACHER_FORCING:
                assert dtype == "bfloat16" and watch.gap < BF16_ROUTE_TIE, (arch, t, errs)
                break
        if dtype == "float32":
            assert max(errs) <= F32_LOGITS, (arch, errs)
        if arch in PREFILL:
            watch.reset()
            lg_pf, caches, _ = decoder.prefill(model, toks[:, :8], cfg, max_len=16)
            end = 8 if watch.first_drop is None else watch.first_drop
            assert scaled_error(_np(lg_tf[:, :end]), _np(lg_pf[:, :end])) < TEACHER_FORCING
            watch.reset()
            for t in range(8, min(11, steps) if end == 8 else 8):
                lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
                err = scaled_error(_np(lg_tf[:, t]), _np(lg[:, 0]))
                assert err < TEACHER_FORCING or watch.gap < BF16_ROUTE_TIE, (arch, t, err)


def test_a_bf16_routing_tie_is_what_breaks_deepseeks_decode():
    """§3z at deepseek-v3's smoke size (seed 0, bfloat16): the third
    decode step routes a token through experts whose selection scores tie
    within 2^-11, and teacher forcing's rounding of the router's input
    routes it otherwise: the step's logits move past 0.06.  In float32 the
    same steps are within `F32_LOGITS`."""
    for dtype in ("bfloat16", "float32"):
        _, cfg, _, model = models("deepseek-v3-671b", dtype)
        watch = MoEWatch(model)
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
                                .astype(np.int32))
        with torch.no_grad():
            lg_tf, _ = decoder.apply(model, toks, cfg)
            caches = decoder.init_decode_caches(cfg, 2, 16, device="cpu")
            errs, gaps = [], []
            for t in range(3):
                watch.reset()
                lg, caches = decoder.decode_step(model, toks[:, t:t + 1], caches, t, cfg)
                errs.append(scaled_error(_np(lg_tf[:, t]), _np(lg[:, 0])))
                gaps.append(watch.gap)
        if dtype == "bfloat16":
            assert max(errs[:2]) < TEACHER_FORCING < errs[2], errs
            assert gaps[2] < 2.0**-11, gaps
        else:
            assert max(errs) <= F32_LOGITS, errs


@pytest.mark.parametrize("arch", FAMILIES)
def test_conversion_round_trips(arch):
    _, cfg, values, model = models(arch, "float32")
    back = convert.lm_params_to_arrays(model)
    flat_want = jax.tree_util.tree_flatten_with_path(values)[0]
    flat_got = dict((jax.tree_util.keystr(p), v) for p, v in
                    jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_got)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[jax.tree_util.keystr(path)], v)


@pytest.mark.parametrize("arch", FAMILIES)
def test_held_weights_change_no_logit(arch):
    """`Decoder.hold_compute_dtype`: bit-equal logits; norms, routers,
    Mamba2's decay and step parameters and RWKV's decay LoRA and bonus
    stay float32."""
    _, cfg, _, model = models(arch, "bfloat16")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 8)).astype(np.int32))
    with torch.no_grad():
        want, _ = decoder.apply(model, toks, cfg)
        model.hold_compute_dtype()
        got, _ = decoder.apply(model, toks, cfg)
    assert torch.equal(want, got)
    kept = {n.split(".")[-1] for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert kept <= {"scale", "bias", "router", "router_bias", "A_log", "D", "dt_bias",
                    "decay_base", "decay_w1", "decay_w2", "bonus_u"}, kept


def test_whisper_is_served_as_a_dense_decoder():
    """The reference's decoder builds an encoder-decoder config as a dense
    decoder (what ``python -m repro.launch.serve --arch whisper-tiny``
    serves): the port does the same, with finite (2, 1, 512) logits equal
    to the reference's, and refuses its prefill as the reference does."""
    jcfg, cfg, values, model = models("whisper-tiny", "float32")
    assert cfg.encdec and not hasattr(model, "enc_blocks")
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == {
        "embed", "blocks", "final_norm"}
    toks = np.array([[3], [7]], np.int32)
    jd, _ = jdec.decode_step(values, jnp.asarray(toks), jdec.init_decode_caches(jcfg, 2, 8),
                             jnp.int32(0), jcfg)
    with torch.no_grad():
        td, _ = decoder.decode_step(model, torch.from_numpy(toks),
                                    decoder.init_decode_caches(cfg, 2, 8, device="cpu"), 0, cfg)
    assert td.shape == (2, 1, 512) and torch.isfinite(td).all()
    assert scaled_error(_np(jd), _np(td)) <= F32_LOGITS
    with pytest.raises(NotImplementedError):
        jdec.prefill(values, jnp.asarray(toks), jcfg, max_len=8)
    with pytest.raises(NotImplementedError):
        decoder.prefill(model, torch.from_numpy(toks), cfg, max_len=8)


def test_decode_caches_are_the_references_layout():
    """Stacked layouts: zamba2's ``ceil(L / every)`` shared KV caches (7
    for 38 layers at full width), Mamba2's conv window in the compute
    dtype and SSM state in float32, RWKV's shifts and WKV state, MLA's
    latents."""
    for arch in FAMILIES:
        for smoke in (True, False):
            jcfg, cfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
            # Shapes only (abstract on the reference's side, on no device on the port's).
            want = jax.eval_shape(lambda: jdec.init_decode_caches(jcfg, 4, 128))
            got = decoder.init_decode_caches(cfg, 4, 128, device="meta")
            leaves = jax.tree_util.tree_leaves(want)
            assert [tuple(x.shape) for x in leaves] == [
                tuple(t.shape) for t in jax.tree_util.tree_leaves(tuple(got))], arch
            assert [x.dtype.name for x in leaves] == [
                str(t.dtype)[6:] for t in jax.tree_util.tree_leaves(tuple(got))], arch
    full = decoder.init_decode_caches(get_config("zamba2-1.2b"), 4, 128, device="meta")
    assert full.shared_kv.k.shape[0] == 7 and full.kv.conv.shape[0] == 38
