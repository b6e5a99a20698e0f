"""The port's LM layers (`repro_torch.nn.basic`, `repro_torch.nn.attention`)
against the reference's, on the same numpy inputs and parameters, in
float32 and bfloat16, within the bounds that ROADMAP §3w's trap
(`test_torch_lm_trap.py`) measured and names: ``F32_LAYER`` and
``BF16_LAYER`` on the scaled error.  Every branch of `chunked_attention`
(one query chunk, the pruned causal chunks, the scanned chunks,
non-causal), both softmax exps, and the decode step over a cache."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.nn import attention as jattn
from repro.nn import basic as jb
from repro.nn.param import split_tree as jsplit
from repro_torch.nn import attention as tattn
from repro_torch.nn import basic as tb
from repro_torch.nn.param import Param, ParamModule, is_param, split_tree
from test_torch_lm_trap import BF16_LAYER, F32_LAYER, scaled_error
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DT = {"float32": (jnp.float32, torch.float32, F32_LAYER),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_LAYER)}
dtypes = pytest.mark.parametrize("dtype", list(DT))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(p: dict):
    """A numpy parameter dict as the reference's and the port's."""
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(x: np.ndarray, dtype: str):
    jdt, tdt, _ = DT[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _close(want, got, dtype: str, what: str = ""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    err = scaled_error(want, got)
    assert err <= DT[dtype][2], (what, dtype, err)
    return err


# --- basic --------------------------------------------------------------------------


@dtypes
@pytest.mark.parametrize("bias", [False, True])
def test_linear(dtype, bias):
    p = {"kernel": _rand(1, 32, 48)}
    if bias:
        p["bias"] = _rand(2, 48)
    jp, tp = _both(p)
    jx, tx = _x(_rand(3, 2, 5, 32), dtype)
    _close(jb.linear_apply(jp, jx, DT[dtype][0]), tb.linear_apply(tp, tx, DT[dtype][1]), dtype)


@dtypes
@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm(dtype, zero_centered):
    jp, tp = _both({"scale": _rand(4, 64, scale=0.5)})
    jx, tx = _x(_rand(5, 2, 7, 64, scale=3.0), dtype)
    want = jb.rmsnorm_apply(jp, jx, zero_centered=zero_centered)
    got = tb.rmsnorm_apply(tp, tx, zero_centered=zero_centered)
    assert got.dtype == DT[dtype][1]
    _close(want, got, dtype)


@dtypes
def test_layernorm(dtype):
    jp, tp = _both({"scale": _rand(6, 64), "bias": _rand(7, 64)})
    jx, tx = _x(_rand(8, 2, 7, 64, scale=2.0) + 1.5, dtype)
    _close(jb.layernorm_apply(jp, jx), tb.layernorm_apply(tp, tx), dtype)


@dtypes
def test_embedding_lookup_and_tied_logits(dtype):
    jdt, tdt, _ = DT[dtype]
    jp, tp = _both({"table": _rand(9, 96, 32)})
    tokens = np.random.default_rng(10).integers(0, 96, (3, 11)).astype(np.int32)
    want = jb.embedding_lookup(jp, jnp.asarray(tokens), jdt)
    got = tb.embedding_lookup(tp, torch.from_numpy(tokens), tdt)
    # A lookup and a cast: equal bit for bit.
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)), got.float().numpy())
    jx, tx = _x(_rand(11, 3, 11, 32), dtype)
    _close(jb.embedding_logits(jp, jx, jdt), tb.embedding_logits(tp, tx, tdt), dtype)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6), (256, 1e4), (128, 8e6)])
def test_rope_frequencies_are_the_references(hd, theta):
    np.testing.assert_array_equal(jb.rope_frequencies(hd, theta), tb.rope_frequencies(hd, theta))


@dtypes
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(dtype, theta):
    jx, tx = _x(_rand(12, 2, 40, 3, 32), dtype)
    pos = np.broadcast_to(np.arange(1000, 1040, dtype=np.int32), (2, 40))
    want = jb.apply_rope(jx, jnp.asarray(pos), theta)
    got = tb.apply_rope(tx, torch.from_numpy(np.ascontiguousarray(pos)), theta)
    _close(want, got, dtype)


@dtypes
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu_sq"])
def test_mlp(dtype, kind):
    p = {"wi": _rand(13, 32, 96, scale=0.2), "wo": _rand(14, 96, 32, scale=0.1)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = _rand(15, 32, 96, scale=0.2)
    jp, tp = _both(p)
    jx, tx = _x(_rand(16, 2, 9, 32), dtype)
    _close(jb.mlp_apply(jp, jx, kind, DT[dtype][0]), tb.mlp_apply(tp, tx, kind, DT[dtype][1]),
           dtype, kind)


def test_mlp_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        tb.mlp_apply({"wi": torch.zeros(2, 2), "wo": torch.zeros(2, 2)}, torch.zeros(1, 2), "tanh")
    with pytest.raises(ValueError, match="unknown mlp kind"):
        tb.MLP(torch.Generator().manual_seed(0), 4, 8, "tanh")


def _tree_axes(tree):
    return {k: (_tree_axes(v) if isinstance(v, dict) else v) for k, v in tree.items()}


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape)) for k, v in tree.items()}


@pytest.mark.parametrize("case", ["linear", "linear_bias", "rmsnorm", "layernorm", "embedding",
                                  "swiglu", "gelu", "attention", "attention_bias"])
def test_init_trees_have_the_references_names_shapes_and_axes(case):
    """Values differ (another generator); names, shapes, logical axes and
    the float32 dtype are the reference's."""
    g, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(0)
    ref, port = {
        "linear": (lambda: jb.linear_init(key, 8, 12, logical=("embed", "mlp")),
                   lambda: tb.linear_init(g, 8, 12, logical=("embed", "mlp"))),
        "linear_bias": (lambda: jb.linear_init(key, 8, 12, logical=("embed", "mlp"), bias=True),
                        lambda: tb.linear_init(g, 8, 12, logical=("embed", "mlp"), bias=True)),
        "rmsnorm": (lambda: jb.rmsnorm_init(8), lambda: tb.rmsnorm_init(8)),
        "layernorm": (lambda: jb.layernorm_init(8), lambda: tb.layernorm_init(8)),
        "embedding": (lambda: jb.embedding_init(key, 50, 8), lambda: tb.embedding_init(g, 50, 8)),
        "swiglu": (lambda: jb.mlp_init(key, 8, 24), lambda: tb.mlp_init(g, 8, 24)),
        "gelu": (lambda: jb.mlp_init(key, 8, 24, "gelu"), lambda: tb.mlp_init(g, 8, 24, "gelu")),
        "attention": (lambda: jattn.attention_init(key, 16, 4, 2, 8),
                      lambda: tattn.attention_init(g, 16, 4, 2, 8)),
        "attention_bias": (lambda: jattn.attention_init(key, 16, 4, 2, 8, qkv_bias=True),
                           lambda: tattn.attention_init(g, 16, 4, 2, 8, qkv_bias=True)),
    }[case]
    jv, jl = jsplit(ref())
    tv, tl = split_tree(port())
    assert _tree_axes(tl) == _tree_axes(jl)
    assert _shapes(tv) == _shapes(jv)
    assert all(v.dtype == torch.float32 for v in tv.values())


def test_init_scales_are_the_references():
    """The fan-in scale: std 1/sqrt(fan_in) (the embedding's fan-in is
    int(1/0.02^2) = 2499); zero biases, unit norm scales."""
    g = torch.Generator().manual_seed(0)
    table = tb.embedding_init(g, 4000, 64)["table"].value
    assert abs(float(table.std()) - 1 / math.sqrt(2499)) < 2e-4
    wq = tattn.attention_init(g, 256, 4, 2, 32)["wq"].value
    assert abs(float(wq.std()) - 1 / 16) < 1e-3
    wo = tb.mlp_init(g, 64, 1024)["wo"].value
    assert abs(float(wo.std()) - 1 / 32) < 5e-4
    assert float(tb.layernorm_init(8)["bias"].value.abs().max()) == 0.0
    assert float(tb.rmsnorm_init(8)["scale"].value.min()) == 1.0


def test_param_module_keeps_logical_axes_and_refuses_other_leaves():
    m = tb.MLP(torch.Generator().manual_seed(0), 8, 16, "geglu")
    assert m.logical_axes() == {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
                                "wo": ("mlp", "embed")}
    assert not any(p.requires_grad for p in m.parameters())
    assert is_param(Param(torch.zeros(1), ("embed",)))
    with pytest.raises(TypeError):
        ParamModule({"w": torch.zeros(2)})


@dtypes
def test_hold_in_changes_no_result(dtype):
    """Holding the weights in the compute dtype gives the same bits as a
    cast at every use; norms stay float32."""
    g = torch.Generator().manual_seed(3)
    tdt = DT[dtype][1]
    mlp, norm = tb.MLP(g, 16, 32, dtype=tdt), tb.RMSNorm(16, zero_centered=True)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(_rand(17, 16)))
    x = torch.from_numpy(_rand(18, 2, 3, 16)).to(tdt)
    want = mlp(norm(x))
    tb.hold_in(mlp, tdt)
    tb.hold_in(norm, tdt)
    assert mlp.wi.dtype == tdt and norm.scale.dtype == torch.float32
    assert torch.equal(mlp(norm(x)), want)


# --- attention ----------------------------------------------------------------------


@pytest.mark.parametrize("n,target", [(8, 16), (32, 16), (48, 32), (30, 16), (7, 4), (13, 5)])
def test_pick_chunk_is_the_references(n, target):
    assert tattn._pick_chunk(n, target) == jattn._pick_chunk(n, target)


#: (id, Sq, Skv, H, K, q_chunk, kv_chunk, causal, skip): every branch.
ATTN_CASES = [
    ("one-q-chunk", 16, 16, 4, 2, 16, 8, True, False),
    ("skip-masked", 32, 32, 4, 2, 8, 8, True, True),
    ("scanned", 32, 32, 4, 1, 8, 16, True, False),
    ("uneven-chunks", 30, 30, 4, 4, 16, 16, True, True),
    ("non-causal", 24, 40, 6, 2, 8, 8, False, False),
]


@dtypes
@pytest.mark.parametrize("softmax_exp", ["exact", "fast"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_chunked_attention(case, softmax_exp, dtype):
    _, Sq, Skv, H, K, qc, kc, causal, skip = case
    D = 16
    jq, tq = _x(_rand(20, 2, Sq, H, D), dtype)
    jk, tk = _x(_rand(21, 2, Skv, K, D), dtype)
    jv, tv = _x(_rand(22, 2, Skv, K, D), dtype)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, skip_masked_chunks=skip,
              softmax_exp=softmax_exp)
    want = jattn.chunked_attention(jq, jk, jv, **kw)
    got = tattn.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == DT[dtype][1]
    _close(want, got, dtype)


def test_fastexp_softmax_attention_close_to_exact():
    """The reference's bound for the paper's exp inside the softmax (0.08,
    ``tests/test_serving.py``), on the port's attention."""
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 64, 4, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
               for _ in range(3))
    exact = tattn.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    fast = tattn.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=16,
                                   softmax_exp="fast")
    assert scaled_error(exact.numpy(), fast.numpy()) < 0.08


def _attn_params(H, K, D, d, bias):
    p = {"wq": _rand(30, d, H, D, scale=d**-0.5), "wk": _rand(31, d, K, D, scale=d**-0.5),
         "wv": _rand(32, d, K, D, scale=d**-0.5), "wo": _rand(33, H, D, d, scale=(H * D)**-0.5)}
    if bias:
        p.update(bq=_rand(34, H, D, scale=0.1), bk=_rand(35, K, D, scale=0.1),
                 bv=_rand(36, K, D, scale=0.1))
    return p


@dtypes
@pytest.mark.parametrize("bias,theta", [(False, 1e4), (True, 1e6), (False, 0.0)],
                         ids=["rope", "bias-rope", "no-rope"])
def test_attention_apply(dtype, bias, theta):
    jp, tp = _both(_attn_params(4, 2, 16, 32, bias))
    jx, tx = _x(_rand(37, 2, 24, 32), dtype)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    kw = dict(rope_theta=theta, q_chunk=8, kv_chunk=8)
    jy, (jk, jv) = jattn.attention_apply(jp, jx, jnp.asarray(pos), dtype=DT[dtype][0], **kw)
    ty, (tk, tv) = tattn.attention_apply(tp, tx, torch.from_numpy(np.ascontiguousarray(pos)),
                                         dtype=DT[dtype][1], **kw)
    for want, got in ((jy, ty), (jk, tk), (jv, tv)):
        _close(want, got, dtype)


@dtypes
@pytest.mark.parametrize("cur_len", [0, 5, 15])
def test_decode_attention_apply(dtype, cur_len):
    """One token over a filled cache: the output and the cache written at
    ``cur_len`` (in place in the port)."""
    jdt, tdt, _ = DT[dtype]
    jp, tp = _both(_attn_params(4, 1, 16, 32, True))
    jx, tx = _x(_rand(40, 2, 1, 32), dtype)
    k0, v0 = _rand(41, 2, 16, 1, 16), _rand(42, 2, 16, 1, 16)
    jc = jattn.KVCache(jnp.asarray(k0).astype(jdt), jnp.asarray(v0).astype(jdt))
    tc = tattn.KVCache(torch.from_numpy(k0).to(tdt), torch.from_numpy(v0).to(tdt))
    jy, jc2 = jattn.decode_attention_apply(jp, jx, jc, jnp.int32(cur_len), dtype=jdt)
    ty, tc2 = tattn.decode_attention_apply(tp, tx, tc, cur_len, dtype=tdt)
    assert tc2.k is tc.k  # written in place
    _close(jy, ty, dtype)
    _close(jc2.k, tc2.k, dtype)
    _close(jc2.v, tc2.v, dtype)
    # Only position cur_len changed.
    other = np.arange(16) != cur_len
    np.testing.assert_array_equal(tc2.k.float().numpy()[:, other],
                                  torch.from_numpy(k0).to(tdt).float().numpy()[:, other])


def test_attention_module_calls_the_functions():
    g = torch.Generator().manual_seed(1)
    m = tattn.Attention(g, 32, 4, 2, 8, qkv_bias=True, dtype=torch.float32, q_chunk=4,
                        kv_chunk=4)
    x = torch.from_numpy(_rand(50, 1, 8, 32))
    pos = torch.arange(8, dtype=torch.int32)[None]
    y, (k, v) = m(x, pos)
    want, _ = tattn.attention_apply(m.params(), x, pos, dtype=torch.float32, q_chunk=4,
                                    kv_chunk=4)
    assert torch.equal(y, want)
    assert m.logical_axes()["bk"] == ("kv_heads", "head_dim")
