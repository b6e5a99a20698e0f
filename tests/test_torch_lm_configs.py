"""The port's configs (`repro_torch.configs`) against the reference's: every
field of ``CONFIG`` and ``smoke_config()`` for all 11 registry entries, and
the parameter counts, padded vocab and head dims — exact, integers and
strings; the compute dtype as a torch dtype."""

import dataclasses

import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import get_config as jget
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS, get_config, get_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LM_ARCHS = [a for a in ARCHS if a != "ising-qmc"]


def test_registry_names_the_references_archs():
    assert list(ARCHS) == list(JARCHS)
    assert all(mod.startswith("repro_torch.configs.") for mod in ARCHS.values())
    with pytest.raises(KeyError, match="unknown arch"):
        get_module("gpt-2")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_field_equals_the_references(arch, smoke):
    got, want = get_config(arch, smoke=smoke), jget(arch, smoke=smoke)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for f in dataclasses.fields(want):  # nested configs by class name too
        v = getattr(want, f.name)
        if dataclasses.is_dataclass(v):
            assert type(getattr(got, f.name)).__name__ == type(v).__name__
    if arch == "ising-qmc":
        assert (got.spins_per_model, got.total_spins) == (want.spins_per_model, want.total_spins)
        return
    assert got.num_params() == want.num_params()
    assert got.num_active_params() == want.num_active_params()
    assert got.padded_vocab == want.padded_vocab
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.compute_dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[got.dtype]
    for name in ("mamba", "rwkv"):
        sub, jsub = getattr(got, name), getattr(want, name)
        if jsub is not None:
            assert (sub.num_heads, getattr(sub, "d_inner", 0), getattr(sub, "conv_dim", 0)) == \
                   (jsub.num_heads, getattr(jsub, "d_inner", 0), getattr(jsub, "conv_dim", 0))


def test_shapes_and_skip_cell_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
           {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert dataclasses.asdict(base.MLASpec()) == dataclasses.asdict(jbase.MLASpec())
    assert issubclass(base.SkipCell, Exception)


def test_full_configs_match_assignment():
    """The reference's table of published numbers, on the port's configs."""
    expect = {
        "qwen2.5-14b": (48, 5120, 40, 8, 13824, 152064),
        "deepseek-coder-33b": (62, 7168, 56, 8, 19200, 32256),
        "gemma-2b": (18, 2048, 8, 1, 16384, 256000),
        "command-r-35b": (40, 8192, 64, 8, 22528, 256000),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "rwkv6-1.6b": (24, 2048, 32, 32, 7168, 65536),
        "deepseek-v3-671b": (61, 7168, 128, 128, 18432, 129280),
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "internvl2-26b": (48, 6144, 48, 8, 16384, 92553),
        "whisper-tiny": (4, 384, 6, 6, 1536, 51865),
    }
    for arch, (L, d, h, kv, ff, v) in expect.items():
        cfg = get_config(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.d_ff, cfg.vocab_size) == (L, d, h, kv, ff, v), arch
    dv3 = get_config("deepseek-v3-671b")
    assert dv3.moe.num_experts == 256 and dv3.moe.top_k == 8
    assert dv3.moe.d_ff_expert == 2048 and dv3.mla.kv_lora_rank == 512
    l4 = get_config("llama4-scout-17b-a16e")
    assert l4.moe.num_experts == 16 and l4.moe.top_k == 1
    assert get_config("zamba2-1.2b").mamba.d_state == 64
    assert get_config("gemma-2b").head_dim == 256


def test_moe_param_counts_sane():
    dv3 = get_config("deepseek-v3-671b")
    n = dv3.num_params()
    assert 6.3e11 < n < 7.2e11, n  # ~671B
    na = dv3.num_active_params()
    assert 3.0e10 < na < 4.5e10, na  # ~37B active


def test_gemma_2b_full_width_is_the_served_shape():
    """What `chip_smoke.py` phase 10 serves: 2,506,096,640 parameters."""
    cfg = get_config("gemma-2b")
    assert (cfg.num_layers, cfg.d_model, cfg.resolved_head_dim, cfg.padded_vocab) == \
           (18, 2048, 256, 256000)
    assert cfg.num_params() == 2_506_096_640


def test_chip_smoke_takes_the_papers_shape_from_the_config():
    """`chip_smoke.py`'s main shape, exp size and PT ladder come from
    `configs/ising_qmc.py`, with the values it had."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert (cs.MAIN_N, cs.MAIN_L, cs.LANES) == (96, 256, 128)
    assert cs.FASTEXP_MAIN == 115 * 96 * 256 == get_config("ising-qmc").total_spins
    assert (cs.PT_R, cs.PT_BETA_MIN, cs.PT_BETA_MAX) == (115, 0.1, 3.0)
    assert cs.MT_CHECK_V[-1] == 115 * 128
