"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

import importlib
from typing import Dict

ARCHS: Dict[str, str] = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "ising-qmc": "repro_torch.configs.ising_qmc",
}


def get_module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str, smoke: bool = False):
    mod = get_module(arch)
    return mod.smoke_config() if smoke else mod.CONFIG
