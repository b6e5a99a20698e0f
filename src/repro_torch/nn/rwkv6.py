"""RWKV-6 "Finch" block, arXiv:2404.05892: its configuration.

Time and channel mixing are the next LM slice of the port (ROADMAP); a
decoder config with ``rwkv`` is refused by `models.decoder` until then.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_mix: int = 32
    lora_decay: int = 64
    chunk: int = 16

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim
