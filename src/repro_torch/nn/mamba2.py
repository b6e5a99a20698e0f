"""Mamba-2 (SSD) block, arXiv:2405.21060: its configuration.

The block (chunked SSD scan, the recurrent decode) is the next LM slice of
the port (ROADMAP); a decoder config with ``mamba`` is refused by
`models.decoder` until then.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state
