"""Shared helpers for per-arch config modules: input specs per shape cell.

``input_specs(cfg, shape)`` returns ``(step_kind, inputs)`` where inputs are
meta tensors (shapes and dtypes, no storage) standing in for every
argument of the step function the cell runs:

  train   -> train_step(state, batch): here we return the batch; the state
             comes from the model's parameters elsewhere.
  prefill -> apply(params, tokens, ...): the token batch.
  decode  -> decode_step(params, token, caches, cur_len): token + caches
             built by the cache initializer under a fake-tensor mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec, SkipCell

i32 = torch.int32


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: the reference's ``ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def token_batch(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    text_len = S
    if cfg.vlm_patches:
        text_len = S - cfg.vlm_patches
        batch["visual_embeds"] = sds((B, cfg.vlm_patches, cfg.d_model), torch.bfloat16)
    if cfg.encdec:
        batch["frames"] = sds((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    batch["tokens"] = sds((B, text_len), i32)
    if shape.kind == "train":
        batch["labels"] = sds((B, text_len), i32)
    return batch


def _to_meta(tree):
    """The same tree with each tensor replaced by a meta tensor of its shape and dtype."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_meta(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_meta(t) for t in tree)
    return sds(tree.shape, tree.dtype)


def abstract_decode_caches(cfg: ModelConfig, batch: int, max_len: int):
    from repro_torch.models import decoder, encdec

    if cfg.encdec:
        from torch._subclasses.fake_tensor import FakeTensorMode

        # The cross K/V come from running the encoder: under a fake mode,
        # with no storage and no arithmetic.
        with FakeTensorMode():
            model = encdec.init_params(torch.Generator(), cfg, device="cpu")
            frames = torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16)
            with torch.no_grad():
                caches = encdec.init_decode_caches(model, frames, cfg, max_len)
        return _to_meta(caches)
    return decoder.init_decode_caches(cfg, batch, max_len, device="meta")


DEFAULT_LONG_SKIP = (
    "full quadratic attention: a 524288-token KV cache/attention pass is "
    "out of scope for this arch (sub-quadratic models run this cell); see "
    "DESIGN.md §Arch-applicability"
)


def input_specs(
    cfg: ModelConfig,
    shape: ShapeSpec,
    *,
    allow_long: bool = False,
) -> Tuple[str, Dict[str, Any]]:
    if shape.name == "long_500k" and not allow_long:
        raise SkipCell(f"{cfg.name} x long_500k: {DEFAULT_LONG_SKIP}")
    if shape.kind in ("train", "prefill"):
        return shape.kind, token_batch(cfg, shape)
    # decode: one new token against a cache of seq_len.
    B, S = shape.global_batch, shape.seq_len
    cfg_d = dataclasses.replace(cfg, max_target_length=S + 8)
    caches = abstract_decode_caches(cfg_d, B, S + 8)
    inputs = {
        "token": sds((B, 1), i32),
        "caches": caches,
        "cur_len": sds((), i32),
    }
    if cfg.encdec:
        inputs["frames"] = sds((B, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return "decode", inputs
