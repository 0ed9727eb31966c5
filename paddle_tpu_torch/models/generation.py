"""The decode tail shared by every path that turns hidden rows into logits."""

from __future__ import annotations

import torch

__all__ = ["lm_head_tail"]


def lm_head_tail(h_last: torch.Tensor, final_norm: torch.Tensor,
                 head: torch.Tensor, eps: float) -> torch.Tensor:
    """Final RMS norm then the LM head, both in f32: ``h_last [N, D]`` ->
    logits ``[N, V]``. ``head`` is ``[D, V]`` (the JAX layout; pass
    ``lm_head.weight.t()``). Same numerics as
    ``paddle_tpu.models.generation.lm_head_tail``."""
    hf = h_last.float()
    var = hf.square().mean(dim=-1, keepdim=True)
    hf = hf * torch.rsqrt(var + eps) * final_norm.float()
    return hf @ head.float()
