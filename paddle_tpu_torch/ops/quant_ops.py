"""Weight-only quantization (the counterpart of ``weight_quantize`` and
``weight_dequantize`` in ``paddle_tpu/ops/quant_ops.py:228-248``).

Per-out-channel symmetric quantization of a ``[in, out]`` weight: int8 takes
``absmax / 127`` and clips to ±127, int4 ``absmax / 7`` and clips to ±7
(stored one value per int8; ``ops.cuda.int8_matmul.pack_int4`` packs two per
byte). The arithmetic is the JAX package's, so the result is bit-equal: f32
throughout, a division by the scale (never a multiply by its reciprocal), a
zero column divides by 1, and ``torch.round`` rounds half to even as
``jnp.round`` does.
"""

from __future__ import annotations

import torch

__all__ = ["weight_quantize", "weight_dequantize"]

_QMAX = {"weight_only_int8": 127.0, "llm.int8": 127.0,
         "weight_only_int4": 7.0}


def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8"):
    """``x [in, out]`` -> ``(q int8 [in, out], scale f32 [out])`` with
    ``x ≈ q * scale``."""
    if algo not in _QMAX:
        raise ValueError(f"unknown weight_quantize algo {algo!r}")
    qmax = _QMAX[algo]
    xf = x.float()
    scale = xf.abs().amax(dim=0) / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -qmax, qmax)
    return q.to(torch.int8), scale


def weight_dequantize(q: torch.Tensor, scale: torch.Tensor,
                      out_dtype=torch.float16) -> torch.Tensor:
    """``q [in, out]`` times the per-column ``scale`` in f32, cast to
    ``out_dtype``."""
    return (q.float() * scale.float()[None, :]).to(out_dtype)
