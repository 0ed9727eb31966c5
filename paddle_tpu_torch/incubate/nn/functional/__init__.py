"""``paddle.incubate.nn.functional`` (the counterpart of
``paddle_tpu/incubate/nn/functional/__init__.py``): the fused transformer
entries and the fused building blocks with the JAX package's semantics and
argument names. Weights are in Paddle's ``[in, out]`` layout here.

``weight_only_linear`` runs the hand-written weight-only kernels
(``ops/cuda/int8_matmul``) on bf16 activations: int8 ``[K, N]`` as
:func:`quant_weights` lays it out, and int4 as it packs it (byte row r
holds rows 2r and 2r + 1), which is the kernel's half-split packing (byte
row r holds rows r and r + K/2) with K permuted: ``x @ W == cat(x[...,
0::2], x[..., 1::2]) @ W_halfsplit`` for the same bytes, so x's columns
are permuted and the packed weight is launched as given. A product the
kernel does not take (``kernel_takes``) goes that module's dequantize
route; an f32 (or f16) x is dequantized in its dtype and multiplied as the
JAX function does, on every device (the kernels take bf16 activations).
``fp8_gemm`` and ``fp8_quantize`` are torch ops (cast to
``float8_e4m3fn``, widen, f32 product), as they are XLA ops in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ....core.dtype import to_torch_dtype
from ....ops.cuda.int8_matmul import (int4_weight_matmul,
                                      int8_weight_matmul)
from ....ops.fused.flash_attention import flash_attention as _flash
from ....ops.fused.rope import fused_rotary_position_embedding
from .fused_transformer import (FusedTransformerWeights,
                                contiguous_page_table,
                                fused_multi_transformer,
                                fused_multi_transformer_paged,
                                fused_multi_transformer_paged_ragged,
                                fused_weights_from_llama,
                                paged_cache_from_dense)

__all__ = ["fused_rms_norm", "fused_layer_norm", "swiglu",
           "fused_multi_transformer", "fused_multi_transformer_paged",
           "fused_multi_transformer_paged_ragged", "FusedTransformerWeights",
           "fused_weights_from_llama", "fp8_gemm", "fp8_quantize",
           "fused_rotary_position_embedding", "flash_attention",
           "fused_dropout_add", "fused_linear", "fused_bias_act",
           "quant_weights", "weight_only_linear", "contiguous_page_table",
           "paged_cache_from_dense"]


def _pre_add(x, bias, residual):
    if bias is not None:
        x = x + bias
    if residual is not None:
        x = x + residual
    return x


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, bias=None, residual=None,
                   quant_scale=-1, **kw):
    """``x (+ bias) (+ residual)``, then RMS norm over the last axis in f32
    (cast to x's dtype), times ``norm_weight``, plus ``norm_bias``. Returns
    ``(out, residual_out)`` when ``residual`` is given (residual_out is the
    pre-added x), else ``out``."""
    x = _pre_add(x, bias, residual)
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
         ).to(x.dtype)
    if norm_weight is not None:
        y = y * norm_weight
    if norm_bias is not None:
        y = y + norm_bias
    return (y, x) if residual is not None else y


def fused_layer_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-5,
                     begin_norm_axis=-1, bias=None, residual=None, **kw):
    """``x (+ bias) (+ residual)``, then layer norm over the axes from
    ``begin_norm_axis`` on in f32 (cast to x's dtype), times
    ``norm_weight``, plus ``norm_bias``; ``(out, residual_out)`` with a
    residual."""
    x = _pre_add(x, bias, residual)
    axis = begin_norm_axis % x.dim()
    dims = tuple(range(axis, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if norm_weight is not None:
        y = y * norm_weight
    if norm_bias is not None:
        y = y + norm_bias
    return (y, x) if residual is not None else y


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; without ``y``, x's last axis is split in halves."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return x * torch.sigmoid(x) * y


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None, generator=None):
    """``dropout(x) + y``. The keep mask is drawn from ``generator`` (a
    ``torch.Generator`` on x's device; the default one without it): JAX
    draws from its own key chain, so only the law of the mask is shared.
    ``mode`` "upscale_in_train" scales the kept values by ``1 / (1 - p)``
    in training; "downscale_in_infer" scales x by ``1 - p`` outside it."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p) + y
        return x + y
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    out = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    if mode == "upscale_in_train":
        out = out / (1.0 - p)
    return out + y


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight (+ bias)`` with ``weight [in, out]`` (``[out, in]``
    with ``transpose_weight``)."""
    y = F.linear(x, weight if transpose_weight else weight.t())
    return y if bias is None else y + bias


_ACTS = {"gelu": lambda x: F.gelu(x), "relu": F.relu, "silu": F.silu,
         "swish": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "relu6": F.relu6, "swiglu": swiglu}


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """``act(x (+ bias))`` for ``act_method`` in gelu (exact), relu, silu,
    swish, sigmoid, tanh, relu6 and swiglu (halves of the last axis)."""
    if act_method not in _ACTS:
        raise ValueError(f"fused_bias_act: unknown act_method {act_method!r}"
                         f" (known: {', '.join(sorted(_ACTS))})")
    if bias is not None:
        x = x + bias
    return _ACTS[act_method](x)


def flash_attention(q, k, v, causal=False, attn_mask=None, dropout_p=0.0,
                    scale=None, kv_len=None, q_segment_ids=None,
                    kv_segment_ids=None):
    """Flash attention ``[b, s, heads, head_dim]`` with JAX's argument
    order, on the port's flash route (the kernels on CUDA tensors).
    Dropout is not ported: ``dropout_p`` must be 0."""
    if dropout_p:
        raise NotImplementedError("flash_attention: dropout is not ported "
                                  "(dropout_p must be 0)")
    return _flash(q, k, v, causal=causal, scale=scale, kv_len=kv_len,
                  attn_mask=attn_mask, q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids)


# ------------------------------------------------------- weight-only quant
def _pack_nibbles(lo, hi):
    packed = ((hi.to(torch.int32) & 15) << 4) | (lo.to(torch.int32) & 15)
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def quant_weights(weight, algo="weight_only_int8", arch=None, group_size=-1):
    """``weight [in, out]`` -> ``(q int8, scale f32 [out])``, per output
    channel: ``scale = max(absmax / qmax, 1e-9)``, ``q = clip(round(w /
    scale), -qmax - 1, qmax)``, in the weight's dtype as JAX computes it
    (bit for bit). int4 (qmax 7) packs two values a byte along the input
    dim: byte row r holds row 2r in its low nibble and 2r + 1 in its high
    one, ``q [in / 2, out]``."""
    bits = 4 if algo == "weight_only_int4" else 8
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(weight.abs().amax(dim=0) / qmax, min=1e-9)
    q = torch.clamp(torch.round(weight / scale), -qmax - 1, qmax) \
        .to(torch.int8)
    if bits == 4:
        if q.shape[0] % 2:
            raise ValueError("int4 packing needs an even input dim")
        q = _pack_nibbles(q[0::2], q[1::2])
    return q, scale.to(torch.float32)


def _unpack_interleaved(q):
    """int4 bytes ``[K/2, N]`` -> int8 ``[K, N]``, rows 2r and 2r + 1 from
    byte row r, each nibble sign-extended."""
    w = q.to(torch.int32)
    lo, hi = ((w & 15) ^ 8) - 8, w >> 4
    return torch.stack([lo, hi], dim=1).reshape(-1, *q.shape[1:]) \
        .to(torch.int8)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``x [..., K] @ dequant(weight) (+ bias)``: ``weight`` int8 ``[K,
    N]`` or int4 packed ``[K/2, N]`` (:func:`quant_weights`), ``weight_scale
    [N]`` per output channel. bf16 x: the weight-only kernels (f32
    accumulation, the scale applied to the accumulator), or their plain
    version on CPU tensors; other float x: dequantized in x's dtype, as
    JAX does. The output is in x's dtype."""
    int4 = weight_dtype == "int4"
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_only_linear: weight_dtype {weight_dtype!r}"
                         f" must be 'int8' or 'int4'")
    N = weight.shape[1]
    scale = torch.ones(N, dtype=torch.float32, device=weight.device) \
        if weight_scale is None else weight_scale
    lead, K = x.shape[:-1], x.shape[-1]
    if x.dtype == torch.bfloat16:
        x2 = x.reshape(-1, K)
        if int4:
            x2 = torch.cat([x2[:, 0::2], x2[:, 1::2]], dim=1)
            y = int4_weight_matmul(x2, weight, scale.float())
        else:
            y = int8_weight_matmul(x2, weight, scale.float())
        y = y.reshape(*lead, N)
    else:
        q = _unpack_interleaved(weight) if int4 else weight
        y = x @ (q.to(x.dtype) * scale.to(x.dtype))
    return y if bias is None else y + bias


# ------------------------------------------------------------------ fp8
def _fp8(t, s):
    return (t.float() / s).to(torch.float8_e4m3fn)


def fp8_gemm(x, y, scale_x=1.0, scale_y=1.0, out_dtype=None,
             transpose_y=False):
    """FP8 (e4m3) GEMM: x and y divided by their per-tensor scales and cast
    to ``float8_e4m3fn``, widened and multiplied in f32, times ``scale_x *
    scale_y``, cast to ``out_dtype`` (default x's dtype)."""
    x8, y8 = _fp8(x, scale_x), _fp8(y, scale_y)
    yf = y8.float()
    acc = x8.float() @ (yf.transpose(-1, -2) if transpose_y else yf)
    acc = acc * (scale_x * scale_y)
    return acc.to(to_torch_dtype(out_dtype) if out_dtype else x.dtype)


def fp8_quantize(x, scale=None):
    """``(x / s)`` as ``float8_e4m3fn`` and ``s``: ``s = max|x| / 448``
    (or ``scale``), at least 1e-12, an f32 scalar."""
    s = x.float().abs().amax() / 448.0 if scale is None \
        else torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    s = torch.clamp_min(s, 1e-12)
    return _fp8(x, s), s
