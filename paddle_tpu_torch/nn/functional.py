"""Normalisation and activation of the model layers, in two roundings.

``rms_norm``, ``swiglu`` and ``RMSNorm`` are the model's layers and round as
``paddle_tpu/nn/functional.py`` does (:377, :182): the norm casts to the
input dtype BEFORE the weight multiply, and swiglu runs
``x * (1 / (1 + exp(-x))) * y`` op by op in the input dtype. In bf16 that is
bit for bit what the JAX model computes on the CPU.

``rms_norm_f32`` and ``swiglu_f32`` follow the fused serving path of the JAX
package (``incubate/nn/functional/fused_transformer.py``): the math runs in
f32 and the result is cast back once.

``layer_norm`` and ``group_norm`` (the RWKV and ViT layers) round as
``paddle_tpu/nn/functional.py:356-373`` and ``:426-445`` do: statistics in
f32, the normalised value cast to the input dtype before the affine
multiply and add (``torch.nn.LayerNorm`` rounds elsewhere in bf16).

``silu`` and ``interpolate`` (nearest, on the half-pixel grid of
``jax.image.resize``: the UNet's upsampling) are the UNet's.

``gelu`` (exact erf unless ``approximate``), ``scaled_dot_product_attention``
(``[b, s, h, d]`` into the port's ``flash_attention``, non-causal unless
``is_causal``) and the losses (``paddle_tpu/nn/functional.py:741-912``,
each one op under ``amp.amp_op`` by its JAX name: ``cross_entropy`` and the
binary cross-entropies in f32) are the functionals of ``nn/loss.py`` and
``nn/transformer.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import amp_op

__all__ = ["rms_norm", "swiglu", "RMSNorm", "rms_norm_f32", "swiglu_f32",
           "layer_norm", "group_norm", "LayerNorm", "GroupNorm", "gelu",
           "relu", "silu", "interpolate", "scaled_dot_product_attention",
           "cross_entropy",
           "mse_loss", "l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "smooth_l1_loss", "kl_div",
           "margin_ranking_loss", "cosine_embedding_loss",
           "hinge_embedding_loss", "triplet_margin_loss"]


@amp_op("rms_norm")
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``(x * rsqrt(mean(x²) + eps))`` in f32, cast to ``x.dtype``, then
    times ``weight``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


@amp_op("swiglu")
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` as ``jax.nn.silu`` spells it, in the input
    dtype."""
    return gate * (1 / (1 + torch.exp(-gate))) * up


def rms_norm_f32(x: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * weight`` in f32, cast to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def swiglu_f32(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in f32, cast to ``gate.dtype``."""
    return (F.silu(gate.float()) * up.float()).to(gate.dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


@amp_op("layer_norm")
def layer_norm(x: torch.Tensor, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis: ``(x - mean) * rsqrt(var + eps)`` in f32, cast to
    ``x.dtype``, then times ``weight`` and plus ``bias``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


@amp_op("group_norm")
def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """x ``[N, C, ...]`` in ``num_groups`` groups of channels: statistics
    over each group (and the trailing axes) in f32, the normalised value
    cast to ``x.dtype``, then the per-channel ``weight`` and ``bias``."""
    n, c = x.shape[0], x.shape[1]
    xs = x.reshape(n, num_groups, c // num_groups, *x.shape[2:])
    dims = tuple(range(2, xs.dim()))
    xf = xs.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype).reshape(x.shape)
    shape = [1, c] + [1] * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


class LayerNorm(nn.Module):
    """Weight 1 and bias 0 over the last axis of ``hidden_size``."""

    def __init__(self, hidden_size: int, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """Weight 1 and bias 0 per channel of ``num_channels`` in
    ``num_groups`` groups."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 device=None, dtype=torch.float32):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"GroupNorm: {num_channels} channels do not "
                             f"split into {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(num_channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(num_channels, device=device, dtype=dtype))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps)


# ---------------------------------------------------------------------------
# activations and attention
# ---------------------------------------------------------------------------
@amp_op("gelu")
def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU, exact (erf) unless ``approximate`` (tanh), as ``jax.nn.gelu``
    with the JAX package's default ``approximate=False``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@amp_op("relu")
def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


@amp_op("silu")
def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, as ``jax.nn.silu``."""
    return F.silu(x)


@amp_op("interpolate")
def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest") -> torch.Tensor:
    """Resize the trailing spatial axes of an NC... tensor to ``size`` (an
    int or one per axis) or by ``scale_factor`` (output size ``int(s *
    f)``), as ``paddle_tpu/nn/functional.py:1054-1069``. Only ``"nearest"``
    is ported: JAX's ``jax.image.resize(..., "nearest")`` samples output i
    at input ``floor((i + 0.5) * in / out)``, which is PyTorch's
    ``"nearest-exact"`` (its ``"nearest"`` is ``floor(i * in / out)``); for
    integer factors the two agree."""
    if mode != "nearest":
        raise NotImplementedError(f"interpolate: mode {mode!r} is not ported "
                                  f"(only 'nearest')")
    spatial = x.shape[2:]
    if size is None:
        if scale_factor is None:
            raise ValueError("interpolate: give size or scale_factor")
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size] * len(spatial))]
    return F.interpolate(x, size=size, mode="nearest-exact")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """Attention of ``[b, s, h, d]`` query, key and value through
    ``flash_attention`` (the kernels on CUDA tensors), non-causal unless
    ``is_causal``. Dropout inside attention is not ported: ``dropout_p > 0``
    in training raises on every device, never falling back to a plain
    version."""
    from ..ops.fused.flash_attention import flash_attention

    if training and dropout_p > 0.0:
        raise NotImplementedError(
            "scaled_dot_product_attention: dropout inside attention is not "
            "ported (ROADMAP B #1); use dropout_p=0 or eval mode")
    return flash_attention(query, key, value, causal=is_causal,
                           attn_mask=attn_mask)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


@amp_op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy of ``input`` logits (in f32) against integer labels
    (``ignore_index`` masked; a trailing 1 axis squeezed) or, with
    ``soft_label`` or a float label of the input's rank, a distribution;
    optional per-class ``weight`` and ``label_smoothing``."""
    axis = axis % input.dim()
    logits = input.float()
    logp = (torch.log_softmax(logits, dim=axis) if use_softmax
            else torch.log(torch.clamp_min(logits, 1e-30)))
    n = input.shape[axis]
    valid = None
    if soft_label or (label.is_floating_point()
                      and label.dim() == input.dim()):
        tgt = label.float()
        if label_smoothing > 0.0:
            tgt = tgt * (1.0 - label_smoothing) + label_smoothing / n
        loss = -(tgt * logp).sum(dim=axis)
    else:
        lbl = label
        if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0).long()
        picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0.0:
            loss = -(1.0 - label_smoothing) * picked \
                - label_smoothing * logp.mean(dim=axis)
        else:
            loss = -picked
        if weight is not None:
            w = torch.as_tensor(weight, device=input.device).float()[safe]
            loss = loss * w
        loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if valid is None:
            return loss.mean()
        if weight is not None:
            denom = torch.clamp_min(torch.where(valid, w, 0.0).sum(), 1e-12)
        else:
            denom = torch.clamp_min(valid.float().sum(), 1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


@amp_op("mse_loss")
def mse_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.square(input - label), reduction)


@amp_op("l1_loss")
def l1_loss(input, label, reduction: str = "mean"):
    return _reduce(torch.abs(input - label), reduction)


@amp_op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """Negative log-likelihood of log-probabilities ``input`` (classes on
    the last axis, or on axis 1 when the label has the input's rank)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, 0).long()
    if input.dim() == label.dim() + 1:
        picked = -input.gather(-1, safe[..., None])[..., 0]
    else:
        picked = -input.gather(1, safe)
    if weight is not None:
        picked = picked * weight[safe]
    picked = torch.where(valid, picked, 0.0)
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe], 0.0).sum()
        else:
            denom = torch.clamp_min(valid.float().sum(), 1.0)
        return picked.sum() / denom
    return _reduce(picked, reduction)


@amp_op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction: str = "mean"):
    x = torch.clamp(input.float(), 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(x) + (1.0 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("binary_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None):
    x = logit.float()
    lbl = label.float()
    # stable: max(x, 0) - x z + log(1 + exp(-|x|))
    loss = torch.clamp_min(x, 0.0) - x * lbl + torch.log1p(
        torch.exp(-torch.abs(x)))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1.0) * lbl + 1.0)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@amp_op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction: str = "mean",
                   delta: float = 1.0):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


@amp_op("kl_div")
def kl_div(input, label, reduction: str = "mean", log_target: bool = False):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@amp_op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean"):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


@amp_op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean"):
    cos = (input1 * input2).sum(dim=-1) / torch.clamp_min(
        torch.linalg.norm(input1, dim=-1) * torch.linalg.norm(input2,
                                                              dim=-1), 1e-12)
    loss = torch.where(label == 1, 1.0 - cos, torch.clamp_min(cos - margin,
                                                              0.0))
    return _reduce(loss, reduction)


@amp_op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean"):
    loss = torch.where(label == 1, input, torch.clamp_min(margin - input,
                                                          0.0))
    return _reduce(loss, reduction)


@amp_op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean"):
    def dist(a, b):
        return torch.pow(torch.pow(torch.abs(a - b) + epsilon, p).sum(dim=-1),
                         1.0 / p)

    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)
