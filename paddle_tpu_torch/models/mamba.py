"""Mamba-1 (selective state-space) causal LM as ``torch.nn`` modules: the
counterpart of ``paddle_tpu/models/mamba.py``, with the JAX model's
parameter names and shapes (linear weights in PyTorch's ``[out, in]``).

The selective scan runs on CUDA tensors through the hand-written forward
and backward kernels (``ops/cuda/selective_scan.py``), on CPU tensors
through their plain version; with ``FLAGS_mamba_logdepth_scan`` set
(``core.flags.set_flags({"mamba_logdepth_scan": True})``) through the
log-depth kernels and their plain versions. Every parameter is in the config's dtype, as
``astype(dtype)`` leaves the JAX model: ``A = -exp(A_log)`` and the skip
``D`` are computed in it too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import amp_op
from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..core.flags import flag
from ..nn.functional import RMSNorm
from ..ops.cuda import selective_scan as _scan
from ..ops.cuda._build import device_of
from .llama import causal_lm_loss

__all__ = ["MambaConfig", "MambaForCausalLM", "MambaBlock", "selective_scan",
           "conv_proj"]


@dataclass
class MambaConfig:
    vocab_size: int = 50277
    hidden_size: int = 768
    state_size: int = 16          # n: per-channel SSM state
    conv_kernel: int = 4
    expand: int = 2               # inner width = expand * hidden
    num_hidden_layers: int = 24
    dt_rank: int = 0              # 0 -> ceil(hidden / 16)
    scan_chunk: int = 64
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        if self.dt_rank == 0:
            self.dt_rank = math.ceil(self.hidden_size / 16)

    @property
    def inner_size(self) -> int:
        return self.expand * self.hidden_size


class _ScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, B, C):
        y, bounds = _scan.selective_scan_fwd(u, delta, A, B, C)
        ctx.save_for_backward(u, delta, A, B, C, bounds)
        return y

    @staticmethod
    def backward(ctx, dy):
        return _scan.selective_scan_bwd(*ctx.saved_tensors, dy.contiguous())


class _LogdepthScanFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, B, C, span):
        y, bounds = _scan.selective_scan_logdepth_fwd(u, delta, A, B, C, span)
        ctx.save_for_backward(u, delta, A, B, C, bounds)
        ctx.span = span
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*_scan.selective_scan_logdepth_bwd(
            *ctx.saved_tensors, dy.contiguous(), ctx.span), None)


@amp_op("selective_scan")
def selective_scan(u, delta, A, B, C, D, chunk: int = 64):
    """``y_t = C_t . h_t + D u_t`` with ``h_t = exp(delta_t A) h_{t-1} +
    delta_t B_t u_t``; u, delta ``[b, l, d]``, A ``[d, n]``, B, C ``[b, l,
    n]``, D ``[d]``; returns ``[b, l, d]`` in u's dtype.

    Which chunk each route keeps:

    * ``FLAGS_mamba_logdepth_scan`` on (JAX's ``logdepth=True``): the
      sequence is cut into spans of ``scan_span(l, chunk)`` steps (the
      ``selective_scan_blocks`` flag, else ``chunk``, clamped to [8, l], as
      JAX's Pallas route resolves its chunk) and each span scanned in
      log depth; CUDA tensors launch the log-depth kernels (spans of 8,
      16, 32 or 64 steps; another span raises), CPU tensors take their
      plain versions; one autograd function either way;
    * off, CUDA tensors: the sequential forward and backward kernels as one
      autograd function; they keep the state every :data:`KERNEL_CHUNK`
      steps whatever ``chunk`` says (the result differs from JAX's chunk
      only in rounding);
    * off, CPU tensors: the plain chunked version with ``chunk`` (the XLA
      route's), whose autograd gives the gradient."""
    if flag("mamba_logdepth_scan"):
        y = _LogdepthScanFn.apply(u, delta, A, B, C,
                                  _scan.scan_span(u.shape[1], chunk))
    elif device_of("selective_scan", u, delta, A, B, C, D) == "cpu":
        y = _scan.selective_scan_reference(u, delta, A, B, C, chunk)
    else:
        y = _ScanFn.apply(u, delta, A, B, C)
    return y + u * D


class MambaBlock(nn.Module):
    """in_proj -> causal depthwise conv -> silu -> x_proj (dt, B, C) ->
    softplus dt_proj -> selective scan -> gate silu(z) -> out_proj."""

    def __init__(self, cfg: MambaConfig, **dd):
        super().__init__()
        h, d, n = cfg.hidden_size, cfg.inner_size, cfg.state_size
        self.config = cfg
        self.in_proj = nn.Linear(h, 2 * d, bias=False, **dd)
        self.conv_weight = nn.Parameter(torch.empty(d, 1, cfg.conv_kernel,
                                                    **dd))
        self.conv_bias = nn.Parameter(torch.zeros(d, **dd))
        self.x_proj = nn.Linear(d, cfg.dt_rank + 2 * n, bias=False, **dd)
        self.dt_proj = nn.Linear(cfg.dt_rank, d, **dd)
        self.A_log = nn.Parameter(torch.empty(d, n, **dd))
        self.D = nn.Parameter(torch.ones(d, **dd))
        self.out_proj = nn.Linear(d, h, bias=False, **dd)

    def forward(self, x):
        cfg = self.config
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        xc, delta, A, Bm, Cm = conv_proj(
            xs, self.conv_weight, self.conv_bias, self.x_proj.weight,
            self.dt_proj.weight, self.dt_proj.bias, self.A_log, cfg)
        y = selective_scan(xc, delta, A, Bm, Cm, self.D, cfg.scan_chunk)
        return self.out_proj(y * F.silu(z))


@amp_op("mamba_conv_proj")
def conv_proj(xs, conv_weight, conv_bias, x_proj_weight, dt_proj_weight,
              dt_proj_bias, A_log, cfg: MambaConfig):
    """Causal depthwise conv -> silu -> x_proj (dt, B, C) -> softplus
    dt_proj, and ``A = -exp(A_log)``: one op of JAX's block, so under
    ``auto_cast`` its inputs are cast together and nothing inside is."""
    d, k = cfg.inner_size, cfg.conv_kernel
    xpad = F.pad(xs.transpose(1, 2), (k - 1, 0))              # [b, d, l+k-1]
    xc = F.conv1d(xpad, conv_weight, groups=d).transpose(1, 2)
    xc = F.silu(xc + conv_bias)
    dt, Bm, Cm = F.linear(xc, x_proj_weight).split(
        [cfg.dt_rank, cfg.state_size, cfg.state_size], dim=-1)
    delta = F.softplus(F.linear(dt, dt_proj_weight, dt_proj_bias))
    return xc, delta, -torch.exp(A_log), Bm, Cm


class _MambaLayer(nn.Module):
    def __init__(self, cfg: MambaConfig, **dd):
        super().__init__()
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **dd)
        self.mixer = MambaBlock(cfg, **dd)

    def forward(self, x):
        return x + self.mixer(self.norm(x))


class MambaForCausalLM(nn.Module):
    """Weights are drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``, by the JAX model's rules:
    normal(0, initializer_range) for the embedding, in_proj, conv, x_proj
    and dt_proj weights, out_proj scaled by ``1 / sqrt(2 L)``, zero biases,
    the S4D-real ``A_log = log(1 .. n)``, ``D = 1``, norms 1."""

    def __init__(self, config: MambaConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **dd)
        self.layers = nn.ModuleList(
            [_MambaLayer(config, **dd)
             for _ in range(config.num_hidden_layers)])
        self.norm_f = RMSNorm(config.hidden_size, config.rms_norm_eps, **dd)
        with torch.no_grad():
            self._init_weights(make_generator(seed, dev))

    def _init_weights(self, gen: torch.Generator):
        cfg = self.config
        std = cfg.initializer_range
        out_std = std / math.sqrt(2 * cfg.num_hidden_layers)
        a_log = torch.log(torch.arange(1, cfg.state_size + 1,
                                       dtype=torch.float32))
        for name, p in self.named_parameters():
            if name.endswith(("norm.weight", "norm_f.weight", ".D")):
                p.fill_(1.0)
            elif name.endswith(("conv_bias", "dt_proj.bias")):
                p.zero_()
            elif name.endswith("A_log"):
                p.copy_(a_log.expand(p.shape[0], -1))
            elif name.endswith("out_proj.weight"):
                nn.init.normal_(p, 0.0, out_std, generator=gen)
            else:
                nn.init.normal_(p, 0.0, std, generator=gen)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        """Without ``labels``: logits ``[b, l, vocab]`` in the model dtype
        (tied embedding head). With them: ``(loss, logits)``, the mean f32
        cross-entropy of position t against label t + 1."""
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x)
        x = self.norm_f(x)
        head = self.embed_tokens.weight
        if labels is None:
            return F.linear(x, head)
        return causal_lm_loss(x, head, labels, fused_loss=False)
