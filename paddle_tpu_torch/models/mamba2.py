"""Mamba-2 (SSD) causal LM as ``torch.nn`` modules: the counterpart of
``paddle_tpu/models/mamba2.py``, with the JAX model's parameter names and
shapes (linear weights in PyTorch's ``[out, in]``).

One in_proj gives ``[z, x, B, C, dt]``; a causal depthwise conv runs over
``(x, B, C)``; the SSD recurrence (``ops/fused/ssd.py``: a scalar decay per
head, chunked into matrix products) runs on CUDA tensors through the
hand-written forward and backward kernels and on CPU tensors through their
plain version; the output is ``rms_norm(y * silu(z))`` then out_proj. Every
parameter is in the config's dtype, as ``astype(dtype)`` leaves the JAX
model: ``delta = softplus(dt + dt_bias)`` and ``A = -exp(A_log)`` are
computed in it too. The LM head is untied.
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
from ..nn.functional import RMSNorm, rms_norm
from ..ops.fused.ssd import ssd_chunked
from .llama import causal_lm_loss

__all__ = ["Mamba2Config", "Mamba2ForCausalLM", "Mamba2Block", "conv_proj",
           "gate_out"]


@dataclass
class Mamba2Config:
    vocab_size: int = 50277
    hidden_size: int = 768
    state_size: int = 64          # N per head
    conv_kernel: int = 4
    expand: int = 2               # inner width = expand * hidden
    head_dim: int = 64
    num_hidden_layers: int = 24
    ssd_chunk: int = 128          # the plain version's chunk
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: str = "float32"

    @property
    def inner_size(self) -> int:
        return self.expand * self.hidden_size

    @property
    def num_heads(self) -> int:
        if self.inner_size % self.head_dim:
            raise ValueError("inner_size must divide by head_dim")
        return self.inner_size // self.head_dim


class Mamba2Block(nn.Module):
    """in_proj -> causal depthwise conv over (x, B, C) -> silu -> SSD ->
    gated RMS norm -> out_proj."""

    def __init__(self, cfg: Mamba2Config, **dd):
        super().__init__()
        d_in, ds, H = cfg.inner_size, cfg.state_size, cfg.num_heads
        conv_dim = d_in + 2 * ds
        self.config = cfg
        self.in_proj = nn.Linear(cfg.hidden_size, 2 * d_in + 2 * ds + H,
                                 bias=False, **dd)
        self.conv_weight = nn.Parameter(torch.empty(conv_dim, 1,
                                                    cfg.conv_kernel, **dd))
        self.conv_bias = nn.Parameter(torch.zeros(conv_dim, **dd))
        self.dt_bias = nn.Parameter(torch.zeros(H, **dd))
        self.A_log = nn.Parameter(torch.empty(H, **dd))
        self.D = nn.Parameter(torch.ones(H, **dd))
        self.norm = RMSNorm(d_in, cfg.rms_norm_eps, **dd)
        self.out_proj = nn.Linear(d_in, cfg.hidden_size, bias=False, **dd)

    def forward(self, x):
        cfg = self.config
        z, xs, delta, A, Bm, Cm = conv_proj(
            x, self.in_proj.weight, self.conv_weight, self.conv_bias,
            self.dt_bias, self.A_log, cfg)
        y = ssd_chunked(xs, delta, A, Bm, Cm, self.D, cfg.ssd_chunk)
        return gate_out(y, z, self.norm.weight, self.out_proj.weight, cfg)


@amp_op("mamba2_conv_proj")
def conv_proj(x, in_proj_weight, conv_weight, conv_bias, dt_bias, A_log,
              cfg: Mamba2Config):
    """in_proj -> causal depthwise conv over (x, B, C) -> silu, ``delta =
    softplus(dt + dt_bias)`` and ``A = -exp(A_log)``: one op of JAX's
    block, so under ``auto_cast`` its inputs are cast together and nothing
    inside is. Returns ``z, x [b, l, H, dh], delta, A, B, C``."""
    b, l, _ = x.shape
    d_in, ds, H, k = (cfg.inner_size, cfg.state_size, cfg.num_heads,
                      cfg.conv_kernel)
    z, xbc, dt = F.linear(x, in_proj_weight).split([d_in, d_in + 2 * ds, H],
                                                   dim=-1)
    xpad = F.pad(xbc.transpose(1, 2), (k - 1, 0))            # [b, conv, l+k-1]
    xc = F.conv1d(xpad, conv_weight, groups=d_in + 2 * ds)
    # one copy to token-major [b, l, conv] before the bias and silu
    # (elementwise ops keep their input's stride order): x, B and C are
    # then views with one stride between tokens, read in place by the
    # kernels
    xc = F.silu(xc.transpose(1, 2).contiguous() + conv_bias)
    xs, Bm, Cm = xc.split([d_in, ds, ds], dim=-1)
    delta = F.softplus(dt + dt_bias)                          # [b, l, H]
    return (z, xs.unflatten(-1, (H, cfg.head_dim)), delta, -torch.exp(A_log),
            Bm, Cm)


@amp_op("mamba2_gate_out")
def gate_out(y, z, norm_weight, out_proj_weight, cfg: Mamba2Config):
    """``out_proj(rms_norm(y * silu(z)))``: one op of JAX's block."""
    b, l = z.shape[0], z.shape[1]
    y = y.reshape(b, l, cfg.inner_size) * F.silu(z)
    y = rms_norm(y, norm_weight, cfg.rms_norm_eps)
    return F.linear(y.to(z.dtype), out_proj_weight)


class _Mamba2Layer(nn.Module):
    def __init__(self, cfg: Mamba2Config, **dd):
        super().__init__()
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **dd)
        self.mixer = Mamba2Block(cfg, **dd)

    def forward(self, x):
        return x + self.mixer(self.norm(x))


class Mamba2ForCausalLM(nn.Module):
    """Weights are drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` seeded with ``seed``, by the JAX model's rules:
    normal(0, initializer_range) for the embedding, in_proj, conv and LM
    head weights, out_proj scaled by ``1 / sqrt(2 L)``, zero conv_bias and
    dt_bias, ``A_log = log(linspace(1, 16, H))``, ``D = 1``, norms 1."""

    def __init__(self, config: Mamba2Config, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        self.embeddings = nn.Embedding(config.vocab_size,
                                       config.hidden_size, **dd)
        self.layers = nn.ModuleList(
            [_Mamba2Layer(config, **dd)
             for _ in range(config.num_hidden_layers)])
        self.norm_f = RMSNorm(config.hidden_size, config.rms_norm_eps, **dd)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False, **dd)
        with torch.no_grad():
            self._init_weights(make_generator(seed, dev))

    def _init_weights(self, gen: torch.Generator):
        cfg = self.config
        std = cfg.initializer_range
        out_std = std / math.sqrt(2 * cfg.num_hidden_layers)
        a_log = torch.log(torch.linspace(1.0, 16.0, cfg.num_heads))
        for name, p in self.named_parameters():
            if name.endswith(("norm.weight", "norm_f.weight", ".D")):
                p.fill_(1.0)
            elif name.endswith(("conv_bias", "dt_bias")):
                p.zero_()
            elif name.endswith("A_log"):
                p.copy_(a_log)
            elif name.endswith("out_proj.weight"):
                nn.init.normal_(p, 0.0, out_std, generator=gen)
            else:
                nn.init.normal_(p, 0.0, std, generator=gen)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None):
        """Without ``labels``: logits ``[b, l, vocab]`` in the model dtype.
        With them: ``(loss, logits)``, the mean f32 cross-entropy of
        position t against label t + 1 (``-100`` ignored)."""
        x = self.embeddings(input_ids)
        for layer in self.layers:
            x = layer(x)
        x = self.norm_f(x)
        if labels is None:
            return self.lm_head(x)
        return causal_lm_loss(x, self.lm_head.weight, labels,
                              fused_loss=False)
