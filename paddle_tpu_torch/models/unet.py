"""The SDXL-style diffusion UNet as ``torch.nn`` modules: the counterpart of
``paddle_tpu/models/unet.py``, with the JAX model's parameter names and
shapes (linear weights in PyTorch's ``[out, in]``, conv weights in Paddle's
``[out, in, kh, kw]``).

ResNet blocks with time conditioning (GroupNorm, SiLU, 3 x 3 convs),
transformer blocks over the flattened spatial tokens (self-attention, then
cross-attention to the text context, then a GELU MLP), strided-conv
downsampling and nearest-neighbour upsampling with skip connections. Every
attention goes through the port's ``flash_attention(causal=False)``: the
hand-written kernels on the card (sdxl-small's level 1 at head dim 32 on the
head-dim kernels, level 2 and the middle at 64 on the 64 / 128 ones; the
cross-attention at 77 text tokens), the plain version on the CPU. The
convolutions are ``F.conv2d`` (``nn/conv.py``), the linears ``nn.Linear``:
as the JAX model leaves both to XLA, they are no kernel of the port.

Every parameter is in the config's dtype, as ``astype(dtype)`` leaves the
JAX model; the timestep embedding is computed in f32 and cast to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..nn.conv import Conv2D
from ..nn.functional import GroupNorm, LayerNorm, gelu, interpolate, silu
from ..nn.transformer import init_linear_
from ..ops.fused.flash_attention import flash_attention

__all__ = ["UNetConfig", "UNet2DConditionModel", "UNET_PRESETS",
           "timestep_embedding", "ResnetBlock", "CrossAttnBlock",
           "SpatialTransformer", "Downsample", "Upsample"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 32               # latent H = W
    block_out_channels: tuple = (128, 256, 512)
    layers_per_block: int = 2
    attn_levels: tuple = (1, 2)         # levels with transformer blocks
    transformer_layers: int = 1
    num_attention_heads: int = 8
    cross_attention_dim: int = 512      # text-encoder hidden size
    norm_num_groups: int = 32
    dtype: str = "float32"


UNET_PRESETS = {
    # SDXL proportions, scaled down one notch (SDXL: 320/640/1280, tf 1/2/10)
    "sdxl-small": UNetConfig(block_out_channels=(192, 384, 768),
                             transformer_layers=2, num_attention_heads=12,
                             cross_attention_dim=768),
    "unet-tiny": UNetConfig(block_out_channels=(32, 64), attn_levels=(1,),
                            layers_per_block=1, num_attention_heads=4,
                            cross_attention_dim=64, norm_num_groups=8),
}


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (DDPM convention) ``[b, dim]`` in f32:
    ``cos`` then ``sin`` of ``t * exp(-ln(max_period) i / half)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _linear(cin, cout, gen, bias=True, **dd):
    mod = nn.Linear(cin, cout, bias=bias, **dd)
    init_linear_(mod, gen)
    return mod


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, groups, gen, **dd):
        super().__init__()
        self.norm1 = GroupNorm(min(groups, cin), cin, **dd)
        self.conv1 = Conv2D(cin, cout, 3, padding=1, generator=gen, **dd)
        self.time_emb_proj = _linear(temb_dim, cout, gen, **dd)
        self.norm2 = GroupNorm(min(groups, cout), cout, **dd)
        self.conv2 = Conv2D(cout, cout, 3, padding=1, generator=gen, **dd)
        self.shortcut = (Conv2D(cin, cout, 1, generator=gen, **dd)
                         if cin != cout else None)

    def forward(self, x, temb):
        h = self.conv1(silu(self.norm1(x)))
        h = h + self.time_emb_proj(silu(temb)).reshape(x.shape[0], -1, 1, 1)
        h = self.conv2(silu(self.norm2(h)))
        return h + (self.shortcut(x) if self.shortcut is not None else x)


class CrossAttnBlock(nn.Module):
    """Transformer block over spatial tokens: self-attention, cross-attention
    to the text context, GELU MLP (the SDXL Transformer2DModel block)."""

    def __init__(self, channels, heads, ctx_dim, gen, **dd):
        super().__init__()
        self.heads = heads
        self.head_dim = channels // heads
        self.norm1 = LayerNorm(channels, **dd)
        self.to_q1 = _linear(channels, channels, gen, bias=False, **dd)
        self.to_k1 = _linear(channels, channels, gen, bias=False, **dd)
        self.to_v1 = _linear(channels, channels, gen, bias=False, **dd)
        self.to_out1 = _linear(channels, channels, gen, **dd)
        self.norm2 = LayerNorm(channels, **dd)
        self.to_q2 = _linear(channels, channels, gen, bias=False, **dd)
        self.to_k2 = _linear(ctx_dim, channels, gen, bias=False, **dd)
        self.to_v2 = _linear(ctx_dim, channels, gen, bias=False, **dd)
        self.to_out2 = _linear(channels, channels, gen, **dd)
        self.norm3 = LayerNorm(channels, **dd)
        self.ff1 = _linear(channels, channels * 4, gen, **dd)
        self.ff2 = _linear(channels * 4, channels, gen, **dd)

    def _attend(self, q, k, v):
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        out = flash_attention(q.reshape(b, sq, self.heads, self.head_dim),
                              k.reshape(b, sk, self.heads, self.head_dim),
                              v.reshape(b, sk, self.heads, self.head_dim),
                              causal=False)
        return out.reshape(b, sq, self.heads * self.head_dim)

    def forward(self, x, context):
        h = self.norm1(x)
        x = x + self.to_out1(self._attend(self.to_q1(h), self.to_k1(h),
                                          self.to_v1(h)))
        h = self.norm2(x)
        x = x + self.to_out2(self._attend(self.to_q2(h), self.to_k2(context),
                                          self.to_v2(context)))
        h = self.norm3(x)
        return x + self.ff2(gelu(self.ff1(h)))


class SpatialTransformer(nn.Module):
    def __init__(self, channels, heads, ctx_dim, depth, groups, gen, **dd):
        super().__init__()
        self.norm = GroupNorm(min(groups, channels), channels, **dd)
        self.proj_in = _linear(channels, channels, gen, **dd)
        self.blocks = nn.ModuleList([CrossAttnBlock(channels, heads, ctx_dim,
                                                    gen, **dd)
                                     for _ in range(depth)])
        self.proj_out = _linear(channels, channels, gen, **dd)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x).reshape(b, c, hh * ww).transpose(1, 2))
        for blk in self.blocks:
            h = blk(h, context)
        h = self.proj_out(h)
        return h.transpose(1, 2).reshape(b, c, hh, ww) + x


class Downsample(nn.Module):
    def __init__(self, channels, gen, **dd):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=1,
                           generator=gen, **dd)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels, gen, **dd):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, padding=1, generator=gen,
                           **dd)

    def forward(self, x):
        return self.conv(interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DConditionModel(nn.Module):
    """Scaled SDXL UNet: the predicted noise for (latents, t, text).

    ``forward(sample [b, C, H, W], timestep [b], encoder_hidden_states [b,
    T, ctx_dim]) -> [b, C, H, W]``. Weights are drawn on ``device`` (default
    ``cuda``) from a ``torch.Generator`` seeded with ``seed``, by the JAX
    layers' rules (convs Kaiming-uniform, linears Xavier-uniform, biases 0,
    norms 1 and 0).

    JAX's ``downsamplers`` holds ``None`` at the last level and
    ``upsamplers`` at the last up block (level 0), which
    ``nn.ModuleList`` cannot hold: there the port keeps an ``nn.Identity``,
    which has no parameters, so that the ``state_dict`` keys equal JAX's one
    for one; the forward takes the samplers by level, never through the
    placeholder."""

    def __init__(self, config: UNetConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        dd = {"device": dev, "dtype": to_torch_dtype(config.dtype)}
        gen = make_generator(seed, dev)
        ch = config.block_out_channels
        g = config.norm_num_groups
        temb_dim = ch[0] * 4
        self.time_proj_dim = ch[0]
        self.time_embedding = nn.ModuleList([
            _linear(ch[0], temb_dim, gen, **dd),
            _linear(temb_dim, temb_dim, gen, **dd)])
        self.conv_in = Conv2D(config.in_channels, ch[0], 3, padding=1,
                              generator=gen, **dd)

        def transformer(c):
            return SpatialTransformer(c, config.num_attention_heads,
                                      config.cross_attention_dim,
                                      config.transformer_layers, g, gen, **dd)

        self.down_blocks = nn.ModuleList()
        self.down_attns = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        cin = ch[0]
        for level, cout in enumerate(ch):
            resnets, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(config.layers_per_block):
                resnets.append(ResnetBlock(cin, cout, temb_dim, g, gen, **dd))
                cin = cout
                if level in config.attn_levels:
                    attns.append(transformer(cout))
            self.down_blocks.append(resnets)
            self.down_attns.append(attns)
            self.downsamplers.append(Downsample(cout, gen, **dd)
                                     if level < len(ch) - 1 else nn.Identity())

        self.mid_res1 = ResnetBlock(ch[-1], ch[-1], temb_dim, g, gen, **dd)
        self.mid_attn = transformer(ch[-1])
        self.mid_res2 = ResnetBlock(ch[-1], ch[-1], temb_dim, g, gen, **dd)

        # the skips' channels, in the order the down path pushes them
        skip_chs = [ch[0]]
        for level, cout in enumerate(ch):
            skip_chs += [cout] * config.layers_per_block
            if level < len(ch) - 1:
                skip_chs.append(cout)
        self.up_blocks = nn.ModuleList()
        self.up_attns = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        cin = ch[-1]
        for level in reversed(range(len(ch))):
            cout = ch[level]
            resnets, attns = nn.ModuleList(), nn.ModuleList()
            for _ in range(config.layers_per_block + 1):
                resnets.append(ResnetBlock(cin + skip_chs.pop(), cout,
                                           temb_dim, g, gen, **dd))
                cin = cout
                if level in config.attn_levels:
                    attns.append(transformer(cout))
            self.up_blocks.append(resnets)
            self.up_attns.append(attns)
            self.upsamplers.append(Upsample(cout, gen, **dd) if level > 0
                                   else nn.Identity())

        self.norm_out = GroupNorm(min(g, ch[0]), ch[0], **dd)
        self.conv_out = Conv2D(ch[0], config.out_channels, 3, padding=1,
                               generator=gen, **dd)

    def forward(self, sample, timestep, encoder_hidden_states):
        last = len(self.config.block_out_channels) - 1
        temb = timestep_embedding(timestep, self.time_proj_dim)
        temb = self.time_embedding[1](silu(self.time_embedding[0](
            temb.to(self.conv_in.weight.dtype))))

        h = self.conv_in(sample)
        skips = [h]
        for level, resnets in enumerate(self.down_blocks):
            attns = self.down_attns[level]
            for i, res in enumerate(resnets):
                h = res(h, temb)
                if len(attns):
                    h = attns[i](h, encoder_hidden_states)
                skips.append(h)
            if level < last:
                h = self.downsamplers[level](h)
                skips.append(h)

        h = self.mid_res1(h, temb)
        h = self.mid_attn(h, encoder_hidden_states)
        h = self.mid_res2(h, temb)

        for ui, resnets in enumerate(self.up_blocks):
            attns = self.up_attns[ui]
            for i, res in enumerate(resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(attns):
                    h = attns[i](h, encoder_hidden_states)
            if ui < last:
                h = self.upsamplers[ui](h)

        return self.conv_out(silu(self.norm_out(h)))
