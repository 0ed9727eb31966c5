"""``Conv2D`` with Paddle's signature and weight layout, the counterpart of
``paddle_tpu/nn/conv.py:60``: weight ``[out_channels, in_channels, kh,
kw]`` and bias ``[out_channels]`` (none with ``bias_attr=False``), drawn
from an explicit ``torch.Generator`` by the JAX layer's rule (Kaiming-uniform
weight with bound ``sqrt(6 / fan_in)``, zero bias). The body is one
``F.conv2d`` (cuDNN on the card), as the JAX layer leaves the convolution to
``lax.conv_general_dilated``: no kernel of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(nn.Module):
    """NCHW 2-D convolution (no dilation or groups: no caller of the port
    uses them). ``generator`` draws the weight (a fresh unseeded draw
    without it); ``bias_attr=False`` drops the bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, bias_attr=None, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = _pair(stride), _pair(padding)
        dd = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, *_pair(kernel_size), **dd))
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(out_channels, **dd)))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        limit = math.sqrt(6.0 / self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
