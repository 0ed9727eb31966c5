"""Pipeline-parallel model segmentation (the counterpart of
``paddle_tpu/parallel/pp_layers.py``: Paddle's ``LayerDesc``,
``SharedLayerDesc`` and ``PipelineLayer``).

``PipelineLayer`` owns the whole stack and the segmentation into stages;
run on its own, ``forward`` executes every layer in order, so a
PipelineLayer is always a correct one-device model. ``stage_sequential``
gives one stage's layers as an ``nn.Sequential``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence

from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A deferred layer constructor: ``(cls, args, kwargs)``, so that the
    segmentation can count the layers before they are built."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not (isinstance(layer_func, type)
                and issubclass(layer_func, nn.Module)):
            raise TypeError("The input of LayerDesc must be Layer subclass")
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self) -> nn.Module:
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages (tied input / output embeddings): every
    desc with the same ``key`` resolves to one instance; ``forward_func``
    adapts the call at a reuse site."""

    def __init__(self, key, layer_func, forward_func=None, *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func


class _SharedCall(nn.Module):
    def __init__(self, shared: nn.Module, forward_func: Optional[Callable]):
        super().__init__()
        self.shared = shared
        self._forward_func = forward_func

    def forward(self, *args, **kwargs):
        if self._forward_func is not None:
            return self._forward_func(self.shared, *args, **kwargs)
        return self.shared(*args, **kwargs)


class PipelineLayer(nn.Module):
    """A sequential model cut into ``num_stages`` stages.

    ``layers``: ``nn.Module`` / ``LayerDesc`` / ``SharedLayerDesc`` / plain
    callables, run in order, each on the previous output. ``seg_method``:
    ``"uniform"`` (the layer count balanced over the stages),
    ``"layer:<Name>"`` (boundaries only before layers whose class name
    matches the regex ``<Name>``, the matching layers spread evenly) or an
    explicit list of ``num_stages + 1`` boundaries from 0 to the layer
    count. ``recompute_interval`` > 0 recomputes every that-many-th module
    in the backward (in training)."""

    def __init__(self, layers: Sequence, num_stages: int = 1,
                 loss_fn: Optional[Callable] = None,
                 seg_method: Any = "uniform",
                 recompute_interval: int = 0):
        super().__init__()
        self._num_stages = int(num_stages)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._descs = list(layers)
        shared: Dict[str, nn.Module] = {}
        built: List[Any] = []
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in shared:
                    shared[d.layer_name] = d.build_layer()
                built.append(_SharedCall(shared[d.layer_name],
                                         d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            else:
                built.append(d)
        self._shared = shared
        self.run_function: List[Any] = built
        for i, layer in enumerate(built):
            if isinstance(layer, nn.Module):
                self.add_module(str(i), layer)
        for k, layer in shared.items():
            self.add_module(f"shared_{k}", layer)
        self.segment_parts = self._segment(seg_method)

    def _segment(self, method) -> List[int]:
        n, s = len(self.run_function), self._num_stages
        if isinstance(method, (list, tuple)):
            parts = list(method)
            if len(parts) != s + 1 or parts[0] != 0 or parts[-1] != n:
                raise ValueError(f"explicit boundaries must be {s + 1} "
                                 f"indices from 0 to {n}: got {parts}")
            return parts
        if isinstance(method, str) and method.startswith("layer:"):
            pat = method[len("layer:"):]
            cut_ok = [i for i, layer in enumerate(self.run_function)
                      if re.match(pat, type(layer).__name__)]
            if len(cut_ok) < s:
                raise ValueError(f"only {len(cut_ok)} layers match {pat!r}; "
                                 f"need >= {s} for {s} stages")
            parts, taken = [0], 0
            per, extra = divmod(len(cut_ok), s)
            for st in range(s - 1):
                taken += per + (1 if st < extra else 0)
                parts.append(cut_ok[taken] if taken < len(cut_ok) else n)
            return parts + [n]
        parts = [0]
        per, extra = divmod(n, s)
        for st in range(s):
            parts.append(parts[-1] + per + (1 if st < extra else 0))
        return parts

    @property
    def num_stages(self) -> int:
        return self._num_stages

    def stage_of_layer(self, idx: int) -> int:
        for st in range(self._num_stages):
            if self.segment_parts[st] <= idx < self.segment_parts[st + 1]:
                return st
        raise IndexError(idx)

    def get_stage_layers(self, stage: int) -> List[Any]:
        lo, hi = self.segment_parts[stage], self.segment_parts[stage + 1]
        return self.run_function[lo:hi]

    def stage_sequential(self, stage: int) -> nn.Sequential:
        return nn.Sequential(*[layer for layer in self.get_stage_layers(stage)
                               if isinstance(layer, nn.Module)])

    def forward(self, x, *args, **kwargs):
        from ..framework.recompute import recompute

        for i, fn in enumerate(self.run_function):
            rc = (self._recompute_interval > 0 and self.training
                  and i % self._recompute_interval == 0
                  and isinstance(fn, nn.Module))
            x = recompute(fn, x) if rc else fn(x)
        return x

    def loss(self, out, *labels):
        if self._loss_fn is None:
            return out
        return self._loss_fn(out, *labels)
