"""Fused flat-buffer AdamW (the counterpart of
``paddle_tpu/optimizer/fused.py``).

All participating parameters are carried as ONE flat f32 master buffer with
moments beside it and a ``(param, offset, size)`` view per parameter.
``step()`` concatenates the gradients into one flat f32 buffer, makes ONE
launch of the fused AdamW kernel (``ops/cuda/fused_adamw.py``; its plain
version on CPU tensors), which updates the flat master and moments IN
PLACE, then copies each view back into its parameter in the parameter's
dtype. The flat buffer is the f32 master of every parameter, whatever its
dtype. A ``GradScaler``'s found-inf flag reaches the kernel on the device:
a step with an inf writes nothing (JAX keeps the old buffers with a select
after its kernel, ``paddle_tpu/optimizer/fused.py:88-94``).

``state_dict()`` holds ``_step_count`` and, once a step has run, the flat
buffers ``flat``, ``m`` and ``v`` (the optimizer's own tensors, updated in
place by the next step: copy them to keep them), the JAX keys.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.dtype import as_tensor
from ..ops.cuda.fused_adamw import fused_adamw
from .optimizer import Optimizer

__all__ = ["FusedAdamW"]


class FusedAdamW(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._views = None  # [(param, offset, size)]
        self._flat = self._m = self._v = None

    def _write_back(self) -> None:
        for p, off, n in self._views:
            p.copy_(self._flat[off:off + n].view(p.shape))

    def _build_flat(self, params: List[torch.Tensor]) -> None:
        views, off = [], 0
        for p in params:
            views.append((p, off, p.numel()))
            off += p.numel()
        f32 = dict(dtype=torch.float32, device=self.device)
        self._views = views
        self._flat = torch.empty(off, **f32)
        for p, o, n in views:
            self._flat[o:o + n].copy_(p.detach().reshape(-1))
        self._m = torch.zeros(off, **f32)
        self._v = torch.zeros(off, **f32)

    def _rebuild_if_needed(self, params: List[torch.Tensor]) -> None:
        """Rebuild the flat views when the set of participating parameters
        changes (by identity, not just count), carrying each surviving
        parameter's moments so a mid-training freeze keeps its Adam
        state."""
        if self._views is not None and \
                [id(p) for p, _, _ in self._views] == [id(p) for p in params]:
            return
        carried = {}
        if self._views is not None:
            for p, off, n in self._views:
                carried[id(p)] = (self._m[off:off + n].clone(),
                                  self._v[off:off + n].clone())
        self._build_flat(params)
        for p, off, n in self._views:
            old = carried.get(id(p))
            if old is not None:
                self._m[off:off + n].copy_(old[0])
                self._v[off:off + n].copy_(old[1])

    @torch.no_grad()
    def _apply(self, params_grads) -> None:
        self._rebuild_if_needed([p for p, _ in params_grads])
        grads = torch.empty_like(self._flat)
        for (_, g), (_, off, n) in zip(params_grads, self._views):
            grads[off:off + n].copy_(g.reshape(-1))
        found_inf = self._skip_flag()
        fused_adamw(self._flat, grads, self._m, self._v, self.get_lr(),
                    self._beta1, self._beta2, self._epsilon,
                    self._weight_decay, self._step_count + 1,
                    found_inf=found_inf)
        del grads
        self._write_back()

    # -- checkpoints: the state lives in the flat buffers ----------------------
    def state_dict(self):
        sd = {"_step_count": self._step_count}
        if self._flat is not None:
            sd.update(flat=self._flat, m=self._m, v=self._v)
        return sd

    @torch.no_grad()
    def set_state_dict(self, state) -> None:
        """Load :meth:`state_dict`'s keys (tensors or numpy arrays): the
        flat buffers are laid out over the trainable parameters again and
        each parameter gets its view."""
        self._step_count = int(state.get("_step_count", 0))
        if "flat" not in state:
            return
        self._build_flat(self._trainable())
        for name in ("flat", "m", "v"):
            getattr(self, "_" + name).copy_(as_tensor(state[name]).reshape(-1))
        self._write_back()
