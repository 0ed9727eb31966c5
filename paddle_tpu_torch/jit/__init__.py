"""The whole training step (the counterpart of ``paddle_tpu.jit.TrainStep``).

PyTorch runs eagerly, so there is no compile: one call runs the forward and
backward, clips by global norm, and applies the optimizer's update one
parameter at a time, writing each new parameter and state back at once and
dropping its gradient (``Optimizer.apply_gradients_``): the counterpart of
the JAX step's buffer donation, without which a second copy of the
parameters and moments would be alive at the update (at 6.7 B parameters
that does not fit on an 80 GB card).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.device import entry_device

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer, clip_norm=None)``;
    ``loss = step(*batch)`` updates ``model``'s trainable parameters in
    place and returns the loss (detached).

    With ``loss_fn=None`` the model computes its own loss (the first output
    when it returns a tuple); else ``loss_fn(model(*batch), *batch)``.
    ``clip_norm`` scales the gradients by ``clip / max(global_norm, clip)``
    (f32 sum of squares, each gradient cast back to its dtype) before the
    update, as ``paddle_tpu/jit/__init__.py:167-173`` does. The optimizer's
    state lives here, as in the JAX ``TrainStep``; its step number counts
    this object's calls. Runs on the model's device; an explicit ``device``
    must match it (``cuda`` without a card raises)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Optional[Callable],
                 optimizer, clip_norm: Optional[float] = None, device=None):
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._clip_norm = clip_norm
        self._params = [p for p in model.parameters() if p.requires_grad]
        if not self._params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self.device = entry_device(self._params[0].device, device,
                                   "TrainStep")
        self._state = optimizer.init_state(self._params)
        self._step = 0

    def _loss(self, batch):
        out = self._model(*batch)
        if self._loss_fn is None:
            return out[0] if isinstance(out, (tuple, list)) else out
        return self._loss_fn(out, *batch)

    def __call__(self, *batch) -> torch.Tensor:
        self._step += 1
        loss = self._loss(batch)
        grads = list(torch.autograd.grad(loss, self._params,
                                         allow_unused=True,
                                         materialize_grads=True))
        with torch.no_grad():
            if self._clip_norm is not None:
                clip = float(self._clip_norm)
                gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                    for g in grads))
                scale = clip / torch.clamp_min(gn, clip)
                for g in grads:   # fresh tensors of this step: scale in place
                    g.copy_(g.float() * scale)
            self._opt.apply_gradients_(self._params, grads, self._state,
                                       self._opt.get_lr(), self._step)
        return loss.detach()
