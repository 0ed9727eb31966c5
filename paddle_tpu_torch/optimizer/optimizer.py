"""Optimizer base (the counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The paddle surface (``step()`` reading each parameter's ``.grad``,
``clear_grad()``, ``get_lr()``/``set_lr()``) drives a functional core: each
optimizer defines ``_init_state(param)`` and ``_update(param, grad, state,
lr, step)``, and :meth:`Optimizer.apply_gradients` maps it over lists of
tensors (pure), :meth:`Optimizer.apply_gradients_` in place, which is what
``jit.TrainStep`` calls. PyTorch runs it eagerly, one parameter at a
time.

A float learning rate only: an ``LRScheduler``, ``grad_clip=`` objects and
``multi_precision=True`` (f32 master weights) are not ported yet (ROADMAP
A5) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.device import entry_device

__all__ = ["Optimizer"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A5)")


class Optimizer:
    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Sequence[torch.Tensor]] = None,
                 weight_decay=None, grad_clip=None,
                 name: Optional[str] = None, multi_precision: bool = False,
                 device=None):
        if parameters is None:
            raise ValueError("parameters must be given")
        if isinstance(learning_rate, bool) \
                or not isinstance(learning_rate, (int, float)):
            raise _not_ported(f"learning_rate {type(learning_rate).__name__}"
                              f" (LR schedulers)")
        if grad_clip is not None:
            raise _not_ported("grad_clip")
        if multi_precision:
            raise _not_ported("multi_precision=True")
        self._parameter_list = list(parameters)
        if not self._parameter_list:
            raise ValueError("parameters is empty")
        self.device = entry_device(self._parameter_list[0].device, device,
                                   type(self).__name__)
        self._learning_rate = float(learning_rate)
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        self._learning_rate = float(value)

    # -- to be implemented by subclasses ---------------------------------------
    def _init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, param, grad, state, lr, step
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Return ``(new_param, new_state)``; ``lr`` is an f32 scalar
        tensor, ``step`` the 1-based step number."""
        raise NotImplementedError(
            f"{type(self).__name__} has no per-parameter update")

    # -- eager surface ---------------------------------------------------------
    def step(self) -> None:
        """Update every parameter that requires grad and has a ``.grad``."""
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if not params_grads:
            return
        self._apply(params_grads)
        self._step_count += 1

    @torch.no_grad()
    def _apply(self, params_grads) -> None:
        lr = torch.tensor(self.get_lr(), dtype=torch.float32,
                          device=self.device)
        for p, g in params_grads:
            state = self._accumulators.get(id(p))
            if state is None:
                state = self._init_state(p)
            new_p, self._accumulators[id(p)] = self._update(
                p, g, state, lr, self._step_count + 1)
            p.copy_(new_p)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- functional core -------------------------------------------------------
    def init_state(self, params: Sequence[torch.Tensor]
                   ) -> List[Dict[str, torch.Tensor]]:
        """Fresh optimizer state for each of ``params``."""
        return [self._init_state(p) for p in params]

    @torch.no_grad()
    def apply_gradients(self, params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        state: Sequence[Dict[str, Any]], lr=None,
                        step: int = 0):
        """Pure: ``(new_params, new_state)`` for lists of parameters,
        gradients and states; nothing passed in is modified. ``lr`` defaults
        to :meth:`get_lr`."""
        lr = torch.tensor(self.get_lr() if lr is None else float(lr),
                          dtype=torch.float32, device=self.device)
        new_params, new_state = [], []
        for p, g, s in zip(params, grads, state):
            np_, ns = self._update(p, g, s, lr, int(step))
            new_params.append(np_)
            new_state.append(ns)
        return new_params, new_state

    @torch.no_grad()
    def apply_gradients_(self, params: Sequence[torch.Tensor],
                         grads: List[Optional[torch.Tensor]],
                         state: List[Dict[str, Any]], lr=None,
                         step: int = 0) -> None:
        """In place, one parameter at a time: each parameter is updated
        with the arithmetic of :meth:`apply_gradients` and written back at
        once, its entry of ``state`` replaced, and its entry of ``grads``
        set to None, so that only one parameter's new value and state are
        alive beside the old ones (the counterpart of the JAX
        ``TrainStep``'s buffer donation)."""
        lr = torch.tensor(self.get_lr() if lr is None else float(lr),
                          dtype=torch.float32, device=self.device)
        for i, p in enumerate(params):
            new, state[i] = self._update(p, grads[i], state[i], lr, int(step))
            grads[i] = None
            p.copy_(new)
            del new
