"""Optimizer base (the counterpart of ``paddle_tpu/optimizer/optimizer.py``).

The paddle surface (``step()`` reading each parameter's ``.grad``,
``clear_grad()``, ``get_lr()``/``set_lr()``, ``state_dict()``/
``set_state_dict()``) drives a functional core: each optimizer defines
``_init_state(param)`` and ``_update(param, grad, state, lr, step,
master)``, which returns ``(new_param, new_state, new_master)``. PyTorch
runs it eagerly, one parameter at a time.

``step()`` applies the ``grad_clip`` object first, then the update. The
learning rate is a float or an :class:`~.lr.LRScheduler` (read at each
step). ``multi_precision=True`` keeps an f32 master copy of each bf16 or
f16 parameter: the update reads and writes the master and the parameter
gets its cast. A ``GradScaler`` hands the step its found-inf flag
(``_found_inf``, a tensor on the device): when it is set the old
parameter, state and master are kept by a select on the device, with no
host sync.

:meth:`Optimizer.apply_gradients` (pure) and
:meth:`Optimizer.apply_gradients_` (in place; what ``jit.TrainStep``
calls) keep the JAX ``apply_gradients_tree`` contract: no clip object and
no master.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..amp import uncast
from ..core.device import entry_device
from ..core.dtype import as_tensor
from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Sequence[torch.Tensor]] = None,
                 weight_decay=None, grad_clip=None,
                 name: Optional[str] = None, multi_precision: bool = False,
                 device=None):
        if parameters is None:
            raise ValueError("parameters must be given")
        if not isinstance(learning_rate, LRScheduler) and (
                isinstance(learning_rate, bool)
                or not isinstance(learning_rate, (int, float))):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate).__name__}")
        self._parameter_list = list(parameters)
        if not self._parameter_list:
            raise ValueError("parameters is empty")
        self.device = entry_device(self._parameter_list[0].device, device,
                                   type(self).__name__)
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._weight_decay = 0.0 if weight_decay is None \
            else float(weight_decay)
        self._multi_precision = bool(multi_precision)
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._masters: Dict[int, torch.Tensor] = {}
        self._step_count = 0
        self._found_inf = None  # set by GradScaler.step for one step

    # -- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _lr_tensor(self, lr=None) -> torch.Tensor:
        return torch.tensor(self.get_lr() if lr is None else float(lr),
                            dtype=torch.float32, device=self.device)

    # -- state -----------------------------------------------------------------
    def _needs_master(self, p: torch.Tensor) -> bool:
        return self._multi_precision and p.dtype in _LOW_PRECISION

    def _ensure_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._init_state(p)
            self._accumulators[id(p)] = st
            if self._needs_master(p):
                self._masters[id(p)] = p.detach().float().clone()
        return st

    # -- to be implemented by subclasses ---------------------------------------
    def _init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, param, grad, state, lr, step, master):
        """Return ``(new_param, new_state, new_master)``; ``lr`` is an f32
        scalar tensor, ``step`` the 1-based step number, ``master`` the f32
        master of ``param`` or None (then ``new_master`` is None)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no per-parameter update")

    # -- eager surface ---------------------------------------------------------
    def _trainable(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list
                if p.requires_grad and getattr(p, "trainable", True)]

    @uncast()
    def step(self) -> None:
        """Update every trainable parameter that has a ``.grad``: the clip
        object first, then the update (skipped on the device when a
        ``GradScaler`` found an inf). Nothing in it is cast under
        ``auto_cast`` (:func:`~paddle_tpu_torch.amp.uncast`)."""
        params_grads = [(p, p.grad) for p in self._trainable()
                        if p.grad is not None]
        if not params_grads:
            return
        if self._grad_clip is not None:
            with torch.no_grad():
                params_grads = self._grad_clip(params_grads)
        self._apply(params_grads)
        self._step_count += 1

    def _skip_flag(self) -> Optional[torch.Tensor]:
        """The found-inf flag as a bool scalar on the device, or None."""
        fi = self._found_inf
        if fi is None:
            return None
        if not isinstance(fi, torch.Tensor):
            fi = torch.tensor(bool(fi))
        return fi.to(device=self.device, dtype=torch.bool).reshape(())

    @torch.no_grad()
    def _apply(self, params_grads) -> None:
        lr = self._lr_tensor()
        step = self._step_count + 1
        skip = self._skip_flag()
        for p, g in params_grads:
            state = self._ensure_state(p)
            master = self._masters.get(id(p))
            new_p, new_s, new_m = self._update(p, g, state, lr, step, master)
            if skip is not None:
                new_p = torch.where(skip, p, new_p)
                new_s = {k: torch.where(skip, state[k], v)
                         for k, v in new_s.items()}
                if new_m is not None:
                    new_m = torch.where(skip, master, new_m)
            self._accumulators[id(p)] = new_s
            if new_m is not None:
                self._masters[id(p)] = new_m
            p.copy_(new_p)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- checkpoints -----------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """JAX's keys: ``_step_count``, ``p{i}.<state>`` and ``p{i}.master``
        by the parameter's index in ``parameters``, and ``LR_Scheduler``
        (the scheduler's own state dict). The tensors are the optimizer's
        (an update replaces them; it does not write into them)."""
        sd: Dict[str, Any] = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            st = self._accumulators.get(id(p))
            if st is None:
                continue
            for k, v in st.items():
                sd[f"p{i}.{k}"] = v
            m = self._masters.get(id(p))
            if m is not None:
                sd[f"p{i}.master"] = m
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, sd: Dict[str, Any]) -> None:
        """Load :meth:`state_dict`'s keys; values may be tensors or numpy
        arrays (JAX's, through ``models/convert.py``) and are copied onto
        each parameter's device."""
        self._step_count = int(sd.get("_step_count", 0))
        for i, p in enumerate(self._parameter_list):
            prefix, st = f"p{i}.", {}
            for k, v in sd.items():
                if not k.startswith(prefix):
                    continue
                t = as_tensor(v).to(p.device).clone()
                if k[len(prefix):] == "master":
                    self._masters[id(p)] = t
                else:
                    st[k[len(prefix):]] = t
            if st:
                self._accumulators[id(p)] = st
        if "LR_Scheduler" in sd \
                and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(dict(sd["LR_Scheduler"]))

    @property
    def _param_groups(self):
        return self._parameter_list

    # -- functional core -------------------------------------------------------
    def init_state(self, params: Sequence[torch.Tensor]
                   ) -> List[Dict[str, torch.Tensor]]:
        """Fresh optimizer state for each of ``params``."""
        return [self._init_state(p) for p in params]

    @torch.no_grad()
    @uncast()
    def apply_gradients(self, params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor],
                        state: Sequence[Dict[str, Any]], lr=None,
                        step: int = 0):
        """Pure: ``(new_params, new_state)`` for lists of parameters,
        gradients and states; nothing passed in is modified. ``lr`` defaults
        to :meth:`get_lr`. No clip object, no master."""
        lr = self._lr_tensor(lr)
        new_params, new_state = [], []
        for p, g, s in zip(params, grads, state):
            np_, ns, _ = self._update(p, g, s, lr, int(step), None)
            new_params.append(np_)
            new_state.append(ns)
        return new_params, new_state

    @torch.no_grad()
    @uncast()
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
        lr = self._lr_tensor(lr)
        for i, p in enumerate(params):
            new, state[i], _ = self._update(p, grads[i], state[i], lr,
                                            int(step), None)
            grads[i] = None
            p.copy_(new)
            del new
