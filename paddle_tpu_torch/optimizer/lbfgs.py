"""L-BFGS (the counterpart of ``paddle_tpu/optimizer/lbfgs.py``).

Closure-driven quasi-Newton over one flat f32 vector of the trainable
parameters: ``step(closure)`` re-evaluates the loss (the closure runs the
forward and ``backward``) as the line search probes points, keeps the last
``history_size`` curvature pairs ``(s, y)`` and takes the two-loop
recursion's direction. ``line_search_fn="strong_wolfe"`` backtracks on
Armijo and checks the curvature condition; ``None`` takes fixed steps of
the learning rate. Without a closure, one quasi-Newton step from the
current ``.grad``s. The vector math runs on the device; the line search's
control flow reads scalars on the host, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..amp import nested_ops, uncast
from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _as_caller(closure):
    """``closure`` run with the caller's ``auto_cast`` on again inside the
    step's :func:`~paddle_tpu_torch.amp.uncast` region."""
    def run():
        with nested_ops():
            return closure()
    return run


def _f(x) -> float:
    """A loss (a tensor that may require grad, or a number) as a float."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


class LBFGS(Optimizer):
    def __init__(self, learning_rate=1.0, max_iter: int = 20,
                 tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9, history_size: int = 100,
                 line_search_fn: Optional[str] = None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         device=device)
        self.max_iter = int(max_iter)
        self.tolerance_grad = float(tolerance_grad)
        self.tolerance_change = float(tolerance_change)
        self.history_size = int(history_size)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._rho: List[torch.Tensor] = []
        self._prev_flat_grad = None
        self._prev_step_vec = None
        self._prev_loss = None

    # -- flat-vector helpers ---------------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _gather_flat(self, attr="grad") -> torch.Tensor:
        vals = []
        for p in self._params():
            t = p if attr == "data" else p.grad
            t = torch.zeros_like(p) if t is None else t
            vals.append(t.detach().float().reshape(-1))
        return torch.cat(vals)

    @torch.no_grad()
    def _distribute_flat(self, flat: torch.Tensor) -> None:
        off = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[off:off + n].view(p.shape))
            off += n

    # -- two-loop recursion ----------------------------------------------------
    def _direction(self, flat_grad):
        q = -flat_grad
        if not self._s:
            return q
        alphas = []
        for s, y, rho in zip(reversed(self._s), reversed(self._y),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append(a)
        y_last, s_last = self._y[-1], self._s[-1]
        gamma = torch.dot(s_last, y_last) / torch.clamp_min(
            torch.dot(y_last, y_last), 1e-20)
        q = q * gamma
        for (s, y, rho), a in zip(zip(self._s, self._y, self._rho),
                                  reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return q

    def _push_pair(self, s, y):
        ys = torch.dot(s, y)
        if float(ys) > 1e-10:
            self._s.append(s)
            self._y.append(y)
            self._rho.append(1.0 / ys)
            if len(self._s) > self.history_size:
                self._s.pop(0)
                self._y.pop(0)
                self._rho.pop(0)

    # -- line search -----------------------------------------------------------
    def _strong_wolfe(self, closure, x0, loss0, grad0, direction, t0,
                      c1=1e-4, c2=0.9, max_ls=20):
        dg0 = float(torch.dot(grad0, direction))
        if dg0 >= 0:  # not a descent direction: reset
            return loss0, grad0, 0.0
        t = t0
        for _ in range(max_ls):
            self._distribute_flat(x0 + t * direction)
            loss = _f(closure())
            grad = self._gather_flat()
            dg = float(torch.dot(grad, direction))
            if loss > _f(loss0) + c1 * t * dg0:
                t *= 0.5          # Armijo fails: shrink
            elif abs(dg) > c2 * abs(dg0):
                t *= 2.0 if dg < 0 else 0.5  # curvature fails
            else:
                return loss, grad, t
        return loss, grad, t

    # -- step ------------------------------------------------------------------
    @uncast()
    def step(self, closure: Optional[Callable] = None):
        """One L-BFGS step. With a ``closure`` (which re-evaluates the loss
        and the gradients), up to ``max_iter`` inner iterations; returns the
        last loss. Without one, a single quasi-Newton step from the current
        ``.grad``s; returns None. Its own arithmetic casts nothing under
        ``auto_cast``; the closure runs under the caller's."""
        if closure is not None:
            closure = _as_caller(closure)
        if closure is None:
            flat_grad = self._gather_flat()
            # the previous displacement with the gradient change it caused,
            # pushed before this step's direction
            if self._prev_flat_grad is not None \
                    and self._prev_step_vec is not None:
                self._push_pair(self._prev_step_vec,
                                flat_grad - self._prev_flat_grad)
            x = self._gather_flat("data")
            d = self._direction(flat_grad)
            t = float(self.get_lr())
            self._distribute_flat(x + t * d)
            self._prev_step_vec = t * d
            self._prev_flat_grad = flat_grad
            return None

        loss = closure()
        flat_grad = self._gather_flat()
        for _ in range(self.max_iter):
            if float(torch.max(torch.abs(flat_grad))) <= self.tolerance_grad:
                break
            x = self._gather_flat("data")
            d = self._direction(flat_grad)
            if self._s:
                t = float(self.get_lr())
            else:
                t = min(1.0, 1.0 / max(float(torch.sum(torch.abs(flat_grad))),
                                       1e-12)) * float(self.get_lr())
            if self.line_search_fn == "strong_wolfe":
                new_loss, new_grad, t = self._strong_wolfe(
                    closure, x, loss, flat_grad, d, t)
            else:
                self._distribute_flat(x + t * d)
                new_loss = closure()
                new_grad = self._gather_flat()
            self._push_pair(t * d, new_grad - flat_grad)
            if abs(_f(new_loss) - _f(loss)) < self.tolerance_change:
                loss, flat_grad = new_loss, new_grad
                break
            loss, flat_grad = new_loss, new_grad
        self._prev_flat_grad = flat_grad
        self._prev_loss = loss
        return loss
