"""LR schedulers (the counterpart of ``paddle_tpu/optimizer/lr.py``).

Pure Python over ``math``, kept as the port's own copy: the same 18
schedulers with the same names, state dicts and ``step(epoch)``
semantics (``ReduceOnPlateau.step(metrics)`` included), so one schedule
gives both packages the same learning rate at every step. An optimizer
given an :class:`LRScheduler` reads ``scheduler()`` at each step; the
training loop calls ``scheduler.step()``."""

from __future__ import annotations

import math
from typing import Optional

__all__ = [
    "LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
    "InverseTimeDecay", "PolynomialDecay", "LinearWarmup", "ExponentialDecay",
    "MultiStepDecay", "StepDecay", "LambdaDecay", "ReduceOnPlateau",
    "CosineAnnealingDecay", "CosineAnnealingWarmRestarts", "MultiplicativeDecay",
    "OneCycleLR", "CyclicLR", "LinearLR", "CosineWarmup",
]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None) -> None:
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        return {
            k: v
            for k, v in self.__dict__.items()
            if isinstance(v, (int, float, bool, str, list, tuple)) or v is None
        }

    def set_state_dict(self, sd) -> None:
        self.__dict__.update(sd)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (
            self.base_lr
            * self.d_model ** -0.5
            * min(step ** -0.5, step * self.warmup_steps ** -1.5)
        )


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        ds = self.decay_steps
        if self.cycle:
            div = math.ceil(step / ds) if step > 0 else 1
            ds = ds * div
        else:
            step = min(step, ds)
        return (self.base_lr - self.end_lr) * (1 - step / ds) ** self.power + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.target = learning_rate if not self.lr_sched else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * self.last_epoch / self.warmup_steps
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.target

    def state_dict(self):
        sd = super().state_dict()
        if self.lr_sched is not None:
            sd["lr_sched"] = self.lr_sched.state_dict()
        return sd

    def set_state_dict(self, sd):
        inner = sd.pop("lr_sched", None)
        super().set_state_dict(sd)
        if inner and self.lr_sched is not None:
            self.lr_sched.set_state_dict(inner)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (
            self.eta_min
            + (self.base_lr - self.eta_min)
            * (1 + math.cos(math.pi * min(self.last_epoch, self.T_max) / self.T_max))
            / 2
        )


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0.0, last_epoch=-1, verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = max(self.last_epoch, 0)
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / t_i)) / 2


class CosineWarmup(LRScheduler):
    """Linear warmup then cosine decay to ``min_lr`` — the standard LLM
    pretraining schedule (not a distinct class in the reference, where configs
    compose LinearWarmup+Cosine; provided fused here for convenience)."""

    def __init__(self, learning_rate, warmup_steps, total_steps, min_lr=0.0,
                 last_epoch=-1, verbose=False):
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.min_lr = min_lr
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        s = self.last_epoch
        if s < self.warmup_steps:
            return self.base_lr * s / max(self.warmup_steps, 1)
        prog = (s - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1)
        prog = min(prog, 1.0)
        return self.min_lr + (self.base_lr - self.min_lr) * 0.5 * (1 + math.cos(math.pi * prog))


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            self.last_lr = self._lr
            return
        current = float(metrics.item() if hasattr(metrics, "item") else metrics)
        if self.best is None or self._is_better(current):
            self.best = current
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            new_lr = max(self._lr * self.factor, self.min_lr)
            if self._lr - new_lr > self.epsilon:
                self._lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_lr = self._lr

    def _is_better(self, cur):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return cur < self.best * (1 - self.threshold)
            return cur < self.best - self.threshold
        if self.threshold_mode == "rel":
            return cur > self.best * (1 + self.threshold)
        return cur > self.best + self.threshold


class LinearLR(LRScheduler):
    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        prog = min(self.last_epoch / self.total_steps, 1.0)
        f = self.start_factor + (self.end_factor - self.start_factor) * prog
        return self.base_lr * f


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, anneal_strategy="cos",
                 three_phase=False, last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        up = int(self.phase_pct * self.total_steps) - 1
        s = self.last_epoch
        if s <= up:
            return self._anneal(self.initial_lr, self.max_lr, s / max(up, 1))
        down = self.total_steps - up - 1
        return self._anneal(self.max_lr, self.end_lr, min((s - up) / max(down, 1), 1.0))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1, verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_up + self.step_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        scale = x / self.step_up if x <= self.step_up else (total - x) / self.step_down
        amp = (self.max_lr - self.base_lr) * scale
        if self.mode == "triangular2":
            amp = amp / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp
