"""AMP debugging for the port (the counterpart of
``paddle_tpu/amp/debugging.py``): operator statistics, the NaN / Inf tensor
checker with its debug modes, ``check_numerics`` and the comparison of two
statistics dumps.

Where ops are seen. The JAX package hooks its op dispatcher
(``ops/registry.py:111-118``, ``:140-146``, ``:176-177``, ``:207-208``).
The port has the seam its AMP has: the torch callables of
``amp.TORCH_OPS``, seen by a ``TorchFunctionMode`` that stacks with
``auto_cast``'s, and the functions marked ``amp.amp_op`` (``rms_norm``,
``layer_norm``, ``flash_attention``, ``gelu``, the losses, ...), seen by a
hook after their bodies. Both report JAX's op names (``linear``,
``conv2d``, ``matmul``, ``add``, ...). An op the JAX package dispatches
that the port runs as a torch call outside that table (``concat``,
``transpose``, ``silu``, ...) is not seen, so statistics agree with JAX's
for the ops both packages name alike.

Cost. Each checked op's outputs are reduced on the device and read on the
host: one synchronisation per op, as the JAX checker's ``device_get``.
That is a debugging tool's cost; with nothing enabled the seams cost
nothing beyond ``auto_cast``'s own.

Enable and disable in the same nesting as any ``auto_cast`` around them:
the mode joins torch's stack of modes when enabled and leaves it when both
the checker and the statistics are off.
"""

from __future__ import annotations

import contextlib
import enum
import json
import os
from typing import Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

from . import TORCH_OPS, amp_state

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "check_numerics", "save_stats", "compare_accuracy"]


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    """What the tensor checker checks: ``checked_op_list`` (only these ops)
    and ``skipped_op_list`` (not these), ``debug_step = (start, end)``, a
    window of op counts (1-based, inclusive) outside which nothing is
    checked, ``debug_mode`` (abort on the first NaN / Inf, or report and
    continue) and ``output_dir`` (each finding appended to
    ``tensor_checker.log`` there)."""

    def __init__(self, enable: bool,
                 debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = tuple(debug_step) if debug_step else None
        self.stack_height_limit = stack_height_limit
        self._dispatch_count = 0


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _Debugger:
    """The enabled checker config and statistics table, and the mode that
    feeds them."""

    def __init__(self):
        self.checker: Optional[TensorCheckerConfig] = None
        self.stats: Optional[Dict[str, Dict]] = None
        self.mode: Optional[_DebugMode] = None

    def active(self) -> bool:
        return self.checker is not None or self.stats is not None

    def set(self, **fields) -> None:
        """Set ``checker`` / ``stats``, then :meth:`sync`; the old values
        stay if that raises."""
        old = self.checker, self.stats
        for k, v in fields.items():
            setattr(self, k, v)
        try:
            self.sync()
        except RuntimeError:
            self.checker, self.stats = old
            raise

    def sync(self) -> None:
        """Join or leave torch's mode stack and the amp_op hooks as the
        checker and statistics require. Leaving pops torch's top mode, so
        it raises unless that is this one: the checker and statistics must
        be turned off in the ``auto_cast`` nesting they were turned on in."""
        hooks = amp_state().op_hooks
        if self.active() and self.mode is None:
            self.mode = _DebugMode()
            self.mode.__enter__()
            hooks.append(self.observe)
        elif not self.active() and self.mode is not None:
            stack = torch.overrides._get_current_function_mode_stack()
            if not stack or stack[-1] is not self.mode:
                raise RuntimeError(
                    "amp.debugging: the checker or statistics are turned off "
                    "in another auto_cast nesting than they were turned on "
                    "in (the debug mode is not on top of torch's mode "
                    "stack); turn them off where they were turned on")
            hooks.remove(self.observe)
            self.mode.__exit__(None, None, None)
            self.mode = None

    def observe(self, name: str, out) -> None:
        """Called with torch functions disabled after op ``name``."""
        if self.checker is not None:
            self._check(name, out)
        if self.stats is not None:
            self._count(name, out)

    def _check(self, name, out):
        cfg = self.checker
        cfg._dispatch_count += 1
        if cfg.debug_step is not None:
            lo, hi = cfg.debug_step
            if not lo <= cfg._dispatch_count <= hi:
                return
        if cfg.checked_op_list and name not in cfg.checked_op_list:
            return
        if cfg.skipped_op_list and name in cfg.skipped_op_list:
            return
        bad = any(isinstance(o, torch.Tensor) and o.is_floating_point()
                  and not bool(torch.isfinite(o).all())
                  for o in _outputs(out))
        if not bad:
            return
        msg = (f"Operator {name} output contains NaN or Inf "
               f"(FLAGS_check_nan_inf)")
        if cfg.output_dir:
            os.makedirs(cfg.output_dir, exist_ok=True)
            with open(os.path.join(cfg.output_dir, "tensor_checker.log"),
                      "a") as f:
                f.write(f"{name}: {msg}\n")
        if cfg.debug_mode != DebugMode.CHECK_NAN_INF_AND_ABORT:
            print(f"[tensor_checker] op {name!r} produced NaN/Inf "
                  f"(mode={cfg.debug_mode.name}: continuing)")
            return
        raise FloatingPointError(msg)

    def _count(self, name, out):
        row = self.stats.setdefault(name, {"op": name, "calls": 0, "nan": 0,
                                           "inf": 0, "dtypes": {}})
        row["calls"] += 1
        for o in _outputs(out):
            if not isinstance(o, torch.Tensor):
                continue
            dt = _dtype_name(o.dtype)
            row["dtypes"][dt] = row["dtypes"].get(dt, 0) + 1
            if o.is_floating_point():
                row["nan"] += int(torch.isnan(o).sum())
                row["inf"] += int(torch.isinf(o).sum())


_debugger = _Debugger()


class _DebugMode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = TORCH_OPS.get(func)
        if name is not None:
            with torch._C.DisableTorchFunction():
                _debugger.observe(name, out)
        return out


def enable_tensor_checker(config: TensorCheckerConfig):
    """Check every op's floating outputs for NaN / Inf as ``config`` says
    (``FLAGS_check_nan_inf``)."""
    _debugger.set(checker=config if config.enable else None)


def disable_tensor_checker():
    _debugger.set(checker=None)


def enable_operator_stats_collection():
    """Count each op's calls, output dtypes and NaN / Inf values."""
    _debugger.set(stats={})


def disable_operator_stats_collection(print_table: bool = True):
    """Stop collecting; print the table unless ``print_table`` is False
    and return it: ``{op: {"op", "calls", "nan", "inf", "dtypes"}}``."""
    result = _debugger.stats or {}
    _debugger.set(stats=None)
    if print_table and result:
        print(f"{'Op':<32}{'Calls':>8}{'NaN':>8}{'Inf':>8}  Dtypes")
        for name in sorted(result):
            r = result[name]
            print(f"{name:<32}{r['calls']:>8}{r['nan']:>8}{r['inf']:>8}  "
                  f"{r['dtypes']}")
    return result


@contextlib.contextmanager
def collect_operator_stats():
    """``enable_operator_stats_collection`` for the block, then
    ``disable_operator_stats_collection``."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT):
    """``(num_nan, num_inf, num_zero)`` of ``tensor`` as 0-d int64 tensors
    on its device; raises ``FloatingPointError`` on NaN / Inf when the mode
    aborts."""
    t = torch.as_tensor(tensor)
    with torch._C.DisableTorchFunction():
        if t.is_floating_point():
            num_nan, num_inf = torch.isnan(t).sum(), torch.isinf(t).sum()
        else:
            num_nan = num_inf = torch.zeros((), dtype=torch.int64,
                                            device=t.device)
        num_zero = (t == 0).sum()
        if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT and (
                int(num_nan) or int(num_inf)):
            raise FloatingPointError(
                f"[check_numerics] {op_type}:{var_name} has {int(num_nan)} "
                f"NaN, {int(num_inf)} Inf")
    return num_nan, num_inf, num_zero


def save_stats(stats: Dict, path: str):
    with open(path, "w") as f:
        json.dump(stats, f)


def compare_accuracy(dump_path: str, another_dump_path: str,
                     output_filename: str, loss_scale: float = 1.0,
                     dump_all_tensors: bool = False):
    """Compare two statistics dumps (``save_stats``; say an f32 run and an
    AMP run) and write the ops whose NaN / Inf counts differ to
    ``output_filename``; returns those rows."""
    with open(dump_path) as f:
        a = json.load(f)
    with open(another_dump_path) as f:
        b = json.load(f)
    rows = []
    empty = {"calls": 0, "nan": 0, "inf": 0}
    for op in sorted(set(a) | set(b)):
        ra, rb = a.get(op, empty), b.get(op, empty)
        if (ra["nan"], ra["inf"]) != (rb["nan"], rb["inf"]):
            rows.append({"op": op,
                         "run1": {"nan": ra["nan"], "inf": ra["inf"]},
                         "run2": {"nan": rb["nan"], "inf": rb["inf"]}})
    with open(output_filename, "w") as f:
        json.dump({"mismatched_ops": rows}, f, indent=2)
    return rows
