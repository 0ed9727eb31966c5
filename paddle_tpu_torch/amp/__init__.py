"""``paddle.amp`` for the port (the counterpart of ``paddle_tpu/amp``):
``auto_cast`` / ``autocast``, ``decorate``, ``GradScaler`` / ``AmpScaler``.

Where the cast happens. The JAX package casts at its op dispatcher, by op
name (``maybe_autocast_inputs``): under O1 the float32 inputs of a
white-listed op become the low-precision dtype; under O2 every op's do,
except that a black-listed op gets its low-precision inputs back in
float32. Only dispatched ops are cast, never the raw array code inside
their bodies. The port has no dispatcher, so it casts at two seams, by the
same op names and the same rule (:func:`cast_inputs`):

* a ``torch.overrides.TorchFunctionMode``, active inside ``auto_cast``,
  that maps the torch callables the port's modules call onto JAX's op
  names (``F.linear`` is ``linear``, ``torch.matmul`` and ``@`` are
  ``matmul``, ``F.embedding`` is ``embedding``, ``+`` is ``add``, a view
  is ``reshape``, indexing is ``getitem``, ...; :data:`TORCH_OPS`);
  callables it does not map are left alone;
* :func:`amp_op`, the decorator of the port's functions that stand for
  one JAX op (``rms_norm``, ``swiglu``, ``apply_rope``,
  ``flash_attention``, ``fused_linear_cross_entropy``, ``cross_entropy``,
  the losses, ``gelu``, and the bodies JAX's state-space and MoE models
  dispatch whole: ``mamba_conv_proj``, ``selective_scan``,
  ``mamba2_conv_proj``, ``ssd_chunked``, ``mamba2_gate_out``,
  ``token_shift``, ``rwkv_log_decay``, ``rwkv_linear_attention``,
  ``moe_layer``): it casts their inputs (tensors in lists, tuples and
  dicts) by name and runs their bodies with the mode off, so the port does
  not cast operations the JAX package never sees. :func:`nested_ops` turns
  the mode on again inside a body for what JAX dispatches nested in it.
  ``amp.debugging`` sees the same ops by the same names: a second mode for
  :data:`TORCH_OPS`, and hooks run after each ``amp_op``.

What the JAX package runs as raw array code outside any op (an
optimizer's update, a clip object, the scaler's unscale) the port runs
under :func:`uncast`, whatever ``auto_cast`` is around it: a step under
O2 keeps its float32 arithmetic, as JAX's does.

Each cast is a ``.to(dtype)`` in the autograd graph, so a float32 leaf gets
a float32 gradient.

``GradScaler`` unscales each gradient IN PLACE in the gradient's own
dtype: ``g = (g.float() * (1 / scale)).to(g.dtype)``. The JAX package
replaces each gradient with a float32 one; PyTorch refuses a float32
``.grad`` on a bf16 parameter. For float32 gradients the two are the same;
for bf16 or f16 ones the port's is JAX's rounded once to the gradient's
dtype, which is exact when the scale is a power of two (the default scale
and ratios keep it one). Its found-inf flag stays on the device from
``unscale_`` through ``step`` (the optimizer skips on the device, the fused
AdamW kernel reads it itself); ``update()`` reads it on the host, once a
step.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from ..core.dtype import to_torch_dtype

__all__ = [
    "auto_cast", "autocast", "GradScaler", "AmpScaler", "decorate",
    "amp_state", "amp_op", "nested_ops", "uncast", "cast_inputs", "settings",
    "under",
    "WHITE_LIST", "BLACK_LIST", "TORCH_OPS",
]

# the JAX package's op-name lists, as they are: white = compute in low
# precision, black = keep float32
WHITE_LIST = {
    "matmul", "bmm", "mm", "mv", "einsum", "linear", "conv1d", "conv2d",
    "conv3d", "conv2d_transpose", "flash_attention", "flash_attn_reference",
    "bilinear", "addmm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp", "cross_entropy",
    "softmax", "log_softmax", "layer_norm", "rms_norm", "batch_norm",
    "group_norm", "instance_norm", "sum", "mean", "softmax_with_cross_entropy",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "mse_loss", "l1_loss", "kl_div", "norm", "dist", "cumsum", "pow",
    "square", "sqrt", "rsqrt", "erf", "erfinv",
}


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()
        self.in_op = False  # inside an amp_op body: nothing more is cast
        # callables (op_name, outputs) run after each amp_op, with torch
        # functions disabled (amp.debugging's checker and stats)
        self.op_hooks = []


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def _cast_dtype(op_name: str):
    """``(from, to)`` for ``op_name`` under the current state, or None."""
    if not _state.enabled or _state.in_op:
        return None
    if _state.level == "O2":
        if op_name in BLACK_LIST or op_name in _state.custom_black:
            return _state.dtype, torch.float32
        return torch.float32, _state.dtype
    white = (WHITE_LIST | _state.custom_white) - _state.custom_black
    return (torch.float32, _state.dtype) if op_name in white else None


def _cast_tree(x, src, dst):
    if isinstance(x, torch.Tensor):
        return x.to(dst) if x.dtype == src else x
    if isinstance(x, (list, tuple)):
        return type(x)(_cast_tree(v, src, dst) for v in x)
    if isinstance(x, dict):
        return {k: _cast_tree(v, src, dst) for k, v in x.items()}
    return x


def cast_inputs(op_name: str, args, kwargs):
    """``(args, kwargs)`` with their tensors cast as the JAX dispatcher
    casts the inputs of op ``op_name`` (``maybe_autocast_inputs``)."""
    rule = _cast_dtype(op_name)
    if rule is None:
        return args, kwargs
    src, dst = rule
    return (_cast_tree(tuple(args), src, dst),
            {k: _cast_tree(v, src, dst) for k, v in kwargs.items()})


def amp_op(op_name: str):
    """Mark a function as the port's counterpart of JAX op ``op_name``: under
    ``auto_cast`` its tensor inputs are cast by that name, and its body runs
    with the autocast mode off (no nested casts)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _state.in_op or not (_state.enabled or _state.op_hooks):
                return fn(*args, **kwargs)
            args, kwargs = cast_inputs(op_name, args, kwargs)
            _state.in_op = True
            try:
                with torch._C.DisableTorchFunction():
                    out = fn(*args, **kwargs)
                    for hook in list(_state.op_hooks):
                        hook(op_name, out)
                    return out
            finally:
                _state.in_op = False
        inner.amp_op_name = op_name
        return inner
    return wrap


@contextlib.contextmanager
def nested_ops():
    """Inside an :func:`amp_op` body, run a region whose ops JAX dispatches
    on their own (the modules of a list of experts inside ``moe_layer``)
    with the autocast mode on again; elsewhere a no-op."""
    if not _state.in_op:
        yield
        return
    _state.in_op = False
    try:
        with torch._C._EnableTorchFunction():
            yield
    finally:
        _state.in_op = True


@contextlib.contextmanager
def uncast():
    """Run a region as the JAX package runs raw array code, which its
    dispatcher never sees (an optimizer's update, a clip, the scaler's
    unscale): no cast, no :func:`amp_op` hook, and torch's function modes
    off, their Python call on each torch op too. Also a decorator. A
    closure it calls back into runs under :func:`nested_ops`."""
    was = _state.in_op
    _state.in_op = True
    try:
        with torch._C.DisableTorchFunction():
            yield
    finally:
        _state.in_op = was


def _torch_ops():
    """``{torch callable: JAX op name}`` for the callables the port's
    modules call outside :func:`amp_op` bodies."""
    T, B = torch.Tensor, torch._C.TensorBase

    def methods(*names):
        out = []
        for n in names:
            out += [getattr(c, n) for c in (T, B) if hasattr(c, n)]
        return out

    table = {
        "linear": [F.linear], "bilinear": [F.bilinear],
        "matmul": [torch.matmul] + methods("matmul", "__matmul__",
                                           "__rmatmul__"),
        "bmm": [torch.bmm] + methods("bmm"), "mm": [torch.mm] + methods("mm"),
        "mv": [torch.mv] + methods("mv"), "einsum": [torch.einsum],
        "addmm": [torch.addmm] + methods("addmm"),
        "conv1d": [F.conv1d], "conv2d": [F.conv2d], "conv3d": [F.conv3d],
        "conv2d_transpose": [F.conv_transpose2d],
        "embedding": [F.embedding],
        "add": [torch.add] + methods("add", "__add__", "__radd__"),
        "subtract": [torch.sub] + methods("sub", "__sub__", "__rsub__"),
        "multiply": [torch.mul] + methods("mul", "__mul__", "__rmul__"),
        "divide": [torch.div] + methods("div", "__truediv__",
                                        "__rtruediv__"),
        "reshape": [torch.reshape] + methods("reshape", "view"),
        "getitem": methods("__getitem__"),
        "exp": [torch.exp] + methods("exp"),
        "log": [torch.log] + methods("log"),
        "log2": [torch.log2] + methods("log2"),
        "log10": [torch.log10] + methods("log10"),
        "log1p": [torch.log1p] + methods("log1p"),
        "logsumexp": [torch.logsumexp] + methods("logsumexp"),
        "cross_entropy": [F.cross_entropy],
        "softmax": [F.softmax, torch.softmax] + methods("softmax"),
        "log_softmax": [F.log_softmax, torch.log_softmax]
        + methods("log_softmax"),
        "layer_norm": [F.layer_norm], "batch_norm": [F.batch_norm],
        "group_norm": [F.group_norm], "instance_norm": [F.instance_norm],
        "sum": [torch.sum] + methods("sum"),
        "mean": [torch.mean] + methods("mean"),
        "nll_loss": [F.nll_loss],
        "binary_cross_entropy": [F.binary_cross_entropy],
        "binary_cross_entropy_with_logits": [
            F.binary_cross_entropy_with_logits],
        "mse_loss": [F.mse_loss], "l1_loss": [F.l1_loss],
        "kl_div": [F.kl_div],
        "norm": [torch.norm, torch.linalg.norm] + methods("norm"),
        "dist": [torch.dist] + methods("dist"),
        "cumsum": [torch.cumsum] + methods("cumsum"),
        "pow": [torch.pow] + methods("pow", "__pow__"),
        "square": [torch.square] + methods("square"),
        "sqrt": [torch.sqrt] + methods("sqrt"),
        "rsqrt": [torch.rsqrt] + methods("rsqrt"),
        "erf": [torch.erf] + methods("erf"),
        "erfinv": [torch.erfinv] + methods("erfinv"),
    }
    return {fn: name for name, fns in table.items() for fn in fns}


#: torch callable -> JAX op name, for the autocast mode
TORCH_OPS = _torch_ops()


class _AutocastMode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = TORCH_OPS.get(func)
        if name is not None:
            args, kwargs = cast_inputs(name, args, kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def auto_cast(enable: bool = True,
              custom_white_list: Optional[Sequence[str]] = None,
              custom_black_list: Optional[Sequence[str]] = None,
              level: str = "O1", dtype: str = "bfloat16",
              use_promote: bool = True):
    """``paddle.amp.auto_cast``: O1 casts the white-listed ops' float32
    inputs to ``dtype``; O2 casts every op's, and gives black-listed ops
    float32 inputs."""
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = to_torch_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    mode = _AutocastMode() if _state.enabled else contextlib.nullcontext()
    try:
        with mode:
            yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


autocast = auto_cast


def settings():
    """The ``auto_cast`` arguments in force, or None outside it."""
    if not _state.enabled:
        return None
    return dict(custom_white_list=sorted(_state.custom_white),
                custom_black_list=sorted(_state.custom_black),
                level=_state.level, dtype=_state.dtype)


def under(saved, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the ``auto_cast`` settings ``saved``
    (from :func:`settings`), entered unless they are in force: what
    activation recomputation needs, since it runs a region again in the
    backward, outside the forward's ``auto_cast``."""
    if saved is None or settings() == saved:
        return fn(*args, **kwargs)
    with auto_cast(**saved):
        return fn(*args, **kwargs)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None):
    """``paddle.amp.decorate``: O2 casts each model's floating parameters
    and buffers to ``dtype`` (``Module.to``: the parameter objects stay, so
    optimizers built over them keep them) and, unless ``master_weight`` is
    False, turns on each optimizer's f32 master weights
    (``_multi_precision``)."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(to_torch_dtype(dtype))
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        if master_weight is not False:
            o._multi_precision = True
    if single and opt_single:
        return models, optimizers
    return model_list, opt_list


class GradScaler:
    """Dynamic loss scaling (``paddle_tpu/amp/__init__.py`` ``GradScaler``):
    ``scale(loss)``, ``unscale_(opt)`` (once a step, however often it is
    called), ``step(opt)`` (unscale, then the optimizer's step skipped on
    the device when a gradient is not finite), ``update()`` (the scale
    times ``decr_ratio`` after ``decr_every_n_nan_or_inf`` bad steps, never
    below 1, times ``incr_ratio`` after ``incr_every_n_steps`` good ones),
    ``minimize``, ``state_dict`` / ``load_state_dict``."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        # the last unscale_'s flag: an int32 scalar on the device, or None
        self._found_inf = None
        self._unscaled: set = set()

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    @uncast()
    def unscale_(self, optimizer) -> None:
        """Divide every gradient of ``optimizer``'s parameters by the scale,
        in place in its dtype, and set the found-inf flag (on the device)
        if any is not finite. A second call before ``step`` does nothing."""
        if not self._enable or id(optimizer) in self._unscaled:
            return
        inv = 1.0 / self._scale
        bad = torch.zeros((), dtype=torch.bool, device=optimizer.device)
        for p in optimizer._parameter_list:
            g = p.grad
            if g is None:
                continue
            if g.dtype == torch.float32:
                g.mul_(inv)
            else:
                g.copy_(g.float() * inv)
            bad |= ~torch.isfinite(g).all()
        self._found_inf = bad.to(torch.int32)
        self._unscaled.add(id(optimizer))

    @uncast()
    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        optimizer._found_inf = self._found_inf
        try:
            optimizer.step()
        finally:
            optimizer._found_inf = None
            self._unscaled.discard(id(optimizer))

    def update(self) -> None:
        if not self._enable or not self._dynamic:
            return
        # the scaler's one host sync a step
        if self._found_inf is not None and bool(self._found_inf):
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v: float) -> None:
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, sd) -> None:
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


AmpScaler = GradScaler
