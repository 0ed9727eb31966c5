"""``paddle.save`` / ``paddle.load`` for the port (the counterpart of
``paddle_tpu/framework/io.py``): nested dicts, lists and tuples of tensors
(and anything else pickle takes), pickled with the JAX package's header
``{"magic": "paddle_tpu_ckpt_v1", "data": ...}``.

The port's format. Each tensor is a :class:`_TensorRecord`: its values as
a numpy array on the host, a dtype tag, whether it is a parameter, its
``stop_gradient`` (the inverse of ``requires_grad``) and its name. NumPy has
no bfloat16, so a bf16 payload is its raw 16 bits (``uint16``) under the tag
``"bfloat16"``: writing and reading need nothing beyond numpy and torch.

Files the JAX package wrote. Its tensors are pickled
``paddle_tpu.framework.io._TensorProxy`` objects, bf16 payloads as
``ml_dtypes.bfloat16`` arrays. :func:`load` unpickles them without
importing ``paddle_tpu`` or ``ml_dtypes``: ``find_class`` maps the proxy
onto :class:`_JaxTensorProxy` (its attributes as they are) and the bf16
dtype onto NumPy's 2-byte void type, whose bytes are then read as bf16.

Loaded tensors are on the CPU (a parameter as ``torch.nn.Parameter``);
``load_state_dict`` and the optimizers' ``set_state_dict`` copy them onto
the device of what they load into.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]

_MAGIC = "paddle_tpu_ckpt_v1"


class _TensorRecord:
    """A tensor as the port pickles it."""

    def __init__(self, payload: np.ndarray, dtype: str, is_param: bool,
                 stop_gradient: bool, name):
        self.payload = payload
        self.dtype = dtype
        self.is_param = is_param
        self.stop_gradient = stop_gradient
        self.name = name


class _JaxTensorProxy:
    """A ``paddle_tpu.framework.io._TensorProxy`` from a JAX-written file:
    pickle restores ``array``, ``is_param``, ``stop_gradient`` and
    ``name`` into it."""


def _record(t: torch.Tensor) -> _TensorRecord:
    host = t.detach().cpu().contiguous()
    if host.dtype == torch.bfloat16:
        payload = host.view(torch.int16).numpy().view(np.uint16).copy()
        tag = "bfloat16"
    else:
        payload, tag = host.numpy().copy(), str(host.dtype).split(".")[-1]
    return _TensorRecord(payload, tag, isinstance(t, torch.nn.Parameter),
                         not t.requires_grad, getattr(t, "name", None))


def _tensor(payload: np.ndarray, bf16: bool, is_param: bool,
            stop_gradient: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(payload, order="C"))
    if bf16:
        t = t.view(torch.bfloat16)
    if is_param:
        return torch.nn.Parameter(t, requires_grad=not stop_gradient)
    if not stop_gradient and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _bf16_bits(a: np.ndarray) -> bool:
    # a JAX bf16 array read through the void-type stand-in
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 \
        and a.dtype.names is None


def _encode(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return _record(obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_encode(v) for v in obj)
    return obj


def _decode(obj: Any, return_numpy: bool) -> Any:
    if isinstance(obj, _TensorRecord):
        bf16 = obj.dtype == "bfloat16"
        if return_numpy:
            return _bf16_to_f32(obj.payload) if bf16 else obj.payload
        return _tensor(obj.payload, bf16, obj.is_param, obj.stop_gradient)
    if isinstance(obj, _JaxTensorProxy):
        a = np.asarray(obj.array)
        bf16 = _bf16_bits(a)
        if bf16:
            a = a.view(np.uint16)
        if return_numpy:
            return _bf16_to_f32(a) if bf16 else a
        return _tensor(a, bf16, obj.is_param, obj.stop_gradient)
    if isinstance(obj, np.ndarray) and _bf16_bits(obj):
        return torch.from_numpy(obj.view(np.uint16).copy()).view(
            torch.bfloat16)
    if isinstance(obj, dict):
        return {k: _decode(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_decode(v, return_numpy) for v in obj)
    return obj


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits as float32 values, exactly (numpy has no bfloat16)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("paddle_tpu.framework.io", "_TensorProxy"):
            return _JaxTensorProxy
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return np.void
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = 4) -> None:
    """Pickle ``obj`` (tensors at any depth of dicts, lists and tuples) to
    ``path``, creating its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = {"magic": _MAGIC, "data": _encode(obj)}
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)


def load(path: str, return_numpy: bool = False) -> Any:
    """What :func:`save`, or the JAX package's ``save``, wrote to ``path``:
    tensors as CPU tensors (parameters as ``nn.Parameter``), or with
    ``return_numpy`` as numpy arrays (bf16 ones widened to float32, which
    is exact). Unpickling runs code named in the file: load only files this
    program or the JAX package wrote."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if isinstance(payload, dict) and payload.get("magic") == _MAGIC:
        return _decode(payload["data"], return_numpy)
    return _decode(payload, return_numpy)
