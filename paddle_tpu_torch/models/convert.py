"""Load a ``paddle_tpu`` Llama's ``state_dict`` into the port's module."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_paddle_tpu_state"]

# buffers the JAX model lists in its state_dict that the port recomputes
_DERIVED = ("model.rope_cos", "model.rope_sin")


def _is_linear(name: str) -> bool:
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def load_paddle_tpu_state(model: torch.nn.Module,
                          state: Mapping[str, np.ndarray]) -> None:
    """Copy ``state`` (the JAX ``LlamaForCausalLM.state_dict()`` as numpy
    arrays, same names) into ``model`` in place. JAX linear weights are
    ``[in, out]`` and are transposed into ``torch.nn.Linear``'s
    ``[out, in]``. Missing, unexpected or mis-shaped entries raise."""
    params = dict(model.named_parameters())
    unexpected = set(state) - set(params) - set(_DERIVED)
    missing = set(params) - set(state)
    if unexpected or missing:
        raise KeyError(f"load_paddle_tpu_state: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    with torch.no_grad():
        for name, p in params.items():
            value = torch.tensor(np.asarray(state[name]))
            if _is_linear(name):
                value = value.t()
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"load_paddle_tpu_state: {name} has shape "
                                 f"{tuple(value.shape)}, the port expects "
                                 f"{tuple(p.shape)}")
            p.copy_(value.to(dtype=p.dtype, device=p.device))
