"""Load a ``paddle_tpu`` model's ``state_dict`` into the port's module."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_paddle_tpu_state"]

# buffers the JAX model lists in its state_dict that the port recomputes
_DERIVED = ("model.rope_cos", "model.rope_sin")


def _linear_weights(model: torch.nn.Module) -> set:
    """Names of the weights of the model's ``torch.nn.Linear`` modules."""
    return {f"{name}.weight" if name else "weight"
            for name, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear)}


def load_paddle_tpu_state(model: torch.nn.Module,
                          state: Mapping[str, np.ndarray]) -> None:
    """Copy ``state`` (the JAX model's ``state_dict()`` as numpy arrays,
    same names) into ``model`` in place. The weights of the port's
    ``torch.nn.Linear`` modules are ``[in, out]`` in JAX and are transposed
    into PyTorch's ``[out, in]``; everything else (embeddings, norms, the
    depthwise conv's ``[d, 1, k]``, experts' stacks) keeps its layout.
    Missing, unexpected or mis-shaped entries raise."""
    params = dict(model.named_parameters())
    unexpected = set(state) - set(params) - set(_DERIVED)
    missing = set(params) - set(state)
    if unexpected or missing:
        raise KeyError(f"load_paddle_tpu_state: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    linear = _linear_weights(model)
    with torch.no_grad():
        for name, p in params.items():
            value = torch.tensor(np.asarray(state[name]))
            if name in linear:
                value = value.t()
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"load_paddle_tpu_state: {name} has shape "
                                 f"{tuple(value.shape)}, the port expects "
                                 f"{tuple(p.shape)}")
            p.copy_(value.to(dtype=p.dtype, device=p.device))
