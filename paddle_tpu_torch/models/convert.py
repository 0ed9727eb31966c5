"""Load a ``paddle_tpu`` model's ``state_dict`` into the port's module, and
a ``paddle_tpu`` optimizer's ``state_dict`` into the port's optimizer."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.dtype import as_tensor

__all__ = ["load_paddle_tpu_state", "load_paddle_tpu_optimizer_state"]

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
            value = as_tensor(state[name])
            if name in linear:
                value = value.t()
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"load_paddle_tpu_state: {name} has shape "
                                 f"{tuple(value.shape)}, the port expects "
                                 f"{tuple(p.shape)}")
            p.copy_(value.to(dtype=p.dtype, device=p.device))


def load_paddle_tpu_optimizer_state(optimizer, model: torch.nn.Module,
                                    state: Mapping, names) -> None:
    """Load a JAX optimizer's ``state_dict()`` (numpy arrays; keys
    ``_step_count``, ``p{i}.<state>``, ``p{i}.master`` and
    ``LR_Scheduler``) into the port's ``optimizer`` over ``model``.

    ``names[i]`` is the name of the JAX optimizer's parameter ``i`` (the
    JAX model's ``named_parameters()`` in the order its optimizer was given
    them); each entry goes to the port's parameter of that name, under the
    index it has in ``optimizer``'s parameters. The per-element state of a
    ``torch.nn.Linear`` weight (moments, ``moment2_max``, velocities, the
    master: every 2-D entry) is transposed from JAX's ``[in, out]``, as
    :func:`load_paddle_tpu_state` transposes the weight. The step count
    and the scheduler's state are carried as they are."""
    params = dict(model.named_parameters())
    index = {id(p): j for j, p in enumerate(optimizer._parameter_list)}
    linear = _linear_weights(model)
    out = {k: state[k] for k in ("_step_count", "LR_Scheduler") if k in state}
    for key, value in state.items():
        if key in out:
            continue
        head, _, entry = key.partition(".")
        i = int(head[1:])
        name = names[i]
        if name not in params or id(params[name]) not in index:
            raise KeyError(f"load_paddle_tpu_optimizer_state: JAX parameter "
                           f"{i} ({name!r}) is not a parameter of the port's "
                           f"optimizer")
        value = np.asarray(value)
        if name in linear and value.ndim == 2:
            value = value.T
        out[f"p{index[id(params[name])]}.{entry}"] = value
    optimizer.set_state_dict(out)
