"""Activation recomputation (the counterpart of
``paddle_tpu/framework/recompute.py``).

A region run through :func:`recompute` keeps only its inputs for the
backward, which runs the region again to rebuild what it needs
(``torch.utils.checkpoint`` without reentrancy, the RNG state preserved).
The ``"save_dots"`` policy keeps more: the outputs of the matrix products
(``aten.mm``, ``aten.addmm``, ``aten.bmm``) and of the flash forward (the
``paddle_tpu_torch::flash_fwd`` operator's ``out`` and ``lse``), so the
backward recomputes only the elementwise chains between them: the norms,
rope, swiglu and the residual adds. That is the JAX policy
``save_from_both_policies(save_only_these_names("flash_out", "flash_lse"),
checkpoint_dots)``; here it is a selective-checkpoint policy over the
dispatcher's operators. A region run under ``amp.auto_cast`` runs again
under the same settings (the JAX package casts while it traces the
forward, so its recomputed region is cast alike).
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import amp

# the flash forward's module registers the paddle_tpu_torch::flash_fwd operator
from ..ops.fused import flash_attention  # noqa: F401

__all__ = ["recompute", "recompute_sequential", "resolve_policy"]

#: the operators whose outputs ``"save_dots"`` keeps
SAVED_BY_SAVE_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.paddle_tpu_torch.flash_fwd.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in SAVED_BY_SAVE_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_policy(policy):
    """Map a policy name to a selective-checkpoint policy function
    ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``: ``"full"`` or
    None — None, nothing inside the region is saved (the reference
    recompute's default); ``"save_dots"`` — the matrix products' and the
    flash forward's outputs are saved, the elementwise ops recomputed
    (Megatron-style selective recompute, the policy of ``bench.py``'s 7B
    proxy). A callable is such a function and is returned as it is; any
    other value raises ``ValueError``."""
    if policy is None or policy == "full":
        return None
    if callable(policy):
        return policy
    if policy == "save_dots":
        return _save_dots
    raise ValueError(f"unknown recompute policy: {policy!r}")


def recompute(function: Callable, *args, policy=None, **kwargs) -> Any:
    """Run ``function(*args, **kwargs)`` keeping for the backward only what
    ``policy`` saves (:func:`resolve_policy`); the rest is recomputed
    during the backward pass, under the RNG state of the forward. The
    parameters of a module ``function`` get their gradients as usual."""
    saved = amp.settings()
    if saved is not None:
        function = functools.partial(amp.under, saved, function)
    fn = resolve_policy(policy)
    if fn is None:
        return checkpoint(function, *args, use_reentrant=False, **kwargs)
    return checkpoint(
        function, *args, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     fn), **kwargs)


def recompute_sequential(ctx: dict, functions, *args, **kwargs):
    """Chunk a list of layers into ``ctx["segments"]`` runs and recompute
    each as one region (``paddle_tpu/framework/recompute.py:138-160``); a
    callable (an ``nn.Sequential`` too) is recomputed whole, with
    ``kwargs``. A layer that returns a tuple hands it on as arguments."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) else 1
    if callable(functions):
        return recompute(functions, *args, **kwargs)
    layers = list(functions)
    per = max(len(layers) // segments, 1)
    out = args
    for i in range(0, len(layers), per):
        chunk = layers[i:i + per]

        def seg(*xs, _chunk=chunk):
            y = xs if len(xs) > 1 else xs[0]
            for layer in _chunk:
                y = layer(*y) if isinstance(y, tuple) else layer(y)
            return y

        out = recompute(seg, *out)
        if not isinstance(out, tuple):
            out = (out,)
    return out[0] if len(out) == 1 else out
