"""Gradient clipping (the counterpart of ``paddle_tpu/nn/clip.py``).

A clip object maps a list of ``(param, grad)`` pairs to a new list; an
optimizer built with ``grad_clip=`` applies it in ``step()`` before the
update. Each clipped gradient is a new tensor in the gradient's dtype, the
arithmetic in f32 as the JAX package does it. A parameter whose
``need_clip`` attribute is False keeps its gradient.

``ClipGradByGlobalNorm`` spans every shard when a mesh is set
(``parallel.HybridMesh``): a gradient whose parameter carries
``_dist_axes`` (the mesh axes it is sharded over, set by
``parallel.ShardedTrainStep``) adds its sum of squares over those axes'
group, a replicated one counts once (the JAX package's hook,
``paddle_tpu/parallel/env.py:73``, where GSPMD makes the sum global).
"""

from __future__ import annotations

import torch

from ..amp import uncast

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grads_"]


def _skips(p, g) -> bool:
    return g is None or not getattr(p, "need_clip", True)


class ClipGradBase:
    """``clip(params_grads)`` returns the clipped ``[(param, grad)]``, with
    nothing cast under ``auto_cast`` (:func:`~paddle_tpu_torch.amp.uncast`),
    as JAX's raw array code is not."""

    def __call__(self, params_grads):
        with uncast():
            return self._clip(params_grads)

    def _clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, g) if _skips(p, g) else (p, g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skips(p, g):
                out.append((p, g))
                continue
            g32 = g.float()
            nrm = torch.sqrt(torch.sum(torch.square(g32)))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(nrm, 1e-12), 1.0)
            out.append((p, (g32 * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by ``clip_norm / max(global_norm,
    clip_norm)``; the global norm from the f32 sums of squares of the
    gradients that take part. No host sync."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def _global_norm_sq(self, params_grads):
        """The f32 sum of squares of every gradient, each sharded one
        summed over the axes of its parameter's ``_dist_axes``."""
        sums = {}
        for p, g in params_grads:
            axes = tuple(getattr(p, "_dist_axes", ()))
            sums.setdefault(axes, []).append(torch.sum(torch.square(
                g.float())))
        sums = {a: torch.sum(torch.stack(v)) for a, v in sums.items()}
        if len(sums) == 1 and () in sums:
            return sums[()]
        from ..parallel.env import reduce_global_norm_sq

        return reduce_global_norm_sq(sums)

    def _clip(self, params_grads):
        clippable = [(p, g) for p, g in params_grads if not _skips(p, g)]
        if not clippable:
            return params_grads
        gnorm = torch.sqrt(self._global_norm_sq(clippable))
        scale = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        return [(p, g) if _skips(p, g)
                else (p, (g.float() * scale).to(g.dtype))
                for p, g in params_grads]


def clip_grads_(parameters, clip) -> None:
    """Apply a clip object to ``param.grad`` in place."""
    pg = [(p, p.grad) for p in parameters if p.grad is not None]
    with torch.no_grad():
        for p, g in clip(pg):
            if g is not None:
                p.grad = g
