"""The zero-bubble pipeline schedule (the counterpart of
``paddle_tpu/parallel/zero_bubble.py``; Paddle's ZBH1,
``pipeline_zero_bubble.py:61``): the backward is split into B, the
activation gradient on the critical path, and W, the weight gradient,
which runs after the ring has drained.

``PipelineTrainStep``'s ``zb`` / ``zbh1`` schedule is 1F1B with that split
(``pipeline.stage_orders``): B walks the stage's graph once for the input
gradient and the norms', embedding's and head's gradients, while each of
the layers' linears banks its input and output gradient
(``pipeline.LinearBank``); W forms those weight gradients, ``gy^T x``, from
the bank. B and W together cost one backward, and each stage holds its
banks from B to W.

:func:`pipeline_apply_zb` is ``pipeline_apply`` with the split over an
arbitrary ``stage_fn`` of stacked tensors, which has no linears to bank:
every B (``torch.autograd.grad`` of the stage's output with respect to its
input only, the graph kept) runs back along the ring, then every W walks
the kept graph again with respect to the stage's parameters, as JAX's W
pass runs a second vjp of the stage. The values are those of the undivided
backward; only the order differs.
"""

from __future__ import annotations

from typing import Callable

from .pipeline import _apply

__all__ = ["pipeline_apply_zb"]


def pipeline_apply_zb(stage_fn: Callable, stacked_params, x_microbatches,
                      *extras, mesh=None, axis: str = "pp", batch_spec=None):
    """The zero-bubble wavefront: ``pipeline_apply``'s contract with one
    group of layers a stage (``num_repeats == 1``); ``extras`` are not
    differentiated."""
    return _apply(stage_fn, stacked_params, x_microbatches, extras, mesh,
                  axis, 1, split=True)
