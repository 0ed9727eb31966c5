"""Framework utilities (the counterpart of ``paddle_tpu/framework``). Ported
so far: per-region activation recomputation (``recompute.py``)."""

from .recompute import recompute, recompute_sequential, resolve_policy

__all__ = ["recompute", "recompute_sequential", "resolve_policy"]
