"""Framework utilities (the counterpart of ``paddle_tpu/framework``):
per-region activation recomputation (``recompute.py``) and ``save`` /
``load`` (``io.py``)."""

from . import io
from .io import load, save
from .recompute import recompute, recompute_sequential, resolve_policy

__all__ = ["io", "save", "load", "recompute", "recompute_sequential",
           "resolve_policy"]
