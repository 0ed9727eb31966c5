from . import functional
from .functional import GroupNorm, LayerNorm, RMSNorm

__all__ = ["functional", "GroupNorm", "LayerNorm", "RMSNorm"]
