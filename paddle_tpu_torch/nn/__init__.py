from . import functional
from .functional import RMSNorm

__all__ = ["functional", "RMSNorm"]
