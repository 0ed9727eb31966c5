from . import clip, functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grads_)
from .functional import GroupNorm, LayerNorm, RMSNorm

__all__ = ["clip", "functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grads_", "GroupNorm", "LayerNorm",
           "RMSNorm"]
