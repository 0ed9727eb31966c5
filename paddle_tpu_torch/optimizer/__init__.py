from .adam import Adam, AdamW
from .fused import FusedAdamW
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "FusedAdamW"]
