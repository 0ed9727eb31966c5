from . import lr
from .adam import Adam, Adamax, AdamW
from .fused import FusedAdamW
from .lbfgs import LBFGS
from .optimizer import Optimizer
from .sgd import (SGD, Adadelta, Adagrad, DGCMomentum, Lamb, Lars, Momentum,
                  RMSProp)

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
    "RMSProp", "Adadelta", "Lamb", "Lars", "DGCMomentum", "FusedAdamW",
    "LBFGS", "lr",
]
