"""High-level API for the port (the counterpart of ``paddle_tpu/hapi``):
``Model`` with ``fit`` / ``evaluate`` / ``predict`` and the callbacks."""

from . import callbacks
from .callbacks import (Callback, CallbackList, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger)
from .model import Model

__all__ = ["Model", "callbacks", "Callback", "CallbackList",
           "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler"]
