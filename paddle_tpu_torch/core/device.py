"""Device resolution and seeding.

Entry points default to the CUDA card. Without one they raise: the port
never runs on the CPU unless the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "make_generator"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises
    ``RuntimeError``; ``"cpu"`` is always allowed."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: CUDA is not available — pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paddle_tpu_torch: unsupported device {dev}")
    return dev


def make_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
