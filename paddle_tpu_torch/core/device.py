"""Device resolution and seeding.

Entry points default to the CUDA card. Without one they raise: the port
never runs on the CPU unless the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "entry_device", "make_generator"]


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


def entry_device(owned: torch.device, device, what: str) -> torch.device:
    """The device of an entry point that works on tensors living on
    ``owned``: ``device`` defaults to ``owned``, is resolved as
    :func:`resolve_device` does (so an explicit ``cuda`` without a card
    raises), and must match ``owned``."""
    dev = resolve_device(device if device is not None else owned)
    if dev.type != owned.type or dev.index not in (None, owned.index):
        raise ValueError(f"{what}: its tensors live on {owned}, it was asked "
                         f"for {dev}")
    return owned


def make_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
