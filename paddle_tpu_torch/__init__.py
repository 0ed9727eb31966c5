"""paddle_tpu_torch — the PyTorch + CUDA (Hopper) port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package serves the
same Llama continuous-batching path with PyTorch for the plain tensor code
and hand-written CUDA C++ kernels (``csrc/``) for the two attention
kernels the path runs: the flash forward (prefill) and the paged decode.

It imports neither ``jax`` nor anything of ``paddle_tpu``. Entry points
(``ServingEngine``, ``LlamaForCausalLM``) run on the CUDA card unless the
caller passes ``device="cpu"``; without a card they raise instead of
running on the CPU.
"""

from .core.device import make_generator, resolve_device

__all__ = ["make_generator", "resolve_device"]
