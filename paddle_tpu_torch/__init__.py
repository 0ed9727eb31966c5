"""paddle_tpu_torch — the PyTorch + CUDA (Hopper) port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package serves the
Llama continuous-batching path and trains Llama (``jit.TrainStep`` with
``optimizer.AdamW``, or the eager loop with ``optimizer.FusedAdamW``) with
PyTorch for the plain tensor code and hand-written CUDA C++ kernels
(``csrc/``) for the kernels those paths run: the flash forward and
backward, the paged decode and the fused AdamW update.

It imports neither ``jax`` nor anything of ``paddle_tpu``. Entry points
(``ServingEngine``, ``LlamaForCausalLM``, ``TrainStep``, the optimizers)
run on the CUDA card unless the caller passes ``device="cpu"``; without a
card they raise instead of running on the CPU.
"""

from .core.device import make_generator, resolve_device

__all__ = ["make_generator", "resolve_device"]
