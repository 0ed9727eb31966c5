"""paddle_tpu_torch — the PyTorch + CUDA (Hopper) port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package serves the
Llama continuous-batching path (bf16, or int8/int4 weights and an int8 KV
pool), trains Llama (``jit.TrainStep`` with ``optimizer.AdamW``, or the
eager Paddle loop: ``io.DataLoader``, ``amp.auto_cast`` and
``amp.GradScaler``, the ``optimizer`` family with LR schedulers, clip
objects and master weights, or ``optimizer.FusedAdamW``), trains the
MoE-Llama (``models.MoELlamaForCausalLM`` over ``parallel.MoELayer``) and
trains the state-space and linear-attention models Mamba-1
(``models.MambaForCausalLM``), Mamba-2 (``models.Mamba2ForCausalLM``) and
RWKV-5 (``models.RwkvForCausalLM``), and trains and evaluates the
VisionTransformer (``models.VisionTransformer``) through the high-level
``Model`` (``fit`` / ``evaluate`` / ``predict`` with ``hapi.callbacks`` and
``metric``; checkpoints by ``save`` / ``load``), with PyTorch for the plain tensor code
and hand-written CUDA C++ kernels (``csrc/``) for the kernels those paths
run: the flash forward and backward, the paged decode, the weight-only
GEMMs, the fused AdamW update, the grouped GEMMs of the experts, and the
forward and backward of the selective scan, of the SSD recurrence and of
the WKV recurrence.

It imports neither ``jax`` nor anything of ``paddle_tpu``. Entry points
(``ServingEngine``, the models, ``TrainStep``, the optimizers)
run on the CUDA card unless the caller passes ``device="cpu"``; without a
card they raise instead of running on the CPU.
"""

from .core.device import make_generator, resolve_device
from .framework.io import load, save
from .hapi import Model

__all__ = ["make_generator", "resolve_device", "save", "load", "Model"]
