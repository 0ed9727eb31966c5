"""The head-dim flash kernels' CUDA source (``csrc/flash_attention_mma.cu``,
head dims 16, 32, 48, 80, 96, 112: wgmma fed by TMA, persistent CTAs) run
on the CPU: built with g++ against the stand-in CUDA headers of
``paddle_tpu_torch/tools/cpu_stub/`` (``tools/cpu_rehearsal.py``: TMA
loads and stores with zero fill and the swizzles, mbarriers, named
barriers and wgmma from descriptors as warpgroup collectives) and driven
through the flash wrappers with CPU tensors, the forward (out, lse) and
backward (dq, dk, dv) held to the plain versions with ``chip_smoke.py``'s
gates (out within 2e-2, lse within 1e-3 of max(|plain|, 1), gradients
within 2e-2 of max |plain|) and the backward run twice (bitwise equal).
This checks the kernels' layouts, descriptors, barrier protocol across a
CTA's units, tiling, masking and online softmax, not their speed. The
source runs in a process of its own: the rehearsal replaces the libraries
of ``ops/cuda/_build``.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def test_mma_flash_kernels_agree_with_plain_versions_on_the_cpu():
    """Every compiled head dim: cross-attention (sq 70 / sk 77, sq 1 / sk
    77, sq 64 / sk 77), sk 1 (dq and dk 0 exactly: held against max |dv|),
    causal with GQA, q_offset and kv_len, rows that see nothing, the
    additive, bool and segment-id masks, and a d 112 case whose CTAs each
    walk several units (the rings' and Q buffers' phases across units)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source against the "
                    "stand-in headers")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.cpu_rehearsal",
         "flash_attention_mma"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "12 cases agree, 0 disagree" in proc.stdout
