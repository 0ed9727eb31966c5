"""The paged decode kernel's CUDA source run on the CPU: built with g++
against the stand-in CUDA headers of ``paddle_tpu_torch/tools/cpu_stub/``
(``tools/cpu_rehearsal.py``) and driven through its wrapper with CPU
tensors, held to the plain version with ``chip_smoke.py``'s gates (out
within 2e-2, m and l within 1e-3 of max(|plain|, 1), empty rows exactly
out 0, m -1e30, l 0) and run twice (bitwise equal). This checks the
kernel's indexing, its even shares of the units, its staging and its
in-launch merge of the rows split across CTAs, not its speed. The source
runs in a process of its own: the rehearsal replaces the libraries of
``ops/cuda/_build``.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def test_paged_kernel_agrees_with_plain_version_on_the_cpu():
    """Rows of 0, 1, 15, 16, 17, 100 and 257 tokens on shuffled blocks with
    null table tails, groups of 1, 2, 4 and 8 query heads, d = 64 and 128,
    bf16 and int8 pages, pages of 16 and 32 tokens, 24 rows, and shares
    longer than the addresses a CTA looks up at once, over the stand-in
    card's 8 CTAs; and the contiguous layout of the fused paged decode
    (row b on blocks b * pps onwards, row 0 on block 0, equal lengths)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA source against the "
                    "stand-in headers")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.cpu_rehearsal",
         "paged_attention"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "15 cases agree, 0 disagree" in proc.stdout
