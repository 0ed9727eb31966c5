"""The SSM kernels' CUDA sources run on the CPU: each source
built with g++ against the stand-in CUDA headers of
``paddle_tpu_torch/tools/cpu_stub/`` (``tools/cpu_rehearsal.py``) and its
wrappers, driven with CPU tensors, held to the plain versions at the
kernels' edges with ``chip_smoke.py``'s gates (1e-4 of max |plain| in f32
I/O, 1e-2 in bf16). This checks the kernels' indexing and math, not their
speed, and not what only the CUDA compiler decides. Each source runs in a
process of its own: the rehearsal replaces the libraries of
``ops/cuda/_build``.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from paddle_tpu_torch.tools.cpu_rehearsal import prep

ROOT = Path(__file__).resolve().parents[1]


def test_prep_makes_launches_synchronous():
    """A launch becomes a synchronous ``stub_launch`` of a lambda (a grid
    with a nested call kept whole), the dynamic shared memory goes, and a
    static shared array becomes an aligned function static."""
    src = ("extern __shared__ __align__(128) unsigned char smem_raw[];\n"
           "__shared__ __align__(16) float buf[4];\n"
           "kern<T, 64><<<dim3(nc, (h + 11) / 12, b), 256, smem, st>>>(\n"
           "    x, y);\n")
    out = prep(src)
    assert "smem_raw" not in out
    assert "alignas(16) static float buf[4];" in out
    assert ("stub_launch(dim3(nc, (h + 11) / 12, b), 256, [&] { "
            "kern<T, 64>(\n    x, y); });") in out


@pytest.mark.parametrize("source", ["wkv", "ssd", "selective_scan"])
def test_kernels_agree_with_plain_versions_on_the_cpu(source):
    """The WKV backward (``wkv``: lengths 1 to 150 around the sub-chunks and
    chunks, d = 64 and 128, w = 0, logw >= 0), the SSD forward and
    backward (``ssd``: lengths 1 to 150, 3 to 13 heads, every state width,
    a strong decay) and the selective scan's forward and backward
    (``selective_scan``: lengths 1 to 150, d = 72 and 100, n = 5 and 16, a
    strong decay), each in f32 and bf16, every output finite."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources against the "
                    "stand-in headers")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.cpu_rehearsal",
         source], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "0 disagree" in proc.stdout
