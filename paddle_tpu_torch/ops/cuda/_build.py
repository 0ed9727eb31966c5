"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``paddle_tpu_torch/csrc/<name>.cu`` becomes one shared library
``build/paddle_tpu_torch/<name>-<hash>.so`` (``build/`` under the checkout
root), keyed by a hash of its source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. The interface is plain C:
every pointer and the stream cross as ``c_void_p``, and every entry returns
``cudaGetLastError()`` so a refused launch surfaces at once.

Builds run at first use (``load``); ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load",
           "check", "nvcc_path", "ptxas_report"]

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("paddle_tpu_torch: nvcc not found (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    # every shared header is hashed too, so an edited header rebuilds
    key = (SRC_DIR / f"{name}.cu").read_bytes() \
        + b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh"))) \
        + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _sources():
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build_all(names=None) -> Dict[str, float]:
    """Compile every source (or ``names``) whose library is missing, one
    ``nvcc`` process per source, all started together. Returns the seconds
    each build took (0.0 for a library that was already there)."""
    names = list(names or _sources())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, out = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("paddle_tpu_torch: nvcc failed for "
                           + "\n".join(failed))
    return out


def ptxas_report(name: str) -> Optional[str]:
    """What ``nvcc -Xptxas -v`` printed when ``name`` was last built here
    (registers, shared memory and spills per kernel), or None."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.ptt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
