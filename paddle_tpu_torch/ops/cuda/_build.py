"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``paddle_tpu_torch/csrc/<name>.cu`` becomes one shared library
``build/paddle_tpu_torch/<name>-<hash>.so`` (``build/`` under the checkout
root), keyed by a hash of its source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. The interface is plain C:
every pointer and the stream cross as ``c_void_p``, and every entry returns
``cudaGetLastError()`` so a refused launch surfaces at once.

Builds run at first use (``load``); ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for all of them. ``entry``, ``device_of``,
``stream`` and ``float_io`` are what the wrappers share around a launch.
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
           "check", "nvcc_path", "ptxas_report", "library_path",
           "sass_local_accesses", "entry", "device_of", "stream", "float_io"]

SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[tuple, object] = {}


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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built (it may not exist
    yet): every shared header is hashed too, so an edited header rebuilds."""
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
        target = library_path(name)
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
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def sass_local_accesses(path) -> Dict[str, tuple]:
    """``{kernel symbol: (local stores, local loads)}`` of the machine code
    in the library or cubin at ``path`` (``cuobjdump -sass``): the spills
    that are really there (ptxas counts them before a warpgroup's
    ``setmaxnreg`` budget applies)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = (0, 0)
        elif name is not None:
            st, ld = out[name]
            out[name] = (st + (" STL" in line), ld + (" LDL" in line))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = library_path(name)
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


def entry(name: str, fn: str, nptr: int, nint: int):
    """The C entry ``fn`` of ``csrc/<name>.cu`` taking ``nptr`` pointers,
    ``nint`` ints and the stream, returning an int; looked up once."""
    key = (name, fn)
    c_fn = _ENTRIES.get(key)
    if c_fn is None:
        c_fn = getattr(load(name), fn)
        c_fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint \
            + [ctypes.c_void_p]
        c_fn.restype = ctypes.c_int
        _ENTRIES[key] = c_fn
    return c_fn


def device_of(what: str, *tensors) -> str:
    """``"cpu"`` or ``"cuda"`` when every tensor (None skipped) lies there;
    raise on a mix or another device."""
    types = {t.device.type for t in tensors if t is not None}
    if types == {"cpu"} or types == {"cuda"}:
        return types.pop()
    raise ValueError(f"{what}: tensors on {sorted(types)}; all must lie on "
                     f"the CPU or on one CUDA device")


def stream(t) -> int:
    """The raw handle of the current stream of ``t``'s device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def float_io(what: str, *tensors):
    """The I/O dtype of kernels that compute in f32 from f32 or bf16 inputs
    (bf16 when every tensor is bf16, else f32) and the tensors in it,
    contiguous; raise unless all are float tensors on one device."""
    import torch

    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype not in (torch.float32, torch.bfloat16,
                                              torch.float16):
            raise ValueError(f"{what}: tensors must be float tensors on one "
                             f"device, got {t.dtype} on {t.device}")
    dt = torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in tensors) \
        else torch.float32
    return dt, [t.to(dt).contiguous() for t in tensors]
