"""What the kernel variants runners share: a variant is a few named text
edits of the sources in ``paddle_tpu_torch/csrc/``; every variant and the
sources as they are ("base") are built by nvcc at once, loaded beside each
other and timed with the L2 flushed before every launch.

``VARIANTS`` of a runner maps a name to ``(what it changes, [(source,
text, replacement), ...])``; a name "a+b" applies the edits of both.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from ..ops.cuda import _build


def names_of(argv, variants):
    """The variants named on the command line, each described once; exits
    with the usage on an unknown name or without a CUDA card."""
    unknown = [p for v in argv for p in v.split("+") if p not in variants]
    if unknown or not torch.cuda.is_available():
        raise SystemExit(f"usage: VARIANT ... from {sorted(variants)}, on a "
                         f"CUDA card (unknown: {unknown})")
    for v in argv:
        print(f"{v}: " + "; ".join(variants[p][0] for p in v.split("+")))
    return list(argv)


def build(names, variants, sources, out_dir):
    """``{(name, source): ctypes.CDLL}`` of "base" and every variant in
    ``names``, one nvcc per (name, source), all started together, into
    ``build/<out_dir>/``. Prints what ptxas says of serialised wgmma or
    spills, and each kernel whose machine code loads or stores local
    memory."""
    out = _build.BUILD_DIR.parent / out_dir
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ["base", *names]:
        edits = [e for part in name.split("+") if part != "base"
                 for e in variants[part][1]]
        for src in sources:
            text = (_build.SRC_DIR / f"{src}.cu").read_text()
            for which, old, new in edits:
                if which != src:
                    continue
                if old not in text:
                    raise SystemExit(f"variant {name}: {old!r} not in "
                                     f"{src}.cu")
                text = text.replace(old, new)
            cu = out / f"{name}-{src}.cu"
            cu.write_text(text)
            so = cu.with_suffix(".so")
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                   str(_build.SRC_DIR), "-o", str(so), str(cu)]
            procs[(name, src)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for (name, src), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {src}: nvcc failed\n{log[-4000:]}")
        for line in log.splitlines():
            if "Performance Loss" in line or (
                    "spill" in line and "0 bytes spill stores" not in line):
                print(f"  {name} {src} ptxas: {line.strip()}")
        for symbol, (st, ld) in _build.sass_local_accesses(so).items():
            if st or ld:
                m = re.search(r"[a-z_]*kernel(ILi\d+)?", symbol)
                print(f"  {name} {m.group(0) if m else symbol}: {st} local "
                      f"stores, {ld} local loads")
        libs[(name, src)] = ctypes.CDLL(str(so))
    return libs


_FLUSH = []


def cold_ms(fn, reps=10):
    """Mean device ms of ``fn`` (CUDA events), each call alone after the
    50 MB L2 was flushed and the card kept busy while the host queued it."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        _FLUSH[0].zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def warm_ms(fn, reps=10):
    """Mean device ms of ``fn`` over ``reps`` launches back to back (CUDA
    events; the card kept busy while the host queues them)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, pattern, reps=5):
    """``{kernel: device ms per call}`` of the kernels ``fn`` launches whose
    names match the regular expression ``pattern`` (``torch.profiler``,
    warm)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and e.device_time_total > 0:
            out[m.group(0)] = e.device_time_total / 1e3 / reps
    return out


def card():
    """The card's name, power limit and clocks, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
