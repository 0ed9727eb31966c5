"""The selective scan (S6, Mamba-1): the plain PyTorch version and the
wrappers of the hand-written forward and backward kernels
(``csrc/selective_scan.cu``).

Replace the TPU kernels of ``paddle_tpu/ops/pallas/selective_scan.py``:
the forward (``pl.pallas_call`` at :217) and the backward (:284). With
u, delta ``[b, l, d]``, A ``[d, n]`` and B, C ``[b, l, n]``::

    h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t,    y_t = C_t . h_t

in f32 whatever the input dtype; y comes back in u's dtype and each
gradient in its input's dtype, as ``_scan_fwd`` / ``_scan_bwd`` cast them
(:252-262, :328-329). The skip ``u * D`` is not part of it. The forward
keeps the f32 state entering every chunk of :data:`KERNEL_CHUNK` steps,
``[b, ceil(l / 64), n, d]``, from which the backward replays the states.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. The kernels take any b, l and d and 1 <= n <= :data:`MAX_STATE`.

The log-depth variant (``FLAGS_mamba_logdepth_scan``, JAX's
``logdepth=True`` bodies: ``_replay_h`` at :57-98 and the backward's suffix
scan at :148-170) cuts the sequence into spans of :func:`scan_span` steps
and runs each span's recurrence as a Hillis-Steele scan:
:func:`selective_scan_logdepth_fwd` / :func:`selective_scan_logdepth_bwd`
launch its kernels (spans of :data:`LOGDEPTH_SPANS` steps) on CUDA tensors
and take its plain versions, :func:`selective_scan_logdepth_reference` and
:func:`selective_scan_logdepth_bwd_reference` (transcriptions of the JAX
kernel's arithmetic, in its order), on CPU tensors.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...core.flags import flag
from . import _build

__all__ = ["selective_scan_fwd", "selective_scan_bwd",
           "selective_scan_reference", "launches", "bwd_launches",
           "KERNEL_CHUNK", "MAX_STATE", "scan_span", "LOGDEPTH_SPANS",
           "selective_scan_logdepth_fwd", "selective_scan_logdepth_bwd",
           "selective_scan_logdepth_reference",
           "selective_scan_logdepth_bwd_reference", "logdepth_launches",
           "logdepth_bwd_launches"]

#: forward kernel launches since the count was last set to 0
launches = 0
#: backward calls (three kernel launches each) since the count was last
#: set to 0
bwd_launches = 0

#: log-depth forward kernel launches since the count was last set to 0
logdepth_launches = 0
#: log-depth backward kernel launches since the count was last set to 0
logdepth_bwd_launches = 0

KERNEL_CHUNK = 64        # steps between the states the forward keeps
MAX_STATE = 16           # states a kernel thread holds
LOGDEPTH_SPANS = (8, 16, 32, 64)   # the log-depth kernels' spans


# ------------------------------------------------------------ plain version
def _chunk_scan(h0, u, delta, A, B, C):
    """One chunk of the XLA path (``paddle_tpu/models/mamba.py:110-119``):
    a Hillis-Steele inclusive scan over ``(exp(delta A), delta B u)``, the
    carried state folded through the chunk's total decay. f32 ``[b, c, ...]``
    in, ``(h_last [b, d, n], y [b, c, d])`` out."""
    a = torch.exp(delta[..., None] * A)                        # [b, c, d, n]
    x = delta[..., None] * B[:, :, None, :] * u[..., None]
    c, shift = a.shape[1], 1
    while shift < c:
        pad_x = torch.zeros_like(x[:, :shift])
        pad_a = torch.ones_like(a[:, :shift])
        x = x + a * torch.cat([pad_x, x[:, :-shift]], dim=1)
        a = a * torch.cat([pad_a, a[:, :-shift]], dim=1)
        shift *= 2
    h = x + a * h0[:, None]
    return h[:, -1], torch.einsum("bcdn,bcn->bcd", h, C)


def selective_scan_reference(u, delta, A, B, C, chunk=KERNEL_CHUNK,
                             return_bounds=False, dtype=torch.float32):
    """The plain version: the chunked XLA path of
    ``paddle_tpu/models/mamba.py:93-129`` in f32 (each chunk recomputed in
    the backward, as its ``jax.checkpoint`` does), y cast to u's dtype.
    Differentiable. With ``return_bounds`` also the state entering each
    chunk, ``[b, ceil(l / chunk), n, d]``. ``dtype`` is the type it computes
    in: float64 gives a reference for the f32 kernels."""
    b, l, d = u.shape
    chunk = min(chunk, l)
    pad = (-l) % chunk
    f = [t.to(dtype) for t in (u, delta, B, C)]
    if pad:
        f = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in f]
    uf, df, Bf, Cf = f
    Af = A.to(dtype)
    h = torch.zeros(b, d, A.shape[-1], dtype=dtype, device=u.device)
    ys, bounds = [], []
    grad = torch.is_grad_enabled()
    for c0 in range(0, l + pad, chunk):
        bounds.append(h)
        args = (h, uf[:, c0:c0 + chunk], df[:, c0:c0 + chunk], Af,
                Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk])
        h, y = checkpoint(_chunk_scan, *args, use_reentrant=False) \
            if grad else _chunk_scan(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :l].to(u.dtype)
    if return_bounds:
        return y, torch.stack(bounds, dim=1).transpose(2, 3)
    return y


# ------------------------------------------------------------------ wrappers
def _shapes(what, u, delta, A, B, C):
    if u.dim() != 3 or A.dim() != 2 or B.dim() != 3:
        raise ValueError(f"{what}: u [b, l, d], A [d, n] and B [b, l, n] "
                         f"expected, got {tuple(u.shape)}, {tuple(A.shape)} "
                         f"and {tuple(B.shape)}")
    b, l, d = u.shape
    n = A.shape[1]
    if delta.shape != u.shape or A.shape[0] != d or B.shape != (b, l, n) \
            or C.shape != (b, l, n):
        raise ValueError(f"{what}: u {tuple(u.shape)}, delta "
                         f"{tuple(delta.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} and C {tuple(C.shape)} disagree")
    return b, l, d, n


def _check_states(what, n):
    if not 1 <= n <= MAX_STATE:
        raise NotImplementedError(
            f"{what}: the kernel holds at most {MAX_STATE} states per "
            f"channel, got n = {n}")


def _rows16(t, width):
    """``t [b, l, w]`` as a 16-byte aligned tensor with rows of ``width``
    values (``width`` >= w, zero past w): ``t`` itself when it already is
    one, else a padded copy (the forward kernel stages rows by 16-byte
    cp.async)."""
    if t.shape[-1] == width and t.data_ptr() % 16 == 0:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def selective_scan_fwd(u, delta, A, B, C):
    """``(y, bounds)``: y ``[b, l, d]`` in u's dtype and the f32 state
    entering each chunk of :data:`KERNEL_CHUNK` steps ``[b, ceil(l / 64),
    n, d]``. One kernel launch on CUDA tensors, the plain version on CPU
    tensors."""
    global launches
    what = "selective_scan"
    b, l, d, n = _shapes(what, u, delta, A, B, C)
    if _build.device_of(what, u, delta, A, B, C) == "cpu":
        with torch.no_grad():
            y, bounds = selective_scan_reference(u, delta, A, B, C,
                                                 KERNEL_CHUNK, True)
        return y, bounds.contiguous()
    _check_states(what, n)
    dt, (uk, dk, Bk, Ck) = _build.float_io(what, u, delta, B, C)
    # u and delta in rows of a whole number of 16-byte vectors, B and C in
    # rows of MAX_STATE (copies only off those widths or alignments)
    vec = 16 // uk.element_size()
    ld = -(-d // vec) * vec
    uk, dk = _rows16(uk, ld), _rows16(dk, ld)
    Bk, Ck = _rows16(Bk, MAX_STATE), _rows16(Ck, MAX_STATE)
    Ak = A.float().contiguous()
    y = torch.empty((b, l, d), dtype=dt, device=u.device)
    nc = -(-l // KERNEL_CHUNK)
    bounds = torch.empty((b, nc, n, d), dtype=torch.float32, device=u.device)
    rc = _build.entry("selective_scan", "ptt_selective_scan_fwd", 7, 6)(
        uk.data_ptr(), dk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), y.data_ptr(), bounds.data_ptr(), b, l, d, ld, n,
        int(dt == torch.bfloat16), _build.stream(u))
    _build.check(_build.load("selective_scan"), rc, what)
    launches += 1
    return y.to(u.dtype), bounds


def selective_scan_bwd(u, delta, A, B, C, bounds, dy):
    """``(du, ddelta, dA, dB, dC)`` of :func:`selective_scan_fwd` for the
    cotangent ``dy`` of y, each in its input's dtype. On CUDA tensors one
    call launches three kernels (each chunk's local gradient carry, the
    carry pass over the chunks, the chunks' backward), then sums their
    partials; on CPU tensors the gradient of the plain version (``bounds``
    checked, unused)."""
    global bwd_launches
    what = "selective_scan backward"
    b, l, d, n = _shapes(what, u, delta, A, B, C)
    if dy.shape != u.shape:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} is not "
                         f"{tuple(u.shape)}")
    nc = -(-l // KERNEL_CHUNK)
    if bounds.shape != (b, nc, n, d) or bounds.dtype != torch.float32 \
            or bounds.device != u.device or not bounds.is_contiguous():
        raise ValueError(f"{what}: bounds must be the forward's contiguous "
                         f"f32 [{b}, {nc}, {n}, {d}] on {u.device}")
    if _build.device_of(what, u, delta, A, B, C, dy) == "cpu":
        ins = [t.detach().requires_grad_() for t in (u, delta, A, B, C)]
        with torch.enable_grad():
            y = selective_scan_reference(*ins, KERNEL_CHUNK)
            return torch.autograd.grad(y, ins, dy)
    _check_states(what, n)
    dt, (uk, dk, Bk, Ck, dyk) = _build.float_io(what, u, delta, B, C, dy)
    Ak = A.float().contiguous()
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((b, l, d), dtype=dt, device=dev)
    ddelta = torch.empty((b, l, d), dtype=dt, device=dev)
    lib = _build.load("selective_scan")
    tiles = -(-d // lib.ptt_selective_scan_bwd_channels())
    dA_part = torch.empty((b * nc, d, n), **f32)
    # dB and dC side by side: one sum (and one cast) for both
    dBC_part = torch.empty((2, tiles, b, l, n), **f32)
    dB_part, dC_part = dBC_part
    carry = torch.empty((b, nc, n, d), **f32)
    dsum = torch.empty((b, nc, d), **f32)
    rc = _build.entry("selective_scan", "ptt_selective_scan_bwd", 14, 5)(
        uk.data_ptr(), dk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), bounds.data_ptr(), dyk.data_ptr(), du.data_ptr(),
        ddelta.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), carry.data_ptr(), dsum.data_ptr(), b, l, d, n,
        int(dt == torch.bfloat16), _build.stream(u))
    _build.check(lib, rc, what)
    bwd_launches += 1
    dBC = dBC_part.sum(1)
    if B.dtype == C.dtype:
        dBC = dBC.to(B.dtype)
    return (du.to(u.dtype), ddelta.to(delta.dtype),
            dA_part.sum(0).to(A.dtype), dBC[0].to(B.dtype),
            dBC[1].to(C.dtype))


# ---------------------------------------------------------------- log-depth
def scan_span(l: int, chunk: int) -> int:
    """The log-depth scan's span for a sequence of ``l`` steps: JAX's
    ``_scan_chunk`` (``paddle_tpu/ops/pallas/selective_scan.py:45-55``)
    without the autotune cache, the ``selective_scan_blocks`` flag if set,
    else ``min(chunk, l)``, clamped to ``[8, l]`` (8 wins for l < 8: the
    sequence is padded to one span)."""
    raw = str(flag("selective_scan_blocks") or "").split(",")[0].strip()
    try:
        over = int(raw)
    except ValueError:
        over = 0
    return max(8, min(over or min(chunk, l), l))


def _logdepth_replay(h0, a, x, span):
    """``_replay_h(logdepth=True)`` over one span: the entering state
    ``h0 [b, d, n]`` folded into step 0, then the inclusive Hillis-Steele
    scan of ``(a, x) [b, span, d, n]``; returns every h_t."""
    x = torch.cat([x[:, :1] + a[:, :1] * h0[:, None], x[:, 1:]], dim=1)
    shift = 1
    while shift < span:
        one = torch.ones_like(a[:, :shift])
        x = x + a * torch.cat([torch.zeros_like(x[:, :shift]),
                               x[:, :-shift]], dim=1)
        a = a * torch.cat([one, a[:, :-shift]], dim=1)
        shift *= 2
    return x


def _logdepth_inputs(u, delta, A, B, C, span, dtype, *more):
    b, l, d = u.shape
    pad = (-l) % span
    f = [t.to(dtype) for t in (u, delta, B, C) + more]
    if pad:
        f = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in f]
    return (l + pad) // span, A.to(dtype), f


def selective_scan_logdepth_reference(u, delta, A, B, C, span,
                                      dtype=torch.float32):
    """The plain log-depth forward: ``(y, bounds)``, y ``[b, l, d]`` in u's
    dtype and the state entering each span ``[b, ceil(l / span), n, d]``,
    computed in ``dtype`` (float64 gives a reference for the f32 kernel) as
    ``_fwd_kernel(logdepth=True)`` computes them: the sequence padded with
    zeros to whole spans, ``a = exp(delta A)``, ``x = delta u B``, each
    span's states by :func:`_logdepth_replay`, ``y_t = sum_n C_t h_t``."""
    b, l, d = u.shape
    nc, Af, (uf, df, Bf, Cf) = _logdepth_inputs(u, delta, A, B, C, span,
                                                dtype)
    h = torch.zeros(b, d, A.shape[-1], dtype=dtype, device=u.device)
    ys, bounds = [], []
    for c0 in range(0, nc * span, span):
        bounds.append(h)
        dl = df[:, c0:c0 + span]
        a = torch.exp(dl[..., None] * Af)                      # [b, c, d, n]
        x = (dl * uf[:, c0:c0 + span])[..., None] \
            * Bf[:, c0:c0 + span, None, :]
        hs = _logdepth_replay(h, a, x, span)
        ys.append((hs * Cf[:, c0:c0 + span, None, :]).sum(-1))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :l].to(u.dtype)
    return y, torch.stack(bounds, dim=1).transpose(2, 3)


def selective_scan_logdepth_bwd_reference(u, delta, A, B, C, bounds, dy, span,
                                          dtype=torch.float32):
    """The plain log-depth backward: ``(du, ddelta, dA, dB, dC)`` of
    :func:`selective_scan_logdepth_reference` for the cotangent ``dy``, each
    in its input's dtype, computed in ``dtype`` as ``_bwd_kernel(logdepth=
    True)`` computes them: spans from the last, each replayed from its
    entering state in ``bounds``, ``dh_t = C_t dy_t + a_{t+1} dh_{t+1}`` by
    the suffix Hillis-Steele scan with the carry from the right on the last
    step, the carry to the left ``a_0 dh_0``, and the epilogue ``common =
    dh h_{t-1} a``: ``ddelta = sum_n common A + (sum_n dh B) u``, ``du =
    delta sum_n dh B``, ``dB = sum_d dh delta u``, ``dC = sum_d h dy``,
    ``dA = sum common delta``."""
    b, l, d = u.shape
    n = A.shape[-1]
    nc, Af, (uf, df, Bf, Cf, dyf) = _logdepth_inputs(u, delta, A, B, C, span,
                                                     dtype, dy)
    g = torch.zeros(b, d, n, dtype=dtype, device=u.device)
    dA = torch.zeros(d, n, dtype=dtype, device=u.device)
    parts = []
    for c in reversed(range(nc)):
        sl = slice(c * span, (c + 1) * span)
        h0 = bounds[:, c].transpose(1, 2).to(dtype)            # [b, d, n]
        dl, uu, Bm, Cm, dyc = df[:, sl], uf[:, sl], Bf[:, sl], Cf[:, sl], \
            dyf[:, sl]
        da = torch.exp(dl[..., None] * Af)                     # [b, c, d, n]
        dlu = dl * uu
        hs = _logdepth_replay(h0, da, dlu[..., None] * Bm[:, :, None, :],
                              span)
        s = Cm[:, :, None, :] * dyc[..., None]
        s = torch.cat([s[:, :-1], s[:, -1:] + g[:, None]], dim=1)
        m = torch.cat([da[:, 1:], torch.ones_like(da[:, :1])], dim=1)
        dh, shift = s, 1
        while shift < span:
            one = torch.ones_like(m[:, :shift])
            dh = dh + m * torch.cat([dh[:, shift:],
                                     torch.zeros_like(dh[:, :shift])], dim=1)
            m = m * torch.cat([m[:, shift:], one], dim=1)
            shift *= 2
        g = da[:, 0] * dh[:, 0]
        hprev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
        common = dh * hprev * da
        s1 = (common * Af).sum(-1)                             # [b, c, d]
        s2 = (dh * Bm[:, :, None, :]).sum(-1)
        parts.append((dl * s2, s1 + s2 * uu,
                      (dh * dlu[..., None]).sum(2),            # [b, c, n]
                      (hs * dyc[..., None]).sum(2)))
        dA = dA + (common * dl[..., None]).sum((0, 1))
    du, ddelta, dB, dC = (torch.cat(p[::-1], dim=1)[:, :l]
                          for p in zip(*parts))
    return (du.to(u.dtype), ddelta.to(delta.dtype), dA.to(A.dtype),
            dB.to(B.dtype), dC.to(C.dtype))


def _check_span(what, span):
    if span not in LOGDEPTH_SPANS:
        raise NotImplementedError(
            f"{what}: the log-depth kernels scan spans of "
            f"{LOGDEPTH_SPANS} steps, got a span of {span} (scan_span: "
            f"FLAGS_selective_scan_blocks or the chunk, clamped to [8, l])")


def _span_bounds(what, bounds, b, l, d, n, span, device):
    nc = -(-l // span)
    if bounds.shape != (b, nc, n, d) or bounds.dtype != torch.float32 \
            or bounds.device != device or not bounds.is_contiguous():
        raise ValueError(f"{what}: bounds must be the forward's contiguous "
                         f"f32 [{b}, {nc}, {n}, {d}] on {device}")


def selective_scan_logdepth_fwd(u, delta, A, B, C, span):
    """``(y, bounds)`` of the log-depth scan over spans of ``span`` steps:
    y ``[b, l, d]`` in u's dtype and the f32 state entering each span ``[b,
    ceil(l / span), n, d]``. One kernel launch on CUDA tensors (a span of
    :data:`LOGDEPTH_SPANS`, n <= :data:`MAX_STATE`), the plain version on
    CPU tensors."""
    global logdepth_launches
    what = "selective_scan (log-depth)"
    b, l, d, n = _shapes(what, u, delta, A, B, C)
    if _build.device_of(what, u, delta, A, B, C) == "cpu":
        with torch.no_grad():
            y, bounds = selective_scan_logdepth_reference(u, delta, A, B, C,
                                                          span)
        return y, bounds.float().contiguous()
    _check_states(what, n)
    _check_span(what, span)
    dt, (uk, dk, Bk, Ck) = _build.float_io(what, u, delta, B, C)
    Ak = A.float().contiguous()
    y = torch.empty((b, l, d), dtype=dt, device=u.device)
    bounds = torch.empty((b, -(-l // span), n, d), dtype=torch.float32,
                         device=u.device)
    rc = _build.entry("selective_scan", "ptt_selective_scan_logdepth_fwd",
                      7, 6)(
        uk.data_ptr(), dk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), y.data_ptr(), bounds.data_ptr(), b, l, d, n, span,
        int(dt == torch.bfloat16), _build.stream(u))
    _build.check(_build.load("selective_scan"), rc, what)
    logdepth_launches += 1
    return y.to(u.dtype), bounds


def selective_scan_logdepth_bwd(u, delta, A, B, C, bounds, dy, span):
    """``(du, ddelta, dA, dB, dC)`` of :func:`selective_scan_logdepth_fwd`
    for the cotangent ``dy``, each in its input's dtype: one kernel launch
    on CUDA tensors, then the sums of its partials; the plain version on
    CPU tensors."""
    global logdepth_bwd_launches
    what = "selective_scan backward (log-depth)"
    b, l, d, n = _shapes(what, u, delta, A, B, C)
    if dy.shape != u.shape:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} is not "
                         f"{tuple(u.shape)}")
    _span_bounds(what, bounds, b, l, d, n, span, u.device)
    if _build.device_of(what, u, delta, A, B, C, dy) == "cpu":
        return selective_scan_logdepth_bwd_reference(u, delta, A, B, C,
                                                     bounds, dy, span)
    _check_states(what, n)
    _check_span(what, span)
    dt, (uk, dk, Bk, Ck, dyk) = _build.float_io(what, u, delta, B, C, dy)
    Ak = A.float().contiguous()
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((b, l, d), dtype=dt, device=dev)
    ddelta = torch.empty((b, l, d), dtype=dt, device=dev)
    lib = _build.load("selective_scan")
    tiles = -(-d // lib.ptt_selective_scan_logdepth_channels())
    dA_part = torch.empty((b, d, n), **f32)
    dBC_part = torch.empty((2, tiles, b, l, n), **f32)
    dB_part, dC_part = dBC_part
    rc = _build.entry("selective_scan", "ptt_selective_scan_logdepth_bwd",
                      12, 6)(
        uk.data_ptr(), dk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), bounds.data_ptr(), dyk.data_ptr(), du.data_ptr(),
        ddelta.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), b, l, d, n, span, int(dt == torch.bfloat16),
        _build.stream(u))
    _build.check(lib, rc, what)
    logdepth_bwd_launches += 1
    dBC = dBC_part.sum(1)
    return (du.to(u.dtype), ddelta.to(delta.dtype),
            dA_part.sum(0).to(A.dtype), dBC[0].to(B.dtype),
            dBC[1].to(C.dtype))
