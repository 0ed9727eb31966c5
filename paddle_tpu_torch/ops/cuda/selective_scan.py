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
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import _build

__all__ = ["selective_scan_fwd", "selective_scan_bwd",
           "selective_scan_reference", "launches", "bwd_launches",
           "KERNEL_CHUNK", "MAX_STATE"]

#: forward kernel launches since the count was last set to 0
launches = 0
#: backward calls (three kernel launches each) since the count was last
#: set to 0
bwd_launches = 0

KERNEL_CHUNK = 64        # steps between the states the forward keeps
MAX_STATE = 16           # states a kernel thread holds


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
                             return_bounds=False):
    """The plain version: the chunked XLA path of
    ``paddle_tpu/models/mamba.py:93-129`` in f32 (each chunk recomputed in
    the backward, as its ``jax.checkpoint`` does), y cast to u's dtype.
    Differentiable. With ``return_bounds`` also the f32 state entering each
    chunk, ``[b, ceil(l / chunk), n, d]``."""
    b, l, d = u.shape
    chunk = min(chunk, l)
    pad = (-l) % chunk
    f = [t.float() for t in (u, delta, B, C)]
    if pad:
        f = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in f]
    uf, df, Bf, Cf = f
    Af = A.float()
    h = torch.zeros(b, d, A.shape[-1], dtype=torch.float32, device=u.device)
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
