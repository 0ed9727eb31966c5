"""The Mamba-2 SSD recurrence: the plain PyTorch versions and the wrappers of
the hand-written forward and backward kernels (``csrc/ssd.cu``).

Replace the TPU kernels of ``paddle_tpu/ops/pallas/ssd.py``: the forward
(``pl.pallas_call`` at :198) and the backward (:243). Per head h, with x
``[b, l, h, dh]``, dt ``[b, l, h]``, A ``[h]``, B, C ``[b, l, ds]`` and D
``[h]``::

    S_t = exp(A_h dt_t) S_{t-1} + dt_t x_tᵀ B_t,    y_t = C_t S_tᵀ + D_h x_t

with the ``[dh, ds]`` state in f32 whatever the input dtype. The skip
``D x`` is added in f32 before y's one rounding to x's dtype, as the
reference's default route ``ssd_chunked`` adds it
(``paddle_tpu/ops/fused/ssd.py:109``, :118; ``ssd_pallas`` rounds twice,
``ssd.py:390``). The forward keeps the f32 state entering every chunk,
``[b, ceil(l / c), h, dh, ds]``, with ``c = kernel_chunk(dh, ds)``, from
which the backward replays each chunk. Each gradient comes back in its
input's dtype; the cotangent ``dy`` is read in its own dtype (the Pallas
backward casts it to x's first, ``ssd.py:263``).

x, B and C may be strided slices of one ``[b, l, width]`` tensor, as the
model's are of its conv output: the kernels take the stride between tokens
and read them in place. CPU tensors take the plain versions; CUDA tensors
launch the kernels or raise. The kernels take any b, l and h and dh, ds in
{64, 128}, the ``dh % 64 == 0 and ds % 64 == 0`` of the Pallas route at the
widths Mamba-2 uses.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import _build

__all__ = ["ssd_fwd", "ssd_bwd", "ssd_reference", "ssd_chunked_reference",
           "kernel_chunk", "launches", "bwd_launches"]

#: forward calls (two kernel launches each) since the count was last set
#: to 0
launches = 0
#: backward calls (two kernel launches each) since the count was last set
#: to 0
bwd_launches = 0

KERNEL_DIMS = (64, 128)     # the head and state widths the kernels take


def kernel_chunk(dh: int, ds: int) -> int:
    """The kernels' chunk: 64 steps at dh = ds = 64, else 32. The chunk's
    f32 tiles and the state sit in shared memory (227 KB a block): at 64 x
    64 a chunk of 64 takes 83 KB forward and 135 KB backward; at the wider
    states only a chunk of 32 lets the backward's tiles, the state and its
    gradient fit (207 KB at 128 x 128)."""
    return 64 if dh == ds == 64 else 32


# ------------------------------------------------------------ plain versions
def ssd_reference(x, dt, A, B, C, D):
    """The step-by-step oracle (``paddle_tpu/ops/fused/ssd.py:33-51``) in
    f32; returns ``[b, l, h, dh]`` in x's dtype."""
    b, l, h, dh = x.shape
    S = torch.zeros(b, h, dh, B.shape[-1], dtype=torch.float32,
                    device=x.device)
    xf, dtf, Bf, Cf, Af, Df = (t.float() for t in (x, dt, B, C, A, D))
    outs = []
    for t in range(l):
        a = torch.exp(Af[None] * dtf[:, t])                   # [b, h]
        dx = dtf[:, t, :, None] * xf[:, t]                    # [b, h, dh]
        S = a[..., None, None] * S \
            + dx[..., None] * Bf[:, t, None, None, :]
        outs.append(torch.einsum("bhds,bs->bhd", S, Cf[:, t])
                    + Df[None, :, None] * xf[:, t])
    return torch.stack(outs, dim=1).to(x.dtype)


def _chunk_step(S, xc, dtc, Bc, Cc, Af, Df):
    """One chunk of ``paddle_tpu/ops/fused/ssd.py:85-110`` in f32:
    ``(S_out [b, h, dh, ds], y [b, c, h, dh])``."""
    c = xc.shape[1]
    loga = Af * dtc                                           # [b, c, h]
    cum = torch.cumsum(loga, dim=1)                           # inclusive
    seg = cum[:, :, None, :] - cum[:, None, :, :]             # [b, j, i, h]
    causal = torch.ones(c, c, dtype=torch.bool, device=xc.device).tril()
    # mask the exponent, not the exp: the non-causal entries are positive,
    # their exp overflows to inf, and inf's gradient through where is NaN
    seg = torch.where(causal[None, :, :, None], seg,
                      torch.full_like(seg, -1e30))
    W = torch.einsum("bjs,bis->bji", Cc, Bc)[..., None] * torch.exp(seg)
    dx = dtc[..., None] * xc                                  # [b, c, h, dh]
    y = torch.einsum("bjih,bihd->bjhd", W, dx)
    y = y + torch.einsum("bjs,bhds,bjh->bjhd", Cc, S, torch.exp(cum))
    tail = torch.exp(cum[:, -1:] - cum)                       # [b, c, h]
    S = torch.exp(cum[:, -1])[..., None, None] * S + torch.einsum(
        "bihd,bis,bih->bhds", dx, Bc, tail)
    return S, y + Df[None, None, :, None] * xc


def ssd_chunked_reference(x, dt, A, B, C, D, chunk: int = 64,
                          return_states: bool = False):
    """The plain version: the reference's XLA chunked route
    (``paddle_tpu/ops/fused/ssd.py:54-118``) in f32, zero-padded to a
    multiple of the chunk (dt = 0 is an identity step), each chunk recomputed
    in the backward (``torch.utils.checkpoint``, as its ``jax.checkpoint``),
    the D skip added in f32 and y cast to x's dtype once. Differentiable.
    With ``return_states`` also the f32 state entering each chunk, ``[b,
    ceil(l / chunk), h, dh, ds]``."""
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    c = min(chunk, l)
    pad = (-l) % c
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                       for t in (dtf, Bf, Cf))
    Af, Df = A.float(), D.float()
    S = torch.zeros(b, h, dh, ds, dtype=torch.float32, device=x.device)
    ys, states = [], []
    grad = torch.is_grad_enabled()
    for c0 in range(0, l + pad, c):
        states.append(S)
        args = (S, xf[:, c0:c0 + c], dtf[:, c0:c0 + c], Bf[:, c0:c0 + c],
                Cf[:, c0:c0 + c], Af, Df)
        S, y = checkpoint(_chunk_step, *args, use_reentrant=False) \
            if grad else _chunk_step(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :l].to(x.dtype)
    if return_states:
        return y, torch.stack(states, dim=1)
    return y


# ------------------------------------------------------------------ wrappers
def _shapes(what, x, dt, A, B, C, D):
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"{what}: x [b, l, h, dh] and B [b, l, ds] "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(B.shape)}")
    b, l, h, dh = x.shape
    ds = B.shape[-1]
    if dt.shape != (b, l, h) or A.shape != (h,) or D.shape != (h,) \
            or B.shape != (b, l, ds) or C.shape != (b, l, ds):
        raise ValueError(f"{what}: x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} and D {tuple(D.shape)} disagree")
    return b, l, h, dh, ds


def _check_dims(what, dh, ds):
    if dh not in KERNEL_DIMS or ds not in KERNEL_DIMS:
        raise NotImplementedError(
            f"{what}: the kernels take head_dim and state_size 64 or 128 "
            f"(the Pallas route's multiples of 64), got dh = {dh}, ds = {ds}")


def _io_dtype(what, *tensors):
    """bf16 when every tensor is bf16, else f32 (the kernels compute in f32
    either way); raise on a tensor that is not floating point."""
    for t in tensors:
        if not t.is_floating_point():
            raise ValueError(f"{what}: float tensors expected, got {t.dtype}")
    return torch.bfloat16 if all(t.dtype == torch.bfloat16
                                 for t in tensors) else torch.float32


def _rows(t, dtype, align=1):
    """``(t', stride)``: t in ``dtype`` with its dims after ``[b, l]``
    packed and a single stride between tokens, so that token ``(bi, ti)``
    starts at ``(bi * l + ti) * stride``; a strided slice of a ``[b, l,
    width]`` tensor passes as it is, anything else is copied. With
    ``align``, also a slice whose start or token stride is not a multiple
    of ``align`` bytes is copied (the kernels load x, B, C and dy rows as
    16-byte vectors)."""
    t = t.to(dtype)
    b, l = t.shape[:2]
    inner = t.shape[2:]
    packed, step = [], 1
    for n in reversed(inner):
        packed.insert(0, step)
        step *= n
    s = t.stride(1)
    if list(t.stride()[2:]) != packed or s < step \
            or (b > 1 and t.stride(0) != l * s) \
            or (t.data_ptr() % align or s * t.element_size() % align):
        t = t.contiguous()
        s = step
    return t, s


def ssd_fwd(x, dt, A, B, C, D):
    """``(y, states)``: y ``[b, l, h, dh]`` in x's dtype (with the D skip)
    and the f32 state entering each chunk of ``kernel_chunk(dh, ds)`` steps,
    ``[b, nc, h, dh, ds]``. On CUDA tensors one call launches two kernels
    (the states over the chunks, then every chunk in parallel); on CPU
    tensors the plain version."""
    global launches
    what = "ssd"
    b, l, h, dh, ds = _shapes(what, x, dt, A, B, C, D)
    chunk = kernel_chunk(dh, ds)
    if _build.device_of(what, x, dt, A, B, C, D) == "cpu":
        with torch.no_grad():
            return ssd_chunked_reference(x, dt, A, B, C, D, chunk, True)
    _check_dims(what, dh, ds)
    io = _io_dtype(what, x, dt, B, C)
    dtk, sdt = _rows(dt, io)
    (xk, sx), (Bk, sb), (Ck, sc) = (
        _rows(t, io, align=16) for t in (x, B, C))
    Ak, Dk = (t.float().contiguous() for t in (A, D))
    dev = x.device
    y = torch.empty((b, l, h, dh), dtype=io, device=dev)
    nc = -(-l // chunk)
    states = torch.empty((b, nc, h, dh, ds), dtype=torch.float32, device=dev)
    rc = _build.entry("ssd", "ptt_ssd_fwd", 8, 10)(
        xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), Dk.data_ptr(), y.data_ptr(), states.data_ptr(), b, l,
        h, dh, ds, sx, sdt, sb, sc, int(io == torch.bfloat16),
        _build.stream(x))
    _build.check(_build.load("ssd"), rc, what)
    launches += 1
    return y.to(x.dtype), states


def ssd_bwd(x, dt, A, B, C, D, states, dy):
    """``(dx, ddt, dA, dB, dC, dD)`` of :func:`ssd_fwd` for the cotangent
    ``dy`` of y, each in its input's dtype. On CUDA tensors one call
    launches two kernels (the carries of the state's gradient over the
    chunks, then every chunk's backward in parallel), then sums their
    per-head-group and per-chunk partials; on CPU tensors the gradient of
    the plain version (``states`` checked, unused)."""
    global bwd_launches
    what = "ssd backward"
    b, l, h, dh, ds = _shapes(what, x, dt, A, B, C, D)
    if dy.shape != x.shape:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} is not "
                         f"{tuple(x.shape)}")
    chunk = kernel_chunk(dh, ds)
    nc = -(-l // chunk)
    if states.shape != (b, nc, h, dh, ds) or states.dtype != torch.float32 \
            or states.device != x.device or not states.is_contiguous():
        raise ValueError(f"{what}: states must be the forward's contiguous "
                         f"f32 [{b}, {nc}, {h}, {dh}, {ds}] on {x.device}")
    if _build.device_of(what, x, dt, A, B, C, D, dy) == "cpu":
        ins = [t.detach().requires_grad_() for t in (x, dt, A, B, C, D)]
        with torch.enable_grad():
            y = ssd_chunked_reference(*ins, chunk)
            return torch.autograd.grad(y, ins, dy)
    _check_dims(what, dh, ds)
    io = _io_dtype(what, x, dt, B, C, dy)
    dtk, sdt = _rows(dt, io)
    (xk, sx), (Bk, sb), (Ck, sc), (dyk, sdy) = (
        _rows(t, io, align=16) for t in (x, B, C, dy))
    Ak, Dk = (t.float().contiguous() for t in (A, D))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.load("ssd")
    groups = -(-h // lib.ptt_ssd_bwd_heads_per_block())
    dx = torch.empty((b, l, h, dh), dtype=io, device=dev)
    ddt = torch.empty((b, l, h), dtype=io, device=dev)
    # dA and dD, dB and dC side by side: one sum (and one cast) per pair
    dAD_part = torch.empty((2, b * nc, h), **f32)
    dBC_part = torch.empty((2, groups, b, l, ds), **f32)
    dA_part, dD_part = dAD_part
    dB_part, dC_part = dBC_part
    carry = torch.empty_like(states)
    rc = _build.entry("ssd", "ptt_ssd_bwd", 15, 11)(
        xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), Dk.data_ptr(), states.data_ptr(), dyk.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA_part.data_ptr(),
        dD_part.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
        carry.data_ptr(), b, l, h, dh, ds, sx, sdt, sb, sc, sdy,
        int(io == torch.bfloat16), _build.stream(x))
    _build.check(lib, rc, what)
    bwd_launches += 1
    dA, dD = _sum_pair(dAD_part, A.dtype, D.dtype)
    dB, dC = _sum_pair(dBC_part, B.dtype, C.dtype)
    return dx.to(x.dtype), ddt.to(dt.dtype), dA, dB, dC, dD


def _sum_pair(parts, dt0, dt1):
    """Two stacked partials ``[2, k, ...]`` summed over k in one reduction,
    each in its dtype (one cast when the two agree)."""
    both = parts.sum(1)
    if dt0 == dt1:
        both = both.to(dt0)
    return both[0].to(dt0), both[1].to(dt1)
