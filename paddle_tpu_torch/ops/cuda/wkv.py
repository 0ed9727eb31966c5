"""The RWKV-5 WKV recurrence: the plain PyTorch version and the wrappers of
the hand-written forward and backward kernels (``csrc/wkv.cu``).

Replace the TPU kernels of ``paddle_tpu/ops/pallas/wkv.py``: the forward
(``pl.pallas_call`` at :301) and the backward (:350). Per head, with
r, k, v ``[b, l, h, d]``, ``w = exp(min(logw, 0))`` and the bonus u
(``logw``, u ``[h, d]``)::

    out_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t),    S_t = diag(w) S_{t-1} + k_tᵀ v_t

with the ``[d, d]`` state in f32. y comes back in r's dtype; dr, dk, dv in
their inputs' dtypes and dlogw, du in those of logw and u, dlogw zero where
``logw >= 0`` (``wkv.py:334-339``, ``:387-390``).

The kernels read the ``[b, l, h, d]`` layout as it is: where the Pallas
wrapper transposes to ``[b, h, l, d]`` for the TPU's blocks
(``wkv.py:516-520``), a CUDA block computes its own strides. CPU tensors
take the plain version; CUDA tensors launch the kernels or raise. The
kernels take d = 64 or 128, the ``d % 64 == 0 and d <= 128`` of the JAX
route.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["wkv_fwd", "wkv_bwd", "wkv_reference", "bwd_chunk", "launches",
           "bwd_launches"]

#: forward calls (two kernel launches each) since the count was last set
#: to 0
launches = 0
#: backward calls (two kernel launches each) since the count was last set
#: to 0
bwd_launches = 0



# ------------------------------------------------------------ plain version
def wkv_reference(r, k, v, logw, u, chunk: int = 32, subchunk: int = 16):
    """The plain version: the chunked form of
    ``paddle_tpu/ops/fused/rwkv.py:109-186`` in f32 (decay cube on the
    diagonal sub-blocks, factored non-positive exponents off them, state
    readout and update between chunks), y cast to r's dtype.
    Differentiable."""
    b, l, h, d = r.shape
    c = min(chunk, l)
    pad = (-l) % c
    rf, kf, vf = (t.float() for t in (r, k, v))
    if pad:
        rf, kf, vf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                      for t in (rf, kf, vf))
    lp = l + pad
    nc = lp // c
    c0 = min(subchunk, c)
    if c % c0:
        c0 = c
    nb = c // c0
    uf = u.float()
    # min(logw, 0) with no gradient where logw >= 0, as the kernels clamp
    lw = torch.where(logw < 0, logw.float(), 0.0)             # [h, d]
    dev = r.device
    j = torch.arange(c, device=dev, dtype=torch.float32)
    jb = torch.arange(c0, device=dev, dtype=torch.float32)
    p = jb[:, None] - 1 - jb[None, :]                         # [c0, c0]
    seg = p[None, :, :, None] * lw[:, None, None, :]
    seg = torch.where((p >= 0)[None, :, :, None], seg,
                      torch.full_like(seg, -1e30))
    cube0 = torch.exp(seg)                                    # [h, c0, c0, d]
    w_r = torch.exp(jb[:, None, None] * lw[None])             # [c0, h, d]
    w_k = torch.exp((c0 - 1 - jb)[:, None, None] * lw[None])
    w_blk = torch.exp(c0 * lw)                                # [h, d]
    w_j = torch.exp(j[:, None, None] * lw[None])              # [c, h, d]
    w_out = torch.exp((c - 1 - j)[:, None, None] * lw[None])
    w_c = torch.exp(c * lw)

    def intra(rc, kc, vc):
        rb = rc.reshape(b, nb, c0, h, d)
        kb = kc.reshape(b, nb, c0, h, d)
        vb = vc.reshape(b, nb, c0, h, d)
        A = torch.einsum("bnjhd,bnihd,hjid->bnhji", rb, kb, cube0)
        out_b = torch.einsum("bnhji,bnihd->bnjhd", A, vb)
        r2 = rb * w_r
        kl = kb * w_k
        for lag in range(nb - 1):
            if lag > 0:
                kl = kl * w_blk
            Aoff = torch.einsum("bnjhd,bnihd->bnhji", r2[:, lag + 1:],
                                kl[:, :nb - 1 - lag])
            add = torch.einsum("bnhji,bnihd->bnjhd", Aoff,
                               vb[:, :nb - 1 - lag])
            out_b = out_b + torch.nn.functional.pad(
                add, (0, 0, 0, 0, 0, 0, lag + 1, 0))
        return out_b.reshape(b, c, h, d)

    S = torch.zeros(b, h, d, d, dtype=torch.float32, device=dev)
    outs = []
    for ci in range(nc):
        rc, kc, vc = (t[:, ci * c:(ci + 1) * c] for t in (rf, kf, vf))
        out = intra(rc, kc, vc)
        ru_k = torch.einsum("bjhd,bjhd->bjh", rc * uf, kc)
        out = out + ru_k[..., None] * vc
        out = out + torch.einsum("bjhk,bhkv->bjhv", rc * w_j, S)
        S = w_c[..., None] * S + torch.einsum("bihk,bihv->bhkv",
                                              kc * w_out, vc)
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :l].to(r.dtype)


# ------------------------------------------------------------------ wrappers
def _shapes(what, r, k, v, logw, u):
    if r.dim() != 4:
        raise ValueError(f"{what}: r must be [b, l, h, d], got "
                         f"{tuple(r.shape)}")
    b, l, h, d = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != (h, d) \
            or u.shape != (h, d):
        raise ValueError(f"{what}: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, logw {tuple(logw.shape)} and u "
                         f"{tuple(u.shape)} disagree")
    return b, l, h, d


def _check_head_dim(what, d):
    if d not in (64, 128):
        raise NotImplementedError(
            f"{what}: the kernel takes head_dim 64 or 128 (the JAX route's "
            f"d % 64 == 0 and d <= 128), got {d}")


def wkv_fwd(r, k, v, logw, u):
    """y ``[b, l, h, d]`` in r's dtype. On CUDA tensors one call launches
    two kernels (the state at every chunk's edge into scratch of ``[b, nc,
    h, d, d]`` in the I/O type, allocated per call, then every chunk in
    parallel); on CPU tensors the plain version."""
    global launches
    what = "wkv"
    b, l, h, d = _shapes(what, r, k, v, logw, u)
    if _build.device_of(what, r, k, v, logw, u) == "cpu":
        with torch.no_grad():
            return wkv_reference(r, k, v, logw, u)
    _check_head_dim(what, d)
    dt, (rk, kk, vk) = _build.float_io(what, r, k, v)
    lw, uf = (t.float().contiguous() for t in (logw, u))
    nc = -(-l // bwd_chunk(d))
    y = torch.empty((b, l, h, d), dtype=dt, device=r.device)
    s_in = torch.empty((b, nc, h, d, d), dtype=dt, device=r.device)
    rc = _build.entry("wkv", "ptt_wkv_fwd", 7, 5)(
        rk.data_ptr(), kk.data_ptr(), vk.data_ptr(), lw.data_ptr(),
        uf.data_ptr(), y.data_ptr(), s_in.data_ptr(), b, l, h, d,
        int(dt == torch.bfloat16), _build.stream(r))
    _build.check(_build.load("wkv"), rc, what)
    launches += 1
    return y.to(r.dtype)


_CHUNK = {}


def bwd_chunk(d: int) -> int:
    """The kernels' chunk at head width d (64 at d = 64, 32 at d = 128), as
    the library reports it."""
    c = _CHUNK.get(d)
    if c is None:
        c = _CHUNK[d] = int(_build.load("wkv").ptt_wkv_bwd_chunk(d))
    return c


def wkv_bwd(r, k, v, logw, u, dy):
    """``(dr, dk, dv, dlogw, du)`` of :func:`wkv_fwd` for the cotangent
    ``dy``, each in its input's dtype. On CUDA tensors one call launches two
    kernels (the state and its gradient at every chunk's edges, then every
    chunk in parallel) and sums their per-chunk dlogw and du partials; on
    CPU tensors the gradient of the plain version."""
    global bwd_launches
    what = "wkv backward"
    b, l, h, d = _shapes(what, r, k, v, logw, u)
    if dy.shape != r.shape:
        raise ValueError(f"{what}: dy {tuple(dy.shape)} is not "
                         f"{tuple(r.shape)}")
    if _build.device_of(what, r, k, v, logw, u, dy) == "cpu":
        ins = [t.detach().requires_grad_() for t in (r, k, v, logw, u)]
        with torch.enable_grad():
            y = wkv_reference(*ins)
            return torch.autograd.grad(y, ins, dy)
    _check_head_dim(what, d)
    dt, (rk, kk, vk, dyk) = _build.float_io(what, r, k, v, dy)
    lw, uf = (t.float().contiguous() for t in (logw, u))
    dev = r.device
    nc = -(-l // bwd_chunk(d))
    dr, dk, dv = (torch.empty((b, l, h, d), dtype=dt, device=dev)
                  for _ in range(3))
    # dlogw and du partials side by side (one sum); S_in and dS_out scratch
    # in the I/O type, the type the chunk kernel's products take them in,
    # and in bf16 their rounding remainders beside them
    bf16 = dt == torch.bfloat16
    parts = torch.empty((2, b * nc, h, d), dtype=torch.float32, device=dev)
    scratch = torch.empty((4 if bf16 else 2, b, nc, h, d, d), dtype=dt,
                          device=dev)
    lo = [scratch[i].data_ptr() if bf16 else None for i in (2, 3)]
    rc = _build.entry("wkv", "ptt_wkv_bwd", 15, 5)(
        rk.data_ptr(), kk.data_ptr(), vk.data_ptr(), lw.data_ptr(),
        uf.data_ptr(), dyk.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), *lo, b, l, h, d,
        int(bf16), _build.stream(r))
    _build.check(_build.load("wkv"), rc, what)
    bwd_launches += 1
    dlw, du = parts.sum(1)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlw.to(logw.dtype), du.to(u.dtype))
