"""The edges of the chunk-parallel SSM kernels on the CPU: the plain
versions (what the CUDA kernels are held to on the card) against the TPU
kernels in interpret mode. The selective-scan and SSD gradients against
``selective_scan.py``'s and ``ssd.py``'s ``_bwd_kernel``, the WKV gradients
against ``wkv.py``'s ``_bwd_kernel`` and the SSD forward's y and chunk
states against ``ssd.py``'s ``_fwd_kernel``: at one step, a sub-chunk or a
chunk less one, one, one more and two chunks and a bit, at widths off the
kernels' tiles (d = 100, n = 5, three heads; the WKV at d = 64 and 128),
with a decay strong enough that the decay is exactly 0 (and the WKV's
clamp of logw >= 0); and the wrappers' refusals of a residual of the wrong
shape, dtype or layout.

Tolerances, as max |diff| / max |ref| per tensor, f32: 2e-5 for the scan
and the WKV (the same recurrence summed in other orders, as
``test_torch_mamba.py`` and ``test_torch_rwkv.py`` hold them); 2e-4 for
the SSD (the Pallas kernel takes its chunk cumsum as a
triangular matmul and differences of it, the plain version a running sum:
the two round cum differently, ~1e-5 of the decays' exponents, as
``test_torch_mamba2.py`` holds the pair). The strong decay is a short
stretch (three steps of log a = -112 in the SSD, so that a_t = 0 while the
chunk's cumsum stays within ~340, where f32 keeps its differences to 3e-5):
at log a = -160 over a quarter of the sequence, the f32 plain version's own
dA lies 2.6e-4 of max |dA| from a float64 evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import selective_scan as jss
from paddle_tpu.ops.pallas import ssd as jpssd
from paddle_tpu.ops.pallas.wkv import wkv_pallas
from paddle_tpu_torch.ops.cuda import selective_scan as tss
from paddle_tpu_torch.ops.cuda import ssd as tssd
from paddle_tpu_torch.ops.cuda import wkv as twkv

torch.set_num_threads(2)

SCAN_TOL, SSD_TOL, WKV_TOL = 2e-5, 2e-4, 2e-5
LENGTHS = (1, 63, 64, 65, 130)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30))


def _vjps(jax_fn, torch_fn, args, dy):
    """``(jax grads, torch grads)`` of the same seeded f32 inputs."""
    xs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(jax.jit(jax_fn), *xs)
    jg = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tg = torch.autograd.grad(torch_fn(*ts), ts, torch.tensor(dy))
    return jg, [g.numpy() for g in tg]


def _scan_inputs(b, l, d, n, seed, strong):
    rs = np.random.RandomState(seed)
    u = rs.randn(b, l, d).astype(np.float32)
    delta = np.log1p(np.exp(rs.randn(b, l, d))).astype(np.float32)
    A = -(np.arange(1, n + 1, dtype=np.float32)[None]
          * rs.uniform(0.5, 1.5, (d, 1))).astype(np.float32)
    if strong:
        A[:3] = -1e4
        delta[:, l // 3:l // 2 + 1] = 20.0
    B = rs.randn(b, l, n).astype(np.float32)
    C = rs.randn(b, l, n).astype(np.float32)
    return [u, delta, A, B, C], rs.randn(b, l, d).astype(np.float32)


def _pallas_scan(chunk):
    """``selective_scan.py``'s custom-VJP core (the ``_fwd_kernel`` and
    ``_bwd_kernel`` pair, no D skip) on a sequence zero-padded to a multiple
    of ``chunk``, as its public wrapper pads it."""
    def fn(u, delta, A, B, C):
        l = u.shape[1]
        pad = ((0, 0), (0, (-l) % chunk), (0, 0))
        u, delta, B, C = (jnp.pad(t, pad) for t in (u, delta, B, C))
        return jss._selective_scan_pallas(u, delta, A, B, C, chunk,
                                          True)[:, :l]
    return fn


@pytest.mark.parametrize("l,strong", [(l, False) for l in LENGTHS]
                         + [(130, True)])
def test_scan_gradients_match_pallas_bwd_kernel(l, strong):
    """du, ddelta, dA, dB, dC of the plain scan against the Pallas backward
    kernel in interpret mode (chunk 16): b2 d100 n5, lengths 1, 63, 64, 65
    and 130 (chunk boundaries of both and ragged last chunks), and a strong
    decay (A = -1e4 on three channels, delta = 20 on a stretch)."""
    args, dy = _scan_inputs(2, l, 100, 5, seed=l + strong, strong=strong)
    jg, tg = _vjps(_pallas_scan(16), tss.selective_scan_reference, args, dy)
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC"), tg, jg):
        assert np.isfinite(a).all(), name
        assert _rel(a, b) <= SCAN_TOL, name


@pytest.mark.parametrize("l,n,strong", [(l, 5, False)
                                        for l in (1, 63, 64, 65, 150)]
                         + [(l, 16, True) for l in (1, 63, 64, 65, 150)])
def test_scan_forward_matches_pallas_fwd_kernel(l, n, strong):
    """y and the state entering every chunk of 64 steps of the plain scan
    (the forward kernel's oracle) against ``_fwd_kernel`` in interpret mode
    at chunk 64, on the sequence zero-padded to a multiple of it as its
    wrapper pads: b2 d100, lengths 1, 63, 64, 65 and 150, n = 5 and 16, and
    a strong decay (exp(delta A) = 0 on three channels over a stretch)."""
    args, _ = _scan_inputs(2, l, 100, n, seed=l + n, strong=strong)
    pad = ((0, 0), (0, (-l) % 64), (0, 0))
    u, delta, A, B, C = (jnp.asarray(a if a.ndim == 2 else np.pad(a, pad))
                         for a in args)
    jy, (*_, jbounds, _) = jss._scan_fwd(u, delta, A, B, C, 64, True)
    with torch.no_grad():
        ty, tbounds = tss.selective_scan_reference(
            *(torch.tensor(a) for a in args), tss.KERNEL_CHUNK,
            return_bounds=True)
    assert tuple(tbounds.shape) == jbounds.shape == (2, -(-l // 64), n, 100)
    assert np.isfinite(ty.numpy()).all()
    assert _rel(ty.numpy(), np.asarray(jy)[:, :l]) <= SCAN_TOL
    assert _rel(tbounds.numpy(), np.asarray(jbounds)) <= SCAN_TOL


def _ssd_inputs(b, l, h, dh, ds, seed, strong):
    rs = np.random.RandomState(seed)
    x = (0.5 * rs.randn(b, l, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, l, h))).astype(np.float32)
    A = (-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
    if strong:
        A[0] = -16.0
        dt[:, l // 3:l // 3 + 3] = 7.0
    B = (0.5 * rs.randn(b, l, ds)).astype(np.float32)
    C = (0.5 * rs.randn(b, l, ds)).astype(np.float32)
    D = rs.randn(h).astype(np.float32)
    return [x, dt, A, B, C, D], rs.randn(b, l, h, dh).astype(np.float32)


@pytest.mark.parametrize("l,ds,strong", [(l, 64, False) for l in LENGTHS]
                         + [(65, 128, False), (130, 64, True)])
def test_ssd_gradients_match_pallas_bwd_kernel(l, ds, strong):
    """dx, ddt, dA, dB, dC, dD of the plain chunked SSD at the kernels'
    chunk (64 at ds 64, 32 at ds 128) against ``ssd_pallas`` in interpret
    mode (chunk 32, its ``_bwd_kernel``): b2, three heads (off the
    backward's groups of twelve), lengths 1, 63, 64, 65 and 130, ds 128 at
    chunk 32, and a strong decay (a_t = 0 exactly on three steps)."""
    args, dy = _ssd_inputs(2, l, 3, 64, ds, seed=l + ds + strong,
                           strong=strong)
    chunk = tssd.kernel_chunk(64, ds)
    jg, tg = _vjps(lambda *a: jpssd.ssd_pallas(*a, chunk=32, interpret=True),
                   lambda *a: tssd.ssd_chunked_reference(*a, chunk), args,
                   dy)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), tg, jg):
        assert np.isfinite(a).all(), name
        assert _rel(a, b) <= SSD_TOL, name


def _wkv_inputs(b, l, h, d, seed):
    """r, k, v (0.5 x normals), logw from -0.02 to -20, three channels at
    the -1e10 floor (w = 0) and three at 0, 0.5 and 2 (clamped to w = 1,
    no dlogw), the bonus u and a cotangent."""
    rs = np.random.RandomState(seed)
    r, k, v = (0.5 * rs.randn(b, l, h, d).astype(np.float32)
               for _ in range(3))
    logw = -rs.uniform(0.02, 20.0, (h, d)).astype(np.float32)
    logw[0, :3] = -1e10
    logw[-1, 3:6] = [0.0, 0.5, 2.0]
    u = (0.3 * rs.randn(h, d)).astype(np.float32)
    return [r, k, v, logw, u], rs.randn(b, l, h, d).astype(np.float32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("l", [1, 17, 63, 64, 65, 130])
def test_wkv_gradients_match_pallas_bwd_kernel(l, d):
    """dr, dk, dv, dlogw, du of the plain WKV (the chunk-parallel
    backward's oracle) against ``wkv_pallas`` in interpret mode (chunk 32,
    sub-chunk 16: its ``_bwd_kernel``): b2, three heads, lengths 1, 17, 63,
    64, 65 and 130 (the sub-chunk's and both kernel chunks' edges), d = 64
    and 128, w = 0 on three channels and logw >= 0 on three, whose dlogw is
    exactly 0 in both."""
    args, dy = _wkv_inputs(2, l, 3, d, seed=l + d)
    jg, tg = _vjps(lambda *a: wkv_pallas(*a, chunk=32, subchunk=16,
                                         interpret=True),
                   twkv.wkv_reference, args, dy)
    for name, a, b in zip(("dr", "dk", "dv", "dlogw", "du"), tg, jg):
        assert np.isfinite(a).all(), name
        assert _rel(a, b) <= WKV_TOL, name
    assert (tg[3][-1, 3:6] == 0).all() and (jg[3][-1, 3:6] == 0).all()


@pytest.mark.parametrize("l,ds,strong", [(1, 64, True), (63, 64, True),
                                         (65, 64, True), (150, 64, True),
                                         (150, 128, False)])
def test_ssd_forward_matches_pallas_fwd_kernel(l, ds, strong):
    """y and the state entering every chunk of the plain chunked SSD at the
    kernels' chunk (64 at ds 64, 32 at ds 128) against ``ssd.py``'s
    ``_fwd_kernel`` in interpret mode at the same chunk (its y plus D x):
    b2, three heads, lengths 1, 63, 65 and 150, a strong decay (a_t = 0
    exactly on three steps)."""
    args, _ = _ssd_inputs(2, l, 3, 64, ds, seed=l + ds, strong=strong)
    x, dt, A, B, C, D = args
    chunk = tssd.kernel_chunk(64, ds)
    pad = (-l) % chunk
    zp = lambda t: np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
    jy, jstates = jpssd._run_fwd(
        jnp.asarray(zp(x).transpose(0, 2, 1, 3)),
        jnp.asarray(zp(dt).transpose(0, 2, 1)), jnp.asarray(zp(B)),
        jnp.asarray(zp(C)), jnp.asarray(A.reshape(-1, 1)), chunk, True)
    jy = np.asarray(jy).transpose(0, 2, 1, 3)[:, :l] + D[:, None] * x
    ty, tstates = tssd.ssd_chunked_reference(
        *(torch.tensor(a) for a in args), chunk, return_states=True)
    assert tuple(tstates.shape) == jstates.shape == (2, -(-l // chunk), 3,
                                                     64, ds)
    assert np.isfinite(ty.numpy()).all()
    assert _rel(ty.numpy(), jy) <= SSD_TOL
    assert _rel(tstates.numpy(), np.asarray(jstates)) <= SSD_TOL


def _scan_case():
    args, dy = _scan_inputs(2, 70, 12, 5, seed=0, strong=False)
    ins = [torch.tensor(a) for a in args]
    _, bounds = tss.selective_scan_fwd(*ins)
    return ins, bounds, torch.tensor(dy)


def _ssd_case():
    args, dy = _ssd_inputs(1, 70, 2, 64, 64, seed=0, strong=False)
    ins = [torch.tensor(a) for a in args]
    _, states = tssd.ssd_fwd(*ins)
    return ins, states, torch.tensor(dy)


@pytest.mark.parametrize("kind", ["scan", "ssd"])
@pytest.mark.parametrize("fault", ["shape", "dtype", "layout"])
def test_backward_refuses_a_foreign_residual(kind, fault):
    """The backward wrappers check the forward's residual (the scan's chunk
    states ``[b, ceil(l / 64), n, d]``, the SSD's ``[b, nc, h, dh, ds]``,
    contiguous f32) on every device before they use it: one more chunk,
    bf16 or a transposed view is a ValueError, and the residual as the
    forward returned it gives the plain version's gradients."""
    ins, res, dy = _scan_case() if kind == "scan" else _ssd_case()
    bwd = tss.selective_scan_bwd if kind == "scan" else tssd.ssd_bwd
    bad = {"shape": torch.cat([res, res[:, :1]], dim=1),
           "dtype": res.bfloat16(),
           "layout": res.transpose(-1, -2).contiguous().transpose(-1, -2)}
    with pytest.raises(ValueError, match="must be the forward's"):
        bwd(*ins, bad[fault], dy)
    grads = bwd(*ins, res, dy)
    assert len(grads) == len(ins)
    assert all(g.shape == t.shape for g, t in zip(grads, ins))


def test_rows_copies_what_vector_loads_cannot_read():
    """``_rows(align=16)``, which the SSD kernels' wrappers apply to x, B,
    C and dy: a strided view of the model's conv output (16-byte token stride
    and starts) passes as it is; a view starting 2 bytes in, or with a
    token stride of 1000 bytes, is copied to packed rows."""
    conv = torch.zeros(2, 9, 3 * 64 + 2 * 64, dtype=torch.bfloat16)
    x = conv[..., :192].unflatten(-1, (3, 64))
    B = conv[..., 192:256]
    for view in (x, B):
        out, stride = tssd._rows(view, torch.bfloat16, align=16)
        assert out.data_ptr() == view.data_ptr() and stride == 320
    flat = torch.zeros(2 * 9 * 500 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 9, 500)[..., :64]
    wide = flat[:-1].view(2, 9, 500)[..., :64]
    for view in (odd, wide):
        out, stride = tssd._rows(view, torch.bfloat16, align=16)
        assert out.is_contiguous() and stride == 64
        assert torch.equal(out, view)
    # without align (dt's scalar loads) both pass in place
    for view in (odd, wide):
        assert tssd._rows(view, torch.bfloat16)[0].data_ptr() \
            == view.data_ptr()

