"""The port's plain grouped GEMMs (``gmm_reference``, ``tgmm_reference``:
the oracles the card's wgmma kernels are held against) against the Pallas
kernels in interpret mode, at the edges the kernels' tiles meet.

Edges: group starts off every 8-, 16- and 64-row boundary, a group that
spans three of the Pallas kernel's 16-row tiles, one group holding every
row, every group empty, K and N multiples of 8 but not of 16, and NaN in
the trash rows. JAX's tgmm masks only lhs by row (``_tgmm_kernel``,
``paddle_tpu/ops/pallas/grouped_gemm.py:173``), so NaN in dout's trash rows
is undefined there (0 x NaN); the port's plain tgmm slices both operands,
so it must give its NaN-free result, and JAX's with NaN in lhs alone.

Tolerance: 2e-5, f32 in both, one product per element (as
``test_torch_moe.py``). Trash rows of gmm and empty groups of tgmm are
exact zeros on both sides.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import grouped_gemm as jgg
from paddle_tpu_torch.ops.cuda.grouped_gemm import (gmm_reference,
                                                    tgmm_reference)

torch.set_num_threads(2)

TOL = 2e-5
TM = 16                  # the Pallas kernels' row tile here

# name: (M, K, N, group sizes); rows past the sizes' sum are the trash group
CASES = {
    # starts at rows 3, 12, 70, 75: off every 8-, 16- and 64-row boundary;
    # the 58-row group spans rows 12-69, the 40-row one 75-114; 45 trash
    "offsets": (160, 32, 48, [3, 9, 58, 5, 40]),
    # rows 5-44: parts of three 16-row tiles
    "three_tiles": (64, 16, 32, [5, 40, 7]),
    "one_group": (96, 32, 16, [96]),
    "all_empty": (48, 16, 24, [0, 0, 0]),
    # K = 24, N = 40: multiples of 8, not of 16
    "odd_width": (80, 24, 40, [17, 0, 33, 1]),
}


def _inputs(name, seed):
    m, k, n, sizes = CASES[name]
    rng = np.random.RandomState(seed)
    g = len(sizes)
    return (m, k, n, np.asarray(sizes, np.int32),
            rng.randn(m, k).astype(np.float32),
            rng.randn(g, k, n).astype(np.float32),
            rng.randn(g, n).astype(np.float32),
            rng.randn(m, n).astype(np.float32))


@functools.partial(jax.jit, static_argnums=(4,))
def _jit_gmm(lhs, rhs, sizes, bias, transpose_rhs):
    return jgg.grouped_matmul(lhs, rhs, sizes, bias, transpose_rhs, TM, 512,
                              512, True)


@jax.jit
def _jit_tgmm(lhs, dout, sizes):
    return jgg.grouped_matmul_tgmm(lhs, dout, sizes, TM, 512, 512, True)


def _jax_gmm(lhs, rhs, sizes, bias, transpose_rhs):
    return np.asarray(_jit_gmm(lhs, rhs, sizes, bias, transpose_rhs),
                      np.float32)


def _jax_tgmm(lhs, dout, sizes):
    return np.asarray(_jit_tgmm(lhs, dout, sizes), np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _gmm_args(name, seed, transpose_rhs, with_bias):
    """lhs, rhs, bias of one orientation: ``transpose_rhs`` contracts the
    ``[G, K, N]`` weight's last axis, so lhs is ``[M, N]`` and bias
    ``[G, K]``."""
    m, k, n, sizes, x, w, b, dout = _inputs(name, seed)
    lhs = dout if transpose_rhs else x
    bias = (np.ascontiguousarray(w[:, :, 0]) if transpose_rhs else b) \
        if with_bias else None
    return m, sizes, lhs, w, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_gmm_reference_matches_pallas(name, transpose_rhs, with_bias):
    """The plain gmm against the interpret-mode Pallas gmm; the trash rows
    (and every row when all groups are empty) exact zeros on both sides."""
    m, sizes, lhs, w, bias = _gmm_args(name, 11, transpose_rhs, with_bias)
    ref = _jax_gmm(lhs, w, sizes, bias, transpose_rhs)
    out = gmm_reference(_t(lhs), _t(w), _t(sizes), _t(bias),
                        transpose_rhs).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    kept = int(sizes.sum())
    assert (out[kept:] == 0).all() and (ref[kept:] == 0).all()


@pytest.mark.parametrize("name", list(CASES))
def test_tgmm_reference_matches_pallas(name):
    """The plain tgmm against the interpret-mode Pallas tgmm; an empty
    group's dW exact zeros on both sides."""
    m, k, n, sizes, x, _, _, dout = _inputs(name, 12)
    ref = _jax_tgmm(x, dout, sizes)
    out = tgmm_reference(_t(x), _t(dout), _t(sizes)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    for g in np.flatnonzero(sizes == 0):
        assert (out[g] == 0).all() and (ref[g] == 0).all()


def _poison(a, kept):
    a = a.copy()
    a[kept::2] = np.nan
    a[kept + 1::2] = np.inf
    return a


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_gmm_nan_trash_rows_stay_zero(transpose_rhs):
    """NaN and inf in lhs's trash rows: the kept rows as without them, the
    trash rows exact zeros, in the port and in JAX."""
    m, sizes, lhs, w, bias = _gmm_args("offsets", 13, transpose_rhs, True)
    kept = int(sizes.sum())
    bad = _poison(lhs, kept)
    ref = _jax_gmm(bad, w, sizes, bias, transpose_rhs)
    out = gmm_reference(_t(bad), _t(w), _t(sizes), _t(bias),
                        transpose_rhs).numpy()
    clean = gmm_reference(_t(lhs), _t(w), _t(sizes), _t(bias),
                          transpose_rhs).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out, clean)
    assert (out[kept:] == 0).all() and (ref[kept:] == 0).all()


@pytest.mark.parametrize("name", ["offsets", "odd_width"])
def test_tgmm_nan_trash_rows_take_no_part(name):
    """NaN and inf in the trash rows of lhs and dout: the port's plain tgmm
    gives its NaN-free result, which equals JAX's with NaN in lhs alone (JAX
    masks lhs only)."""
    m, k, n, sizes, x, _, _, dout = _inputs(name, 14)
    kept = int(sizes.sum())
    bad_x, bad_dout = _poison(x, kept), _poison(dout, kept)
    out = tgmm_reference(_t(bad_x), _t(bad_dout), _t(sizes)).numpy()
    np.testing.assert_array_equal(
        out, tgmm_reference(_t(x), _t(dout), _t(sizes)).numpy())
    np.testing.assert_allclose(out, _jax_tgmm(bad_x, dout, sizes), rtol=TOL,
                               atol=TOL)
    assert np.isfinite(out).all()
