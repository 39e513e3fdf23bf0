"""Parity of gtsam_torch's blocked dense Cholesky with gtsam_tpu's (CPU).

The torch side runs the plain PyTorch versions of kernels 10 and 11, which
is what gtsam_torch.linear.dense_blocked computes on CPU tensors; the JAX
side is gtsam_tpu.linear.dense_blocked (float64 with x64, which
tests/conftest.py turns on, or float32).  Inputs are SPD matrices made with
numpy from seeds, larger than the JAX package's 256-wide panel and not a
multiple of the port's 128, one of them past the port's 1024-column
super-panel.  Tolerances, relative to the largest entry of
the reference: 1e-12 in float64 (two blocked orders of the same sums on
matrices of condition ~5, and each panel inverse against numpy's inverse of
its block); 1e-5 in float32 (a few f32 roundings of each entry, amplified
by that condition number).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_torch.linear import dense_blocked, dense_kernels
from gtsam_tpu.linear import dense_blocked as jdense

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spd(n, seed):
    """D^-1/2 (A A^T / n + I) D^-1/2: unit diagonal, condition ~5."""
    A = np.random.default_rng(seed).normal(size=(n, n))
    S = A @ A.T / n + np.eye(n)
    d = 1.0 / np.sqrt(np.diag(S))
    return d[:, None] * S * d[None, :]


def _close(got, ref, tol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("n", [300, 601, 1100])
def test_blocked_cholesky_and_solve_match_jax(n, dtype):
    """The factor, each panel's stored inverse and the solve, against the
    JAX package's blocked_cholesky / blocked_cho_solve (panel 256) and
    numpy's inverse of each diagonal block."""
    Sn = _spd(n, n)
    b = np.random.default_rng(n + 1).normal(size=n)
    tol = TOL[dtype]
    L, Dinv, info = dense_blocked.blocked_cholesky(
        torch.tensor(Sn, dtype=dtype))
    assert int(info) == 0
    assert Dinv.shape == (dense_kernels.panels(n), 128, 128)
    jL = np.asarray(jdense.blocked_cholesky(jnp.asarray(Sn, JDT[dtype])))
    _close(L.tril(), jL, tol)
    Lf = L.tril().double().numpy()
    for k in range(dense_kernels.panels(n)):
        o, w = 128 * k, min(128, n - 128 * k)
        blk = Lf[o:o + w, o:o + w]
        _close(Dinv[k, :w, :w], np.linalg.inv(blk), tol)
        if w < 128:                               # the identity past w
            _close(Dinv[k, w:], np.eye(128)[w:], 0.0)
        _close(Dinv[k].triu(1), np.zeros((128, 128)), 0.0)
    x = dense_blocked.blocked_cho_solve(L, Dinv,
                                        torch.as_tensor(b, dtype=dtype))
    jx = np.asarray(jdense.blocked_cho_solve(jnp.asarray(jL),
                                             jnp.asarray(b, JDT[dtype])))
    _close(x, jx, 10 * tol)
    _close(x, np.linalg.solve(Sn, b), 10 * tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_failure_flag_where_jax_gives_nan(dtype):
    """An indefinite S: the port reports the first failing column + 1 in a
    device flag (read once by the caller, which rejects the LM try); the JAX
    package returns a factor with NaN in it instead.  This is the documented
    divergence of linear/dense_blocked.py."""
    Sn = _spd(300, 7)
    Sn[200, 200] = -1.0
    _, _, info = dense_blocked.blocked_cholesky(torch.tensor(Sn, dtype=dtype))
    assert info.dtype == torch.int32 and info.dim() == 0
    assert int(info) == 201
    jL = np.asarray(jdense.blocked_cholesky(jnp.asarray(Sn, JDT[dtype])))
    assert np.isnan(jL).any()


def test_upper_triangle_is_never_read():
    """The factorization reads only S's lower triangle: NaN above the
    diagonal leaves the factor, its inverses and the solve unchanged."""
    Sn = _spd(1100, 3)
    ref = dense_blocked.blocked_cholesky(torch.tensor(Sn))
    Sn[np.triu_indices(1100, 1)] = np.nan
    got = dense_blocked.blocked_cholesky(torch.tensor(Sn))
    assert torch.equal(got[0].tril(), ref[0].tril())
    assert torch.equal(got[1], ref[1]) and int(got[2]) == 0
    b = torch.as_tensor(np.random.default_rng(4).normal(size=1100))
    assert torch.equal(dense_blocked.blocked_cho_solve(got[0], got[1], b),
                       dense_blocked.blocked_cho_solve(ref[0], ref[1], b))


def test_row_strided_matrix_gives_the_same_bits():
    """S allocated with _kernels.row_strided (rows 256-byte aligned, the
    layout BA's buffers use) factors and solves to the same bits as a
    contiguous S."""
    from gtsam_torch import _kernels
    Sn = _spd(301, 9)
    S = _kernels.row_strided(301, torch.float64, "cpu")
    assert S.stride() == (320, 1)
    S.copy_(torch.tensor(Sn))
    got = dense_blocked.blocked_cholesky(S)
    ref = dense_blocked.blocked_cholesky(torch.tensor(Sn))
    assert torch.equal(got[0].tril(), ref[0].tril())
    assert torch.equal(got[1], ref[1])
    b = torch.as_tensor(np.random.default_rng(10).normal(size=301))
    assert torch.equal(dense_blocked.blocked_cho_solve(got[0], got[1], b),
                       dense_blocked.blocked_cho_solve(ref[0], ref[1], b))
