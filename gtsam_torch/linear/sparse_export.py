"""Sparse-matrix export of the linearized system (SciPy CSR).

Counterpart of gtsam_tpu/linear/sparse_export.py (reference
gtsam/linear/SparseEigen.h sparseJacobianEigen,
GaussianFactorGraph::sparseJacobian_): a host-side interop surface on the
whitened per-batch blocks of the generic linearization, not a compute path
(the solvers take the batched blocks on the device).
"""

import numpy as np


def sparse_jacobian(bound, arrays):
    """Whitened sparse Jacobian of the bound graph at `arrays`.

    Returns (A, b): A a scipy.sparse CSR matrix (total_rows, D) stacking
    every factor's whitened Jacobian rows in batch order; b the
    (total_rows,) stacked whitened rhs (convention ||A dx - b||^2)."""
    import scipy.sparse as sp

    D = bound.layout.total_dim
    rows_l, cols_l, vals_l, b_l = [], [], [], []
    row0 = 0
    for bi, (bt, st) in enumerate(zip(bound.graph.batches,
                                      bound.structures)):
        if bt.sign < 0:
            # negative information (anti-factors) has no real Jacobian rows:
            # A^T A would flip the sign back to +J'J
            raise NotImplementedError(
                "sparse_jacobian cannot represent anti-factor batches "
                f"(batch {bt.name!r} has sign {bt.sign}); negative "
                "information has no real square root")
        wJ, bvec = bound.linearize_batch(bi, arrays)
        bvec = bvec.detach().cpu().numpy()
        n, rdim = bvec.shape
        sgn = np.sqrt(abs(bt.sign)) * np.sign(bt.sign)
        frows = row0 + np.arange(n * rdim).reshape(n, rdim)
        for i, d in enumerate(bt.dims()):
            Ji = wJ[i].detach().cpu().numpy() * sgn        # (n, rdim, d_i)
            cidx = (np.asarray(st.col_offsets[i])[:, None, None]
                    + np.arange(d)[None, None, :])
            rows_l.append(np.broadcast_to(frows[:, :, None],
                                          Ji.shape).reshape(-1))
            cols_l.append(np.broadcast_to(cidx, Ji.shape).reshape(-1))
            vals_l.append(Ji.reshape(-1))
        b_l.append(bvec.reshape(-1) * sgn)
        row0 += n * rdim
    A = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l),
                                  np.concatenate(cols_l))),
        shape=(row0, D)).tocsr()
    return A, np.concatenate(b_l)


def sparse_hessian(bound, arrays):
    """The sparse normal-equations matrix H = A^T A and gradient g = A^T b
    (reference GaussianFactorGraph::hessian, sparse form)."""
    A, b = sparse_jacobian(bound, arrays)
    return (A.T @ A).tocsr(), A.T @ b
