"""Fill-reducing variable orderings (host side).

Counterpart of gtsam_tpu/inference/ordering.py: the same permutations from
the same C code (gtsam_torch/native) and the same Python nested dissection
by BFS.  The JAX package falls back to SuperLU's MMD or to Python when its
native library is missing; the port raises instead (native/__init__.py).
Reference: gtsam/inference/Ordering.h:41.
"""

from typing import Sequence

import numpy as np
import scipy.sparse as sp

from .. import native


def adjacency_from_factors(factor_keys: Sequence[np.ndarray],
                           n: int) -> sp.csr_matrix:
    """Variable adjacency (n x n, 0/1) from per-batch (N, arity) key-index
    arrays."""
    rows, cols = [], []
    for keys in factor_keys:
        keys = np.atleast_2d(keys)
        a = keys.shape[1]
        for i in range(a):
            for j in range(a):
                if i != j:
                    rows.append(keys[:, i])
                    cols.append(keys[:, j])
    if rows:
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        data = np.ones(len(rows), dtype=np.int8)
        A = sp.csr_matrix((data, (rows, cols)), shape=(n, n))
        A.data[:] = 1
    else:
        A = sp.csr_matrix((n, n), dtype=np.int8)
    return A


def minimum_degree(adj: sp.csr_matrix, constrained_last=None) -> np.ndarray:
    """Approximate minimum degree: perm[i] = original index eliminated i-th.
    `constrained_last` (bool mask) orders those variables last."""
    n = adj.shape[0]
    if n <= 1:
        return np.arange(n)
    As = ((adj + adj.T) > 0).astype(np.int8).tocsr()
    return native.amd_order(n, As.indptr, As.indices, constrained_last)


def natural(n: int) -> np.ndarray:
    return np.arange(n)


def nested_dissection(adj: sp.csr_matrix, leaf_size: int = 32,
                      method: str = "auto") -> np.ndarray:
    """METIS-class nested dissection: the native multilevel bisection, or
    with method="bfs" (and for n <= 2) single-level BFS bisection in Python
    with AMD leaves."""
    n_ = adj.shape[0]
    if n_ > 2 and method != "bfs":
        As_ = ((adj + adj.T) > 0).astype(np.int8).tocsr()
        return native.nd_order(n_, As_.indptr, As_.indices, leaf_size)
    from scipy.sparse.csgraph import breadth_first_order, connected_components

    A = ((adj + adj.T) > 0).astype(np.int8).tocsr()
    n = A.shape[0]
    order: list = []

    def local_order(nodes):
        if len(nodes) <= 1:
            order.extend(nodes.tolist())
            return
        sub = A[nodes][:, nodes]
        p = minimum_degree(sub)
        order.extend(nodes[p].tolist())

    def bfs_levels(sub, start):
        nodes_order, preds = breadth_first_order(sub, start, directed=False,
                                                 return_predecessors=True)
        lev = np.full(sub.shape[0], -1, dtype=np.int64)
        lev[start] = 0
        for v in nodes_order[1:]:
            lev[v] = lev[preds[v]] + 1
        return lev

    def rec(nodes):
        if len(nodes) <= leaf_size:
            local_order(nodes)
            return
        sub = A[nodes][:, nodes].tocsr()
        ncomp, labels = connected_components(sub, directed=False)
        if ncomp > 1:
            for c in range(ncomp):
                rec(nodes[labels == c])
            return
        # pseudo-peripheral start
        lev0 = bfs_levels(sub, 0)
        f1 = int(np.argmax(lev0))
        lev = bfs_levels(sub, f1)
        med = np.median(lev)
        in_a = lev <= med
        if in_a.all() or not in_a.any():
            local_order(nodes)
            return
        # separator: vertices of A adjacent to B
        indptr, indices = sub.indptr, sub.indices
        sep_mask = np.zeros(len(nodes), dtype=bool)
        for v in np.where(in_a)[0]:
            nbrs = indices[indptr[v]:indptr[v + 1]]
            if np.any(~in_a[nbrs]):
                sep_mask[v] = True
        part_a = np.where(in_a & ~sep_mask)[0]
        part_b = np.where(~in_a)[0]
        sep = np.where(sep_mask)[0]
        if len(part_a) == 0 or len(part_b) == 0:
            local_order(nodes)
            return
        rec(nodes[part_a])
        rec(nodes[part_b])
        order.extend(nodes[sep].tolist())  # separator eliminated last

    rec(np.arange(n))
    return np.asarray(order, dtype=np.int64)


def constrained_last(adj: sp.csr_matrix, last: Sequence[int]) -> np.ndarray:
    """The COLAMD-constrained analog (Ordering.h:112): the variables not in
    `last` by minimum degree, then `last` in sorted order."""
    n = adj.shape[0]
    last = np.asarray(sorted(set(int(x) for x in last)), dtype=np.int64)
    rest = np.setdiff1d(np.arange(n), last)
    if len(rest):
        rest = rest[minimum_degree(adj[rest][:, rest])]
    return np.concatenate([rest, last])
