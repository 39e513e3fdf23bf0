"""Symbolic block-Cholesky analysis (host side).

Counterpart of gtsam_tpu/inference/symbolic.py (reference EliminationTree.h:51,
JunctionTree.h:50): once per graph structure, the permuted block-column
fill pattern of L, the elimination tree and its height-based level
schedule, and the flat index arrays (blocks, update triples) grouped by
level that the level-scheduled solver (linear/sparse.py) runs.  Two columns
at the same height are never ancestor and descendant, so a level's columns
factor independently.  `analyze` takes the native C path (gtsam_torch/native,
whose build raises if it fails) or, with native=False, the Python one; both
give the same arrays.
"""

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from .. import native as native_mod


@dataclasses.dataclass
class SymbolicFactorization:
    """All indices refer to PERMUTED block columns (elimination order)."""

    n: int
    perm: np.ndarray           # (n,) perm[new] = old
    inv_perm: np.ndarray       # (n,) inv_perm[old] = new
    parent: np.ndarray         # (n,) etree parent (or -1)
    # block-sparse L storage: block b lives at (row[b], col[b]); includes
    # the diagonal
    block_row: np.ndarray      # (B,)
    block_col: np.ndarray      # (B,)
    block_of: Dict[Tuple[int, int], int]
    levels: List[np.ndarray]   # level -> columns (sorted)
    col_level: np.ndarray      # (n,) level of each column
    # update triples grouped by target column level: A[i,j] -= L[i,k] L[j,k]^T
    # as flat arrays of L-block ids (target_block, via_ik, via_jk)
    triples_by_level: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    diag_block_by_col: np.ndarray  # (n,) block id of (j, j)
    nnz_blocks: int


def analyze(adj: sp.csr_matrix, perm: np.ndarray,
            native: bool = True) -> SymbolicFactorization:
    n = adj.shape[0]
    perm = np.asarray(perm)
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)
    if native:
        return _analyze_native(adj, perm, inv_perm)

    # permuted adjacency lists (lower triangle: rows > col)
    A = (adj + adj.T).tocoo()
    nbr: List[set] = [set() for _ in range(n)]
    for i, j in zip(inv_perm[A.row], inv_perm[A.col]):
        if i > j:
            nbr[j].add(int(i))
        elif j > i:
            nbr[i].add(int(j))

    # symbolic elimination: struct[j] = rows below j in L's column j
    struct: List[set] = [set() for _ in range(n)]
    parent = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        s = set(nbr[j]) | struct[j]
        struct[j] = s
        if s:
            p = min(s)
            parent[j] = p
            struct[p] |= {x for x in s if x != p}

    # levels = height from the leaves (children precede their parents)
    col_level = np.zeros(n, dtype=np.int64)
    for j in range(n):
        p = parent[j]
        if p >= 0:
            col_level[p] = max(col_level[p], col_level[j] + 1)
    nlev = int(col_level.max()) + 1 if n else 0
    levels = [np.where(col_level == lv)[0] for lv in range(nlev)]

    # L block list: diagonal, then subdiagonal, column after column
    block_row, block_col = [], []
    block_of: Dict[Tuple[int, int], int] = {}
    for j in range(n):
        for i in [j] + sorted(struct[j]):
            block_of[(i, j)] = len(block_row)
            block_row.append(i)
            block_col.append(j)

    # update triples: for column k with rows S_k, every (i, j), i >= j, both
    # in S_k: A[i,j] -= L[i,k] L[j,k]^T, grouped by the level of j
    tr = [([], [], []) for _ in range(nlev)]
    for k in range(n):
        S = sorted(struct[k])
        for a, j in enumerate(S):
            t_target, t_ik, t_jk = tr[int(col_level[j])]
            bjk = block_of[(j, k)]
            for i in S[a:]:
                t_target.append(block_of[(i, j)])
                t_ik.append(block_of[(i, k)])
                t_jk.append(bjk)
    triples_by_level = [tuple(np.asarray(x, dtype=np.int32) for x in t)
                        for t in tr]
    diag_block_by_col = np.asarray([block_of[(j, j)] for j in range(n)],
                                   dtype=np.int32)
    return SymbolicFactorization(
        n=n, perm=perm, inv_perm=inv_perm, parent=parent,
        block_row=np.asarray(block_row, dtype=np.int32),
        block_col=np.asarray(block_col, dtype=np.int32),
        block_of=block_of, levels=levels, col_level=col_level,
        triples_by_level=triples_by_level,
        diag_block_by_col=diag_block_by_col, nnz_blocks=len(block_row))


def _analyze_native(adj: sp.csr_matrix, perm: np.ndarray,
                    inv_perm: np.ndarray) -> SymbolicFactorization:
    """The C path (gtsam_torch/native): the same output as the Python one."""
    n = adj.shape[0]
    A = (adj + adj.T).tocoo()
    pi = inv_perm[A.row]
    pj = inv_perm[A.col]
    lower = pi > pj
    rows_l, cols_l = pi[lower].astype(np.int32), pj[lower].astype(np.int32)
    # CSR by column, sorted rows, deduplicated
    order = np.lexsort((rows_l, cols_l))
    rows_l, cols_l = rows_l[order], cols_l[order]
    if len(rows_l):
        keep = np.concatenate([[True], (np.diff(cols_l.astype(np.int64) * n
                                                + rows_l) != 0)])
        rows_l, cols_l = rows_l[keep], cols_l[keep]
    counts = np.bincount(cols_l, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    parent, level, struct_indptr, struct_rows = native_mod.symbolic_analyze(
        n, indptr, rows_l)
    m = np.diff(struct_indptr)
    base = np.concatenate([[0], np.cumsum(1 + m)]).astype(np.int64)
    dblock = base[:-1].astype(np.int32)
    sub_base = (base[:-1] + 1).astype(np.int64)
    nnz = int(base[-1])
    block_row = np.empty(nnz, dtype=np.int32)
    block_col = np.empty(nnz, dtype=np.int32)
    cols = np.arange(n, dtype=np.int32)
    block_row[dblock] = cols
    block_col[dblock] = cols
    sub_mask = np.ones(nnz, dtype=bool)
    sub_mask[dblock] = False
    block_row[sub_mask] = struct_rows
    block_col[sub_mask] = np.repeat(cols, m)
    tt, tik, tjk, tlev = native_mod.emit_triples(
        n, struct_indptr, struct_rows, sub_base, dblock,
        level.astype(np.int32))
    nlev = int(level.max()) + 1 if n else 0
    levels = [np.where(level == lv)[0] for lv in range(nlev)]
    torder = np.argsort(tlev, kind="stable")
    tt, tik, tjk, tlev = tt[torder], tik[torder], tjk[torder], tlev[torder]
    bounds = np.searchsorted(tlev, np.arange(nlev + 1))
    triples_by_level = [
        (tt[bounds[lv]:bounds[lv + 1]], tik[bounds[lv]:bounds[lv + 1]],
         tjk[bounds[lv]:bounds[lv + 1]]) for lv in range(nlev)]
    block_of = {(int(r), int(c)): bid
                for bid, (r, c) in enumerate(zip(block_row, block_col))}
    return SymbolicFactorization(
        n=n, perm=perm, inv_perm=inv_perm,
        parent=parent.astype(np.int64),
        block_row=block_row, block_col=block_col, block_of=block_of,
        levels=levels, col_level=level.astype(np.int64),
        triples_by_level=triples_by_level,
        diag_block_by_col=dblock, nnz_blocks=nnz)
