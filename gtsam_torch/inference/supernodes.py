"""Supernodal symbolic analysis: amalgamated cliques and their level schedule
(host side).

Counterpart of gtsam_tpu/inference/supernodes.py, with the same structure,
levels and block store for the same ordering.  The reference merges
eliminated columns into cliques when it builds the junction tree
(gtsam/inference/JunctionTree.h:50).  Computed here:

  - elimination tree + postordering (so supernodes are contiguous columns)
  - fundamental supernodes + CHOLMOD-style relaxed amalgamation (merge a child
    clique into its parent when the extra fill stays below a threshold)
  - the assembly-tree LEVEL SCHEDULE: supernodes at the same height are
    independent, so each level is factorized as a batch of dense fronts
    (linear/supernodal.py)

The symbolic factor comes from the native C code (gtsam_torch/native); the
JAX package's Python fallback for it is not carried over.
"""

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from .. import native


@dataclasses.dataclass
class SupernodalSymbolic:
    """All column/row indices refer to PERMUTED columns (elimination order).

    perm already includes the etree postordering (perm[new] = old var id).
    """

    n: int
    perm: np.ndarray
    inv_perm: np.ndarray
    nsuper: int
    snode_of: np.ndarray          # (n,) supernode of each column
    snode_start: np.ndarray       # (nsuper,) first column
    snode_width: np.ndarray       # (nsuper,) number of columns
    snode_rows: List[np.ndarray]  # per snode: row structure below its columns
    snode_parent: np.ndarray      # (nsuper,) assembly-tree parent (-1 root)
    snode_level: np.ndarray       # (nsuper,) height from leaves
    levels: List[np.ndarray]      # level -> snode ids
    # block-sparse L storage (block = one variable pair, padded dim d):
    block_row: np.ndarray
    block_col: np.ndarray
    block_of: Dict[Tuple[int, int], int]
    diag_block_by_col: np.ndarray
    nnz_blocks: int


def _column_structs(adj: sp.csr_matrix, perm: np.ndarray):
    """(parent, struct_indptr, struct_rows) of the permuted symbolic
    factor."""
    n = adj.shape[0]
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[np.asarray(perm)] = np.arange(n)
    A = (adj + adj.T).tocoo()
    pi = inv_perm[A.row]
    pj = inv_perm[A.col]
    lower = pi > pj
    rows_l = pi[lower].astype(np.int32)
    cols_l = pj[lower].astype(np.int32)
    order = np.lexsort((rows_l, cols_l))
    rows_l, cols_l = rows_l[order], cols_l[order]
    if len(rows_l):
        keep = np.concatenate([[True], (np.diff(cols_l.astype(np.int64) * n
                                                + rows_l) != 0)])
        rows_l, cols_l = rows_l[keep], cols_l[keep]
    counts = np.bincount(cols_l, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    parent, _level, s_indptr, s_rows = native.symbolic_analyze(n, indptr,
                                                               rows_l)
    return parent.astype(np.int64), s_indptr, s_rows


def _etree_postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the elimination forest (children before parents).

    Returns post[new] = old column, i.e. a permutation to compose."""
    n = len(parent)
    # children lists
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    roots = []
    for j in range(n - 1, -1, -1):   # reversed so children pop in order
        p = parent[j]
        if p < 0:
            roots.append(j)
        else:
            nxt[j] = head[p]
            head[p] = j
    post = np.empty(n, dtype=np.int64)
    k = 0
    stack = list(reversed(roots))
    state = np.zeros(n, dtype=np.int8)
    while stack:
        j = stack.pop()
        if state[j]:
            post[k] = j
            k += 1
            continue
        state[j] = 1
        stack.append(j)
        c = head[j]
        cs = []
        while c >= 0:
            cs.append(c)
            c = nxt[c]
        stack.extend(reversed(cs))
    assert k == n
    return post


def analyze_supernodal(
    adj: sp.csr_matrix,
    perm: np.ndarray,
    relax_tau: float = 0.3,
    force_width: int = 16,
    max_width: int = 64,
    barrier: int = None,
) -> SupernodalSymbolic:
    """Full supernodal analysis pipeline.

    relax_tau: max fraction of explicit zeros introduced by a merge
    force_width: always merge child+parent when the merged width <= this
    max_width: never exceed this supernode width (bounds the padded front)
    barrier: permuted-column index that no supernode may span — used for
      partial elimination (e.g. interior columns < barrier eliminated,
      separator columns >= barrier kept; NestedDissection-inl.h analog)
    """
    n = adj.shape[0]
    perm = np.asarray(perm, dtype=np.int64)
    # pass 1: etree under the fill-reducing ordering -> postorder
    parent0, _, _ = _column_structs(adj, perm)
    post = _etree_postorder(parent0)
    if barrier is not None:
        # stable-partition the postorder so pre-barrier (interior) columns
        # stay contiguous before post-barrier (separator) ones; children-
        # before-parents is preserved because separators are only ever
        # ancestors of interiors under a separator-last ordering
        post = np.concatenate([post[post < barrier], post[post >= barrier]])
    perm2 = perm[post]
    # pass 2: full structure under the postordered permutation
    parent, s_indptr, s_rows = _column_structs(adj, perm2)
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm2] = np.arange(n)
    colcount = np.diff(s_indptr)

    # -- fundamental supernodes ---------------------------------------------
    snode_of = np.empty(n, dtype=np.int64)
    starts = []
    for j in range(n):
        if (j > 0 and parent[j - 1] == j
                and colcount[j - 1] == colcount[j] + 1
                and (j - starts[-1]) < max_width
                and (barrier is None or j != barrier)):
            snode_of[j] = len(starts) - 1
        else:
            starts.append(j)
            snode_of[j] = len(starts) - 1
    starts.append(n)
    starts = np.asarray(starts, dtype=np.int64)

    # snode row structure = struct of FIRST column minus its own columns
    def rows_of(s0, s1):
        rs = s_rows[s_indptr[s0]:s_indptr[s0 + 1]]
        return rs[rs >= s1].astype(np.int64)

    ns = len(starts) - 1
    widths = np.diff(starts)
    rows = [rows_of(starts[s], starts[s + 1]) for s in range(ns)]

    # -- relaxed amalgamation -----------------------------------------------
    # merge snode s into s+1 when the assembly parent of s IS s+1 (the first
    # row of s's structure falls inside s+1's columns) and fill stays cheap.
    # Iterate until fixpoint; merged snodes keep contiguous column ranges.
    alive = np.ones(ns, dtype=bool)
    start_of = starts[:-1].copy()
    end_of = starts[1:].copy()

    def nnz_of(w, r):
        return w * (w + 1) // 2 + w * r

    changed = True
    while changed:
        changed = False
        ids = np.where(alive)[0]
        for k in range(len(ids) - 2, -1, -1):
            s, t = ids[k], ids[k + 1]
            if not (alive[s] and alive[t]):
                continue
            rs = rows[s]
            if len(rs) == 0 or not (start_of[t] <= rs[0] < end_of[t]):
                continue  # assembly parent is not the next snode
            ws = end_of[s] - start_of[s]
            wt = end_of[t] - start_of[t]
            wm = ws + wt
            if wm > max_width:
                continue
            if barrier is not None and start_of[s] < barrier < end_of[t]:
                continue   # never amalgamate across the elimination barrier
            rm = np.union1d(rs[rs >= end_of[t]], rows[t])
            extra = (nnz_of(wm, len(rm))
                     - nnz_of(ws, len(rs)) - nnz_of(wt, len(rows[t])))
            nnzm = nnz_of(wm, len(rm))
            if wm <= force_width or (nnzm > 0 and extra / nnzm <= relax_tau):
                # merge s into t
                start_of[t] = start_of[s]
                rows[t] = rm
                alive[s] = False
                changed = True

    keep = np.where(alive)[0]
    nsuper = len(keep)
    snode_start = start_of[keep]
    snode_width = (end_of[keep] - start_of[keep]).astype(np.int64)
    snode_rows = [rows[s] for s in keep]
    snode_of = np.repeat(np.arange(nsuper), snode_width)

    # -- assembly tree + level schedule --------------------------------------
    snode_parent = np.full(nsuper, -1, dtype=np.int64)
    for s in range(nsuper):
        if len(snode_rows[s]):
            snode_parent[s] = snode_of[snode_rows[s][0]]
    snode_level = np.zeros(nsuper, dtype=np.int64)
    for s in range(nsuper):      # children always precede parents
        p = snode_parent[s]
        if p >= 0:
            snode_level[p] = max(snode_level[p], snode_level[s] + 1)
    nlev = int(snode_level.max()) + 1 if nsuper else 0
    levels = [np.where(snode_level == l)[0] for l in range(nlev)]

    # -- block store ----------------------------------------------------------
    # within-snode dense lower triangle + dense panel (rows x all columns)
    block_row_l, block_col_l = [], []
    block_of: Dict[Tuple[int, int], int] = {}
    for s in range(nsuper):
        c0, w = int(snode_start[s]), int(snode_width[s])
        for b in range(w):
            for a in range(b, w):
                block_of[(c0 + a, c0 + b)] = len(block_row_l)
                block_row_l.append(c0 + a)
                block_col_l.append(c0 + b)
        for r in snode_rows[s]:
            for b in range(w):
                block_of[(int(r), c0 + b)] = len(block_row_l)
                block_row_l.append(int(r))
                block_col_l.append(c0 + b)
    block_row = np.asarray(block_row_l, dtype=np.int32)
    block_col = np.asarray(block_col_l, dtype=np.int32)
    diag_block_by_col = np.asarray([block_of[(j, j)] for j in range(n)],
                                   dtype=np.int32)
    return SupernodalSymbolic(
        n=n, perm=perm2, inv_perm=inv_perm, nsuper=nsuper,
        snode_of=snode_of, snode_start=snode_start, snode_width=snode_width,
        snode_rows=snode_rows, snode_parent=snode_parent,
        snode_level=snode_level, levels=levels,
        block_row=block_row, block_col=block_col, block_of=block_of,
        diag_block_by_col=diag_block_by_col, nnz_blocks=len(block_row))
