"""Supernodal sparse block Cholesky: batched dense fronts per tree level.

Counterpart of gtsam_tpu/linear/supernodal.py (reference multifrontal
elimination, gtsam/inference/ClusterTree-inst.h:285).  The symbolic phase
(inference/supernodes.py) amalgamates columns into supernodes and levels
the assembly tree; the host plans built here from it equal the JAX
package's, array for array, and move to the device once (`to`).  Then:

  system:    kernel 6 linearizes the SE3 and SE2 between/prior batches
             (robust ones with their loss's IRLS weights) straight into
             a contribution buffer, a row a factor and slot pair, kernel
             17 the projection batches, a row a chunk of factors and
             target (the graph's ContributionPlan; other batches: the
             generic torch.func path), and pg_assemble sums it into the
             block store (B+1, d*d) and the gradient (n, d) through sorted
             CSRs;
  factorize: per level, kernel 7's front kernel gathers the fronts and
             panels from a working copy of the store (damping applied
             there), factors and inverts every front in one launch and
             leaves the inverses of its 32x32 diagonal tiles for kernel 8;
             then kernel 7's Schur update, one launch: the panel
             Lp = A L^-T = (L^-1 A^T)^T, U = Lp Lp^T's block-lower
             triangle and the scatter into the working store.  A level
             whose fronts fit one tile (the plan's route, `narrow`) takes
             kernel 7's narrow pair instead: one launch factors its fronts
             a warp each, forms their panels and sums their U blocks a row
             a (chunk, target) by the level's chunk plan
             (supernodal_kernels.narrow_plan), and one sums each target's
             rows and subtracts them; after the levels, kernel 7's pivot
             check (one launch);
  solve:     kernel 8, one launch forward over all levels (the lower
             levels' panel products gathered per column through a CSR)
             and one backward;
  matvec:    kernel 9, the refinement residual's (H + damping) x.

H's own blocks.  The store holds every block of the factor's structure, B
of them, but H puts something into only the set T (`asm_blk`): the store
rows that receive a contribution, plus every diagonal block (its padded
dimensions get the identity).  The rest is fill, which only factorize's
working copy receives.  The invariant: outside T, the store that system()
returns is zero.  The assembly plan (asm_ptr over asm_src, asm_diag) and
the matvec's row and column CSRs list T's blocks only, in the JAX plans'
order with the fill removed, so their sums are the JAX package's less
exact-zero terms (a projection batch's: its chunks' partial sums in chunk
order).  system(arrays, out=store) writes T's rows of a store
that is zero outside T and leaves the rest alone: SparseSolver owns one
such store, zeroed once, and every iteration assembles into it.

  QR:        the multifrontal QR of the whitened Jacobian (factorize_qr):
             kernel 6's Jacobian mode writes each factor slot's rows into
             a pool, and kernel 12, a launch a level, gathers and factors
             every front of the level (its R_sep rows go up to the
             parent); R^T takes L's place in kernel 8's solves.

Every kernel has a plain PyTorch version (supernodal_kernels.py) that the
CPU runs.  The two-float refinement of the JAX package (matvec_df,
solve_refined_df) is not ported: the card refines in native float64
(solve_refined, solve_qr).

A failed factorization: jnp.linalg.cholesky fills a failed front with NaN
and the JAX SparseSolver solves on with a zeroed factor, so the step's
error is not finite and LM rejects it.  Here the factorization's `ok` flag
(read once per try with the error) rejects the try, and badcol names the
first bad pivot's column (where cholesky_ex stops, in the plain version).
"""

import dataclasses
import types
from typing import List, Optional

import numpy as np
import torch

from ..graph import manifolds
from ..graph.graph import BoundGraph
from ..inference import ordering as ordering_mod
from ..inference import supernodes as sn_mod
from . import supernodal_kernels as K
from .exceptions import IndeterminantLinearSystemError

F64 = torch.float64
I32 = torch.int32


@dataclasses.dataclass
class _LevelPlan:
    snodes: np.ndarray
    S: int
    W: int                      # max snode width (blocks) this level
    R: int                      # max row-structure size (blocks)
    diag_ids: np.ndarray        # (S, W, W) block ids (sentinel B)
    diag_flip: np.ndarray       # (S, W, W) bool
    diag_pad: np.ndarray        # (S, W*d) 1.0 where padded col slot
    valid_diag: np.ndarray      # (S, W*d) bool: true (unpadded) pivots
    col_vars: np.ndarray        # (S, W) permuted col ids (sentinel n)
    panel_ids: Optional[np.ndarray]   # (S, R, W) block ids (sentinel B)
    row_vars: Optional[np.ndarray]    # (S, R) permuted row ids (sentinel n)
    diag_sc_src: np.ndarray     # scatter L_diag: flat src into (S*W*W)
    diag_sc_tgt: np.ndarray
    panel_sc_src: Optional[np.ndarray]
    panel_sc_tgt: Optional[np.ndarray]
    schur_src: Optional[np.ndarray]   # sorted by target: flat into (S*R*R)
    schur_seg: Optional[np.ndarray]
    schur_tgt: Optional[np.ndarray]   # unique target block ids
    fwd_src: Optional[np.ndarray]     # sorted flat into (S*R)
    fwd_seg: Optional[np.ndarray]
    fwd_tgt: Optional[np.ndarray]     # unique row var ids
    x_sc_src: np.ndarray        # flat into (S*W)
    x_sc_tgt: np.ndarray        # col var ids (unique by construction)

    @property
    def narrow(self) -> bool:
        """Kernel 7's route of the level: the narrow pair
        (K.narrow_route), else the wide one.  A property, not a field: the
        fields are the JAX package's plan."""
        return K.narrow_route(self.W, self.R, self.diag_pad.shape[1]
                              // self.W)


def _sorted_segments(tgt: np.ndarray):
    """Host: sort targets, return (order, segment_ids, unique_targets)."""
    order = np.argsort(tgt, kind="stable")
    st = tgt[order]
    if len(st) == 0:
        return order, np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    new = np.concatenate([[True], st[1:] != st[:-1]])
    seg = np.cumsum(new) - 1
    return (order.astype(np.int32), seg.astype(np.int32),
            st[new].astype(np.int32))


def _seg_ptr(seg, nseg):
    """CSR offsets (nseg + 1,) of sorted segment ids."""
    counts = np.bincount(seg, minlength=nseg) if len(seg) \
        else np.zeros(nseg, np.int64)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _slot_pairs(arity):
    return [(s1, s2) for s1 in range(arity) for s2 in range(s1, arity)]


@dataclasses.dataclass
class Factored:
    """One numeric factorization: its levels (supernodal_kernels.Levels:
    per level the dense L (S, W*d, W*d) and panel Lp (S, R*d, W*d) or None,
    each column-major per front, and the level table that the solve's
    kernels read them through); ok and badcol (0-d tensors, read on the
    host when needed); the inverses of L's 32x32 diagonal tiles (tiles, 32,
    32), which the front kernel leaves, level after level."""

    levels: K.Levels
    ok: torch.Tensor
    badcol: torch.Tensor
    Linv: torch.Tensor

    @property
    def Ldiag(self) -> List[torch.Tensor]:
        return self.levels.Ls

    @property
    def Lpanel(self) -> List[Optional[torch.Tensor]]:
        return self.levels.Ps


class SupernodalCholeskySolver:
    """Sparse solver over a bound graph: system / factorize /
    solve_factored / solve_refined / matvec.  Built once per (graph
    structure, values structure); its device plan lives on the bound
    graph's device."""

    @staticmethod
    def _level_cost(sym, level_overhead_flops: float = 2e6):
        """Device cost model of a supernodal schedule: padded dense-front
        flops per level plus a fixed per-level charge (the JAX package's;
        the ordering it picks must be the same)."""
        total = 0.0
        for sids in sym.levels:
            widths = sym.snode_width[sids]
            rs = np.asarray([len(sym.snode_rows[s]) for s in sids])
            W = int(widths.max())
            R = int(rs.max()) if len(rs) else 0
            F = W + R
            total += len(sids) * (float(F) ** 2) * W + level_overhead_flops
        return total

    def __init__(self, bound: BoundGraph, order: str = "auto",
                 relax_tau: float = 0.3, force_width: int = 16,
                 max_width: int = 64):
        layout = bound.layout
        self.layout = layout
        self.var_dims = []
        self.var_offsets = []
        var_id = {}
        for t in layout.type_order:
            d = manifolds.get(t).dim
            for r in range(len(layout.offsets[t])):
                var_id[(t, r)] = len(self.var_dims)
                self.var_dims.append(d)
                self.var_offsets.append(int(layout.offsets[t][r]))
        self.nvars = len(self.var_dims)
        self.var_dims = np.asarray(self.var_dims)
        self.var_offsets = np.asarray(self.var_offsets)
        self.d = int(self.var_dims.max()) if self.nvars else 0

        self.batch_var_ids = []
        for b, st in zip(bound.graph.batches, bound.structures):
            self.batch_var_ids.append(np.stack([
                np.asarray([var_id[(t, int(r))] for r in st.rows[s]])
                for s, t in enumerate(b.var_types)], axis=1))

        adj = ordering_mod.adjacency_from_factors(self.batch_var_ids,
                                                  self.nvars)
        kw = dict(relax_tau=relax_tau, force_width=force_width,
                  max_width=max_width)
        self.chosen_order = order
        if order == "natural":
            sym = sn_mod.analyze_supernodal(
                adj, ordering_mod.natural(self.nvars), **kw)
        elif order == "amd":
            sym = sn_mod.analyze_supernodal(
                adj, ordering_mod.minimum_degree(adj), **kw)
        elif order == "nd":
            sym = sn_mod.analyze_supernodal(
                adj, ordering_mod.nested_dissection(adj), **kw)
        else:
            # auto: AMD, native ND and ND by BFS, scored by the level cost
            cands = []
            for nm, p in (
                    ("amd", ordering_mod.minimum_degree(adj)),
                    ("nd", ordering_mod.nested_dissection(adj,
                                                          method="native")),
                    ("nd-bfs", ordering_mod.nested_dissection(adj,
                                                              method="bfs"))):
                s = sn_mod.analyze_supernodal(adj, p, **kw)
                cands.append((self._level_cost(s), nm, s))
            cands.sort(key=lambda t: t[0])
            sym = cands[0][2]
            self.chosen_order = cands[0][1]
        self.sym = sym
        n, d = self.nvars, self.d
        B = sym.nnz_blocks
        self.B = B

        # -- per-level plans (the JAX package's, loop for loop) -------------
        self.level_plans: List[_LevelPlan] = []
        for sids in sym.levels:
            S = len(sids)
            widths = sym.snode_width[sids]
            rsizes = np.asarray([len(sym.snode_rows[s]) for s in sids])
            W = int(widths.max())
            R = int(rsizes.max()) if len(rsizes) else 0
            diag_ids = np.full((S, W, W), B, dtype=np.int32)
            diag_flip = np.zeros((S, W, W), dtype=bool)
            col_vars = np.full((S, W), n, dtype=np.int32)
            dsc_src, dsc_tgt = [], []
            xs_src, xs_tgt = [], []
            for si, s in enumerate(sids):
                c0, w = int(sym.snode_start[s]), int(sym.snode_width[s])
                col_vars[si, :w] = np.arange(c0, c0 + w)
                for a in range(w):
                    xs_src.append(si * W + a)
                    xs_tgt.append(c0 + a)
                    for b in range(w):
                        if a >= b:
                            diag_ids[si, a, b] = sym.block_of[(c0 + a, c0 + b)]
                            dsc_src.append(si * W * W + a * W + b)
                            dsc_tgt.append(sym.block_of[(c0 + a, c0 + b)])
                        else:
                            diag_ids[si, a, b] = sym.block_of[(c0 + b, c0 + a)]
                            diag_flip[si, a, b] = True
            pad_cols = (np.arange(W)[None, :] >= widths[:, None])  # (S, W)
            diag_pad = np.repeat(pad_cols, d, axis=1).astype(np.float64)
            # valid pivots: unpadded col slot AND true manifold dim
            vd = np.zeros((S, W * d), dtype=bool)
            for si, s in enumerate(sids):
                c0, w = int(sym.snode_start[s]), int(sym.snode_width[s])
                for a in range(w):
                    dim = self.var_dims[sym.perm[c0 + a]]
                    vd[si, a * d:a * d + dim] = True
            panel_ids = row_vars = None
            psc_src = psc_tgt = None
            schur = fwd = None
            if R > 0:
                panel_ids = np.full((S, R, W), B, dtype=np.int32)
                row_vars = np.full((S, R), n, dtype=np.int32)
                psc_src, psc_tgt = [], []
                sc_src, sc_tgt = [], []
                fw_src, fw_tgt = [], []
                for si, s in enumerate(sids):
                    c0, w = int(sym.snode_start[s]), int(sym.snode_width[s])
                    rows = sym.snode_rows[s]
                    row_vars[si, :len(rows)] = rows
                    for a, ra in enumerate(rows):
                        fw_src.append(si * R + a)
                        fw_tgt.append(int(ra))
                        for b in range(w):
                            bid = sym.block_of[(int(ra), c0 + b)]
                            panel_ids[si, a, b] = bid
                            psc_src.append(si * R * W + a * W + b)
                            psc_tgt.append(bid)
                        for b in range(a + 1):
                            sc_src.append(si * R * R + a * R + b)
                            sc_tgt.append(sym.block_of[(int(ra),
                                                        int(rows[b]))])
                sc_src = np.asarray(sc_src, dtype=np.int32)
                sc_tgt = np.asarray(sc_tgt, dtype=np.int32)
                so, seg, uniq = _sorted_segments(sc_tgt)
                schur = (sc_src[so], seg, uniq)
                fw_src = np.asarray(fw_src, dtype=np.int32)
                fw_tgt = np.asarray(fw_tgt, dtype=np.int32)
                fo, fseg, funiq = _sorted_segments(fw_tgt)
                fwd = (fw_src[fo], fseg, funiq)
                psc_src = np.asarray(psc_src, dtype=np.int32)
                psc_tgt = np.asarray(psc_tgt, dtype=np.int32)
            self.level_plans.append(_LevelPlan(
                snodes=sids, S=S, W=W, R=R,
                diag_ids=diag_ids, diag_flip=diag_flip, diag_pad=diag_pad,
                valid_diag=vd, col_vars=col_vars,
                panel_ids=panel_ids, row_vars=row_vars,
                diag_sc_src=np.asarray(dsc_src, dtype=np.int32),
                diag_sc_tgt=np.asarray(dsc_tgt, dtype=np.int32),
                panel_sc_src=psc_src, panel_sc_tgt=psc_tgt,
                schur_src=None if schur is None else schur[0],
                schur_seg=None if schur is None else schur[1],
                schur_tgt=None if schur is None else schur[2],
                fwd_src=None if fwd is None else fwd[0],
                fwd_seg=None if fwd is None else fwd[1],
                fwd_tgt=None if fwd is None else fwd[2],
                x_sc_src=np.asarray(xs_src, dtype=np.int32),
                x_sc_tgt=np.asarray(xs_tgt, dtype=np.int32),
            ))

        # -- assembly plan: one sorted segment-sum over all contributions ----
        # JAX order: per (batch, slot pair) the batch's N blocks; the flips
        # per pair were computed here, in plan order
        asm_tgt, self._asm_plan = [], []
        pos = 0
        for ids in self.batch_var_ids:
            arity = ids.shape[1]
            for s1, s2 in _slot_pairs(arity):
                ni = sym.inv_perm[ids[:, s1]]
                nj = sym.inv_perm[ids[:, s2]]
                flip = ni < nj
                hi = np.maximum(ni, nj)
                lo = np.minimum(ni, nj)
                bids = np.asarray(
                    [sym.block_of[(int(h), int(l))]
                     for h, l in zip(hi, lo)], dtype=np.int32)
                self._asm_plan.append((s1, s2, flip, pos))
                asm_tgt.append(bids)
                pos += len(bids)
        self._pair_bids = asm_tgt
        if asm_tgt:
            ao, aseg, auniq = _sorted_segments(np.concatenate(asm_tgt))
            self._asm_order, self._asm_seg, self._asm_uniq = ao, aseg, auniq
        else:
            self._asm_order = self._asm_seg = self._asm_uniq = (
                np.zeros(0, dtype=np.int32))
        # gradient assembly: the same over (batch, slot) -> var targets
        g_tgt = []
        for ids in self.batch_var_ids:
            for s in range(ids.shape[1]):
                g_tgt.append(sym.inv_perm[ids[:, s]].astype(np.int32))
        if g_tgt:
            go, gseg, guniq = _sorted_segments(np.concatenate(g_tgt))
            self._g_order, self._g_seg, self._g_uniq = go, gseg, guniq
        else:
            self._g_order = self._g_seg = self._g_uniq = (
                np.zeros(0, dtype=np.int32))

        # identity on padding diagonal (true dims < d), by NEW col id
        self.pad_diag = np.zeros((self.nvars, self.d))
        for v in range(self.nvars):
            self.pad_diag[sym.inv_perm[v], self.var_dims[v]:] = 1.0
        self.bound = bound

        # block-sparse symmetric matvec plan (refinement residual): y[r] +=
        # B_k x[c] for every stored lower block, y[c] += B_k^T x[r] for the
        # off-diagonal ones, both as sorted segment-sums
        br, bc = sym.block_row, sym.block_col
        ro, rseg, runiq = _sorted_segments(br)
        offd = np.where(br != bc)[0].astype(np.int32)
        co, cseg, cuniq = _sorted_segments(bc[offd])
        self._mv_plan = (ro, rseg, runiq, offd, offd[co], cseg, cuniq)
        self._port_plans()
        self.to(bound.device)

    def rebind(self, bound: BoundGraph) -> bool:
        """Take `bound` (its batches' noise models and measurements) in
        place of the bound graph planned for, when its structure is the
        same: the same device and layout and, batch by batch, the same
        variable types and rows.  True then; False (nothing changed)
        otherwise.  The plans depend on the structure alone, so a rebound
        solver computes what a new one over `bound` would."""
        old = self.bound
        same = (bound.device == old.device
                and bound.layout.total_dim == old.layout.total_dim
                and bound.layout.type_order == old.layout.type_order
                and len(bound.graph.batches) == len(old.graph.batches)
                and all(b.var_types == a.var_types
                        and len(s1.rows) == len(s0.rows)
                        and all(np.array_equal(r1, r0)
                                for r1, r0 in zip(s1.rows, s0.rows))
                        for b, a, s1, s0 in zip(
                            bound.graph.batches, old.graph.batches,
                            bound.structures, old.structures)))
        if same:
            self.bound = bound
        return same

    def _port_plans(self):
        """Host arrays the port's kernels read on top of the JAX plans: the
        assembly CSRs over the contribution buffer (the bound graph's
        ContributionPlan) and over T, the matvec's CSRs over T, and the CSR
        offsets of the Schur and forward segments."""
        n, B = self.nvars, self.B
        sym = self.sym
        # the buffer's rows and T (H's own blocks, module docstring): the
        # graph's contribution plan over this solver's blocks and order
        cp = self._cplan = self.bound.contribution_plan()
        pair_tgt, slot_tgt, k = [], [], 0
        for ids in self.batch_var_ids:
            npair = len(_slot_pairs(ids.shape[1]))
            pair_tgt.append(self._pair_bids[k:k + npair])
            slot_tgt.append([sym.inv_perm[ids[:, s]]
                             for s in range(ids.shape[1])])
            k += npair
        asm = cp.assembly(pair_tgt, slot_tgt, B, sym.diag_block_by_col, n)
        self._n_hc, self._n_gc = cp.n_hc, cp.n_gc
        # the QR pool's layout: a row block a factor and slot, factor-major
        # per batch
        sizes = [ids.size for ids in self.batch_var_ids]
        self._pool_base = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        self._n_pool = int(sum(sizes))
        for key in ("asm_src", "asm_ptr", "asm_blk", "asm_diag", "g_src",
                    "g_ptr"):
            setattr(self, key, asm[key])
        in_t = asm["in_t"]
        # the matvec's CSRs: the JAX plan's sorted blocks that lie in T
        ro, rseg, runiq, offd, coi, cseg, cuniq = self._mv_plan
        self.mv_row_blk = ro[in_t[ro]].astype(np.int32)
        self.mv_row_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(sym.block_row[self.mv_row_blk],
                                        minlength=n))]).astype(np.int32)
        self.mv_col_blk = coi[in_t[coi]].astype(np.int32)
        self.mv_col_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(sym.block_col[self.mv_col_blk],
                                        minlength=n))]).astype(np.int32)
        self.schur_ptr = [None if lp.R == 0 else
                          _seg_ptr(lp.schur_seg, len(lp.schur_tgt))
                          for lp in self.level_plans]
        self.fwd_ptr = [None if lp.R == 0 else
                        _seg_ptr(lp.fwd_seg, len(lp.fwd_tgt))
                        for lp in self.level_plans]
        # each level's first tile in kernel 8's buffer of diagonal-tile
        # inverses (S * ceil(W*d / 32) a level), which the front kernel fills
        ntiles = [lp.S * -(-lp.W * self.d // K.TILE) for lp in
                  self.level_plans]
        self.tile_off = np.concatenate([[0], np.cumsum(ntiles)]).astype(int)
        self._solve_plan()
        # flat canonical index -> flat (permuted var, component) index
        src = []
        for v in range(n):
            src.append(self.sym.inv_perm[v] * self.d
                       + np.arange(self.var_dims[v]))
        order = np.argsort(self.var_offsets, kind="stable")
        self.flat_src = (np.concatenate([src[v] for v in order])
                         if n else np.zeros(0, np.int64))

    def _solve_plan(self):
        """Kernel 8's all-levels layout: the column slots (every level's
        col_vars, flattened in level order) and row slots (row_vars), the
        sizes of y, c (every level's S*R d-rows, in level order) and the
        diagonal tiles, and the
        gather CSR over the column slots: slot q's segments
        gat_seg[gat_ptr[q]:gat_ptr[q+1]], one per lower level with rows
        that target q's variable, in level order; segment e's c rows
        gat_src[gat_seg[e]:gat_seg[e+1]], in the level's fwd_src order.
        Summing each segment, then the segments in order, is the JAX
        forward's sorted segment sum and accumulation."""
        n = self.nvars
        lps = self.level_plans
        self.sol_cols = np.concatenate(
            [lp.col_vars.reshape(-1) for lp in lps]).astype(np.int32)
        self.sol_rows = np.concatenate(
            [np.zeros(0, np.int32)] + [lp.row_vars.reshape(-1)
                                       for lp in lps if lp.R]).astype(np.int32)
        slot_of = np.full(n + 1, -1, np.int64)
        true = self.sol_cols < n
        slot_of[self.sol_cols[true]] = np.flatnonzero(true)
        seg_slot, seg_len, srcs = [], [], []
        crow = 0
        for lp, fp in zip(lps, self.fwd_ptr):
            if lp.R:
                seg_slot.append(slot_of[lp.fwd_tgt])
                seg_len.append(np.diff(fp))
                srcs.append(lp.fwd_src.astype(np.int64) + crow)
                crow += lp.S * lp.R
        nq = len(self.sol_cols)
        if seg_slot:
            seg_slot = np.concatenate(seg_slot)
            seg_len = np.concatenate(seg_len)
            src = np.concatenate(srcs)
        else:
            seg_slot = seg_len = src = np.zeros(0, np.int64)
        order = np.argsort(seg_slot, kind="stable")   # keeps level order
        start = np.concatenate([[0], np.cumsum(seg_len)])[:-1]
        ln = seg_len[order]
        self.gat_seg = np.concatenate([[0], np.cumsum(ln)]).astype(np.int32)
        within = np.arange(int(ln.sum())) - np.repeat(self.gat_seg[:-1], ln)
        self.gat_src = src[np.repeat(start[order], ln) + within].astype(
            np.int32)
        self.gat_ptr = np.concatenate([[0], np.cumsum(np.bincount(
            seg_slot, minlength=nq))]).astype(np.int32)
        self.n_y = sum(lp.S * lp.W * self.d for lp in lps)
        self.n_c = crow * self.d

    def to(self, device) -> "SupernodalCholeskySolver":
        """Move the plans to `device` (once; the solver then runs there)."""
        dev = torch.device(device)
        self.device = dev

        def t(a, dtype=I32):
            return None if a is None else torch.as_tensor(
                np.ascontiguousarray(a), dtype=dtype, device=dev)

        sym = self.sym
        sms = K.device_sms(dev)
        self.dev = types.SimpleNamespace(
            asm_src=t(self.asm_src), asm_ptr=t(self.asm_ptr),
            asm_blk=t(self.asm_blk), asm_diag=t(self.asm_diag),
            g_src=t(self.g_src), g_ptr=t(self.g_ptr),
            pad_diag=t(self.pad_diag, F64),
            dbc=t(sym.diag_block_by_col), block_row=t(sym.block_row),
            block_col=t(sym.block_col), mv_row_ptr=t(self.mv_row_ptr),
            mv_row_blk=t(self.mv_row_blk), mv_col_ptr=t(self.mv_col_ptr),
            mv_col_blk=t(self.mv_col_blk),
            flat_src=t(self.flat_src, torch.long),
            sol_cols=t(self.sol_cols), sol_rows=t(self.sol_rows),
            gat_ptr=t(self.gat_ptr), gat_seg=t(self.gat_seg),
            gat_src=t(self.gat_src),
            # kernel 8's y and c of every level: scratch of one solve at a
            # time, on the solver's stream
            sol_y=torch.empty(self.n_y, dtype=F64, device=dev),
            sol_c=torch.empty(self.n_c, dtype=F64, device=dev),
            fronts=sum(lp.S for lp in self.level_plans),
            flips=self._cplan.row_flips(
                [[flip for (_, _, flip, _) in pairs]
                 for pairs in self._batch_pairs()], dev),
            levels=[types.SimpleNamespace(
                S=lp.S, W=lp.W, R=lp.R,
                # the front kernel's CTAs a front (1 off the card)
                ctas=K.front_ctas(lp.S, lp.W, lp.R, self.d, sms)
                if sms else 1,
                diag_ids=t(lp.diag_ids), diag_flip=t(lp.diag_flip, torch.bool),
                diag_pad=t(lp.diag_pad, F64),
                valid_diag=t(lp.valid_diag, torch.bool),
                col_vars=t(lp.col_vars), panel_ids=t(lp.panel_ids),
                row_vars=t(lp.row_vars),
                tiles=slice(int(self.tile_off[k]),
                            int(self.tile_off[k + 1])),
                schur=None if lp.R == 0 else K.schur_plan(
                    t(lp.schur_src), t(sp), t(lp.schur_tgt), lp.S, lp.W,
                    lp.R, self.d, self.B + 1),
                narrow=K.narrow_plan(lp, sp, self.d, self.B + 1, dev)
                if lp.narrow else None)
                for k, (lp, sp) in enumerate(zip(self.level_plans,
                                                 self.schur_ptr))])
        # the Schur update's scratch (U, partial tiles, U's even-pitched
        # operand), a wide level at a time
        self.dev.schur_U = torch.empty(max(
            [lv.schur.split.scratch for lv in self.dev.levels
             if lv.schur is not None and lv.narrow is None] + [0]),
            dtype=F64, device=dev)
        # the narrow levels' chunk rows, a level at a time
        self.dev.narrow_part = torch.empty(max(
            [lv.narrow.nrows * self.d ** 2 for lv in self.dev.levels
             if lv.narrow is not None] + [0]), dtype=F64, device=dev)
        return self

    def _batch_pairs(self):
        """The assembly plan's (s1, s2, flip, pos) entries, per batch."""
        out, k = [], 0
        for ids in self.batch_var_ids:
            npair = len(_slot_pairs(ids.shape[1]))
            out.append(self._asm_plan[k:k + npair])
            k += npair
        return out

    # -- system assembly -------------------------------------------------

    def new_store(self):
        """A zeroed block store (B+1, d*d) on the solver's device, for
        system(..., out=)."""
        return torch.zeros((self.B + 1, self.d * self.d), dtype=F64,
                           device=self.device)

    def system(self, arrays, out=None):
        """Linearize and assemble: (blocks (B+1, d*d) — the flat block store,
        one row per stored (d, d) block, the last row the zero sentinel —
        and g (nvars, d) in the permuted order).  blocks is `out` when given
        (a store that is zero outside T: only T's rows are written), else a
        new store."""
        d, dv = self.d, self.dev
        bound = self.bound
        hc = torch.empty((self._n_hc, d * d), dtype=F64, device=self.device)
        gc = torch.empty((self._n_gc, d), dtype=F64, device=self.device)
        for bi in range(len(bound.graph.batches)):
            bound.contributions(bi, arrays, self._cplan, hc, gc, dv.flips[bi])
        return K.pg_assemble(hc, gc, dv.asm_src, dv.asm_ptr, dv.asm_blk,
                             dv.asm_diag, dv.g_src, dv.g_ptr, dv.pad_diag,
                             self.B + 1, out)

    # -- numeric factorization -------------------------------------------

    def factorize(self, blocks, lam=0.0, diagonal_damping: bool = False,
                  min_diag: float = 1e-6, max_diag: float = 1e32) -> Factored:
        """The per-level dense factors of (H + damping); `blocks` is not
        changed (the Schur updates go to a working copy).  ok / badcol:
        all pivots finite and positive / the first offending permuted
        column or -1 (reference splitConditional,
        gtsam/linear/JacobianFactor.cpp:838)."""
        dv = self.dev
        work = blocks.clone()
        rec = torch.empty(dv.fronts, dtype=I32, device=self.device)
        tiles = torch.empty((int(self.tile_off[-1]), K.TILE, K.TILE),
                            dtype=F64, device=self.device)
        Ls, Lps = [], []
        off = 0
        for lv in dv.levels:
            args = (work, blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
                    lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, lam,
                    diagonal_damping, rec[off:off + lv.S])
            off += lv.S
            if lv.narrow is not None:
                L, _, Lp, _ = K.sn_narrow_front(
                    *args, lv.narrow, dv.narrow_part, min_diag, max_diag,
                    out=(None, None, None, tiles[lv.tiles]))
                if lv.R:
                    K.sn_narrow_scatter(Lp, dv.narrow_part, lv.narrow, work)
            else:
                L, Linv, At, _ = K.sn_front_factor(
                    *args, min_diag, max_diag,
                    out=(None, None, None, tiles[lv.tiles]), ctas=lv.ctas)
                Lp = None
                if lv.R:  # A L^-T, column-major; the Schur update of work
                    Lp = K.sn_schur_update(Linv, At, lv.schur, work,
                                           dv.schur_U)
            Ls.append(L)
            Lps.append(Lp)
        state = torch.empty(2, dtype=I32, device=self.device)
        K.sn_pivot_check(rec, state)
        return Factored(K.level_table(Ls, Lps, self.d), state[0] == 1,
                        state[1], tiles)

    def damp_vec(self, blocks, lam, diagonal_damping, min_diag=1e-6,
                 max_diag=1e32):
        """(n, d) additive diagonal damping, as factorize() applies it."""
        return K.damp_vec(blocks, self.dev.dbc, self.dev.pad_diag, lam,
                          diagonal_damping, min_diag, max_diag)

    def matvec(self, blocks, x, lam=0.0, diagonal_damping: bool = False):
        """(H + damping) x on the block store; x and the result (n, d) in
        the permuted layout."""
        dv = self.dev
        return K.sn_matvec(blocks, x, dv.mv_row_ptr, dv.mv_row_blk,
                           dv.mv_col_ptr, dv.mv_col_blk, dv.block_row,
                           dv.block_col, dv.dbc, dv.pad_diag, lam,
                           diagonal_damping)

    def _solve_padded(self, factored: Factored, g):
        """Forward and backward substitution, one kernel 8 launch each; x
        (n, d) in the permuted layout."""
        f, dv = factored, self.dev
        K.sn_forward(g, f.levels, f.Linv, dv.sol_cols, dv.gat_ptr,
                     dv.gat_seg, dv.gat_src, dv.sol_y, dv.sol_c)
        x = torch.empty((self.nvars, self.d), dtype=F64, device=self.device)
        return K.sn_backward(dv.sol_y, f.levels, f.Linv, dv.sol_cols,
                             dv.sol_rows, x)

    def solve_refined(self, blocks, g, lam=0.0,
                      diagonal_damping: bool = False, refine_iters: int = 2):
        """Factorize, solve, and refine refine_iters times against the
        float64 matvec: (flat delta in the canonical layout, ok)."""
        factored = self.factorize(blocks, lam, diagonal_damping)
        x = self._solve_padded(factored, g)
        for _ in range(refine_iters):
            r = g - self.matvec(blocks, x, lam, diagonal_damping)
            x = x + self._solve_padded(factored, r)
        return self._flatten(x), factored.ok

    def solve_factored(self, factored: Factored, g):
        """Forward + backward substitution; flat delta (canonical)."""
        return self._flatten(self._solve_padded(factored, g))

    def _flatten(self, x):
        """(n, d) permuted-padded solution -> flat delta (canonical)."""
        return x.reshape(-1)[self.dev.flat_src]

    def pack_rhs(self, vec):
        """Canonical flat (total_dim,) vector -> (nvars, d) permuted-padded
        layout (the inverse of _flatten; padded dims 0)."""
        out = torch.zeros(self.nvars * self.d, dtype=vec.dtype,
                          device=vec.device)
        out[self.dev.flat_src] = vec
        return out.view(self.nvars, self.d)

    def solve(self, arrays, lam=0.0, diagonal_damping: bool = False,
              refine_iters: int = 0):
        blocks, g = self.system(arrays)
        return self.solve_refined(blocks, g, lam, diagonal_damping,
                                  refine_iters)[0]

    # -- multifrontal QR ----------------------------------------------------
    #
    # The JAX package's sparse EliminateQR (supernodal.py:642-845): per
    # level, each front is [its factors' whitened Jacobian rows | its
    # children's R_sep rows | sqrt(lam) on the true diagonal, 1 on the
    # padding] over the Cholesky level plan's [W d frontal | R d separator]
    # columns; its R's frontal block and panel take the places of L^T and
    # Lp^T, and its R_sep goes up to the parent.  Kernel 8 then solves
    # R^T R x = g as it solves L L^T x = g.  A factor belongs to the front
    # of its first variable in the elimination order.

    def _qr_plan(self):
        """Kernel 12's plan (supernodal_kernels.QRLevel per level), the pool
        layout of kernel 6's Jacobian rows (the contribution buffer's: a
        slot a factor's variable, factor-major per batch), the R_sep buffer
        and the fronts' scratch, built on the host at the first QR call and
        kept on the device."""
        if getattr(self, "_qr", None) is not None:
            return self._qr
        sym, d = self.sym, self.d
        front_id, W_of = {}, {}
        for lp in self.level_plans:
            for sid in lp.snodes:
                front_id[int(sid)] = len(front_id)
                W_of[int(sid)] = lp.W

        def pos(sn, pcol):
            c0, w = int(sym.snode_start[sn]), int(sym.snode_width[sn])
            if c0 <= pcol < c0 + w:
                return pcol - c0
            return W_of[sn] + int(np.searchsorted(sym.snode_rows[sn], pcol))

        batches = self.bound.graph.batches
        rmax = max([1] + [int(b.rdim) for b in batches])
        slots = [[] for _ in range(sym.nsuper)]   # (pool id, pos, rdim)
        for bi, (b, ids) in enumerate(zip(batches, self.batch_var_ids)):
            pcols = sym.inv_perm[ids]
            smin = sym.snode_of[pcols.min(axis=1)]
            base = self._pool_base[bi]
            for i in range(ids.shape[0]):
                sn = int(smin[i])
                slots[sn].append([(base + i * ids.shape[1] + a,
                                   pos(sn, int(pcols[i, a])), int(b.rdim))
                                  for a in range(ids.shape[1])])
        children = [[] for _ in range(sym.nsuper)]
        for c in range(sym.nsuper):
            if sym.snode_parent[c] >= 0:
                children[int(sym.snode_parent[c])].append(c)
        nfront = len(front_id)
        rld = np.zeros(nfront, np.int32)
        for lp in self.level_plans:
            for sid in lp.snodes:
                rld[front_id[int(sid)]] = lp.R * d
        roff = np.concatenate([[0], np.cumsum(rld.astype(np.int64) ** 2)])
        levels, front0, fmax = [], 0, 0
        for lp in self.level_plans:
            S, W, R = lp.S, lp.W, lp.R
            m, sptr, spool, spos, srow0, srows = [], [0], [], [], [], []
            cptr, crow0, cr, cfront, mptr, cmap = [0], [], [], [], [0], []
            for sid in lp.snodes:
                sid = int(sid)
                row = 0
                for fac in slots[sid]:
                    for pid, p, r in fac:
                        spool.append(pid)
                        spos.append(p)
                        srow0.append(row)
                        srows.append(r)
                    row += fac[0][2]
                sptr.append(len(spool))
                for c in children[sid]:
                    rows_c = sym.snode_rows[c]
                    crow0.append(row)
                    cr.append(len(rows_c))
                    cfront.append(front_id[c])
                    cmap.extend(pos(sid, int(pc)) for pc in rows_c)
                    mptr.append(len(cmap))
                    row += len(rows_c) * d
                cptr.append(len(cr))
                m.append(row + W * d)
            ql = K.qr_level(S, W, R, d, front0, m, sptr, spool, spos, srow0,
                            srows, cptr, crow0, cr, cfront, mptr, cmap,
                            self.device)
            levels.append(ql)
            front0 += S
            fmax = max(fmax, K.qr_scratch_doubles(ql))
        dev = self.device
        self._qr = types.SimpleNamespace(
            levels=levels, rmax=rmax,
            roff=torch.as_tensor(roff[:-1], dtype=torch.int64, device=dev),
            rld=torch.as_tensor(rld, device=dev),
            rsep=torch.empty(int(roff[-1]), dtype=F64, device=dev),
            scratch=torch.empty(fmax if dev.type == "cuda" else 0,
                                dtype=F64, device=dev))
        return self._qr

    def jacobian_pool(self, arrays):
        """The whitened Jacobian rows of every factor slot (P, rmax, d), in
        the pool layout of _qr_plan: kernel 6's Jacobian mode for the
        batches it routes, the generic linearization for the others."""
        qp = self._qr_plan()
        pool = torch.empty((self._n_pool, qp.rmax, self.d), dtype=F64,
                           device=self.device)
        for bi, b in enumerate(self.bound.graph.batches):
            N, arity = b.num_factors, b.arity
            p0 = int(self._pool_base[bi])
            self.bound.jacobian_rows(
                bi, arrays, pool[p0:p0 + N * arity].view(N, arity, qp.rmax,
                                                        self.d))
        return pool

    def factorize_qr(self, pool, lam=0.0, pivot_tol=1e-10) -> Factored:
        """The multifrontal QR of the whitened Jacobian rows `pool`
        (jacobian_pool) and sqrt(lam) damping rows, kernel 12 a level, as a
        Factored whose L = R^T (its diagonal non-negative): solve_factored,
        the refinement and kernel 8 take it as they take the Cholesky
        factor.  ok / badcol: every true pivot |R_kk| finite and above
        pivot_tol / the first bad one's permuted column, the first failing
        level's first (front, column), or -1 (kernel 7's pivot check over
        kernel 12's records)."""
        qp, dv = self._qr_plan(), self.dev
        rec = torch.empty(dv.fronts, dtype=I32, device=self.device)
        tiles = torch.empty((int(self.tile_off[-1]), K.TILE, K.TILE),
                            dtype=F64, device=self.device)
        Ls, Lps = [], []
        for lv, ql in zip(dv.levels, qp.levels):
            Lt, Pt = K.sn_front_qr(
                pool, ql, lv.valid_diag, lv.col_vars, qp.roff, qp.rld,
                qp.rsep, lam, rec[ql.front0:ql.front0 + ql.S],
                tiles[lv.tiles], pivot_tol, qp.scratch)
            Ls.append(Lt.mT)
            Lps.append(None if Pt is None else Pt.mT)
        state = torch.empty(2, dtype=I32, device=self.device)
        K.sn_pivot_check(rec, state)
        return Factored(K.level_table(Ls, Lps, self.d), state[0] == 1,
                        state[1], tiles)

    def solve_qr(self, blocks, g, pool, lam=0.0, refine_iters: int = 0):
        """QR-factorize and solve R^T R x = g, with refine_iters float64
        refinement passes against kernel 9's (H + lam) x on the block store
        (blocks, g from system()): (flat delta in the canonical layout,
        ok)."""
        factored = self.factorize_qr(pool, lam)
        x = self._solve_padded(factored, g)
        for _ in range(refine_iters):
            r = g - self.matvec(blocks, x, lam)
            x = x + self._solve_padded(factored, r)
        return self._flatten(x), factored.ok

    def check_system(self, arrays, lam=0.0):
        """Factorize and raise IndeterminantLinearSystemError on a bad
        pivot, naming the variable in the canonical order."""
        blocks, _ = self.system(arrays)
        f = self.factorize(blocks, lam)
        if not bool(f.ok):
            c = int(f.badcol)
            raise IndeterminantLinearSystemError(
                int(self.sym.perm[c]) if c >= 0 else -1)
