"""Sparse block Cholesky: host-planned, level-scheduled, a launch a pass.

Counterpart of gtsam_tpu/linear/sparse.py (reference multifrontal
elimination, ClusterTree-inst.h:285).  The symbolic analysis
(inference/symbolic.py) gives the elimination tree's levels; the host plans
built here from it equal the JAX package's (the dense-root split at
min_level_cols, the per-level index bundles, the late triples, the tail
maps, the assembly plan) and move to the device once.  Then:

  system:         kernel 6 linearizes the SE3 and SE2 between/prior batches
                  and kernel 17 the projection batches into a contribution
                  buffer (the graph's ContributionPlan; other batches: the
                  generic torch.func path) and pg_assemble sums it into the
                  block store (B, d*d) and the padded gradient g (n, d), the
                  padding diagonals' identity included (as the supernodal
                  solver's system);
  factorize:      kernel 13 in one launch over every leading level, a
                  column a job (triples, diagonal Cholesky with a pivot
                  record, subdiagonal solves; each column passed on by a
                  flag), then its second entry: the late triples and the
                  dense root M, both triangles; M through
                  dense_blocked.blocked_cholesky (kernel 10 and cuBLAS's
                  trailing products); kernel 7's pivot check reduces the
                  records;
  solve_factored: kernel 14 forward over every level, the dense root's
                  right-hand side too (one launch), the root's two solves
                  (kernel 11), then kernel 14 backward over every level in
                  reverse (one launch), which also writes the flat delta
                  (un-permuted, un-padded).

Blocks are padded to one width d (the largest variable dimension), with
the identity on the padding's diagonal and no damping there.  lam I
damping only (the JAX package's levels path ignores diagonal damping).

A failed factorization: jnp.linalg.cholesky gives NaN and the JAX package's
LM rejects the try on the non-finite error.  Here kernel 13 records each
column's bad pivot, kernel 7's pivot check reduces the records, and the
factorization's `ok` (with the dense root's info) rejects the same try.

Every kernel has a plain PyTorch version (sparse_kernels.py) that the CPU
runs.
"""

import dataclasses
import types
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..graph import manifolds
from ..graph.graph import BoundGraph
from ..inference import ordering as ordering_mod
from ..inference import symbolic as symbolic_mod
from . import dense_blocked, dense_kernels
from . import sparse_kernels as K
from . import supernodal_kernels as SK

F64 = torch.float64
I32 = torch.int32


@dataclasses.dataclass
class _LevelIndices:
    cols: np.ndarray           # columns in this level
    diag_ids: np.ndarray       # block ids of their diagonals
    sub_ids: np.ndarray        # block ids of their subdiagonal blocks
    sub_col_pos: np.ndarray    # for each sub block: position of its column
    triples: Tuple[np.ndarray, np.ndarray, np.ndarray]
    # forward solve: blocks with ROW in this level, col outside (earlier
    # levels)
    fwd_ids: np.ndarray
    fwd_src: np.ndarray        # column (k) of each such block
    fwd_dst: np.ndarray        # row (j) of each such block


class Factored(NamedTuple):
    """One numeric factorization: L (B, d*d), the leading columns' blocks
    factored (the tail's blocks unwritten); the dense root's (M, Dinv,
    info) from blocked_cholesky, or None without a tail; ok (0-d bool on
    the device); rec, each leading column's pivot record (level order), and
    state = (ok, first bad column) of kernel 7's pivot check (None without
    leading columns)."""

    L: torch.Tensor
    tail: Optional[tuple]
    ok: torch.Tensor
    rec: torch.Tensor
    state: Optional[torch.Tensor]


def _csr(owner: np.ndarray, n: int) -> np.ndarray:
    """CSR offsets (n + 1,) of a sorted owner array."""
    return np.concatenate([[0], np.cumsum(np.bincount(
        owner, minlength=n))]).astype(np.int32)


def _cat(xs, dtype=np.int32):
    return np.concatenate(xs).astype(dtype) if xs else np.zeros(0, dtype)


class SparseCholeskySolver:
    """Built once per (graph structure, values structure); then system,
    factorize and solve_factored on the device."""

    def __init__(self, bound: BoundGraph, order: str = "nd",
                 min_level_cols: int = 8):
        layout = bound.layout
        self.layout = layout
        # global variable ids: (type, row) -> id, in layout order
        var_dims, var_offsets, var_id = [], [], {}
        for t in layout.type_order:
            d = manifolds.get(t).dim
            for r in range(len(layout.offsets[t])):
                var_id[(t, r)] = len(var_dims)
                var_dims.append(d)
                var_offsets.append(int(layout.offsets[t][r]))
        self.nvars = len(var_dims)
        self.var_dims = np.asarray(var_dims, dtype=np.int64)
        self.var_offsets = np.asarray(var_offsets, dtype=np.int64)
        self.d = int(self.var_dims.max()) if self.nvars else 0

        # factor structure -> var-id keys per batch
        self.batch_var_ids = [
            np.stack([np.asarray([var_id[(t, int(r))] for r in st.rows[s]],
                                 dtype=np.int64)
                      for s, t in enumerate(b.var_types)], axis=1)
            for b, st in zip(bound.graph.batches, bound.structures)]
        adj = ordering_mod.adjacency_from_factors(self.batch_var_ids,
                                                  self.nvars)
        if order == "natural":
            perm = ordering_mod.natural(self.nvars)
        elif order == "amd":
            perm = ordering_mod.minimum_degree(adj)
        else:
            perm = ordering_mod.nested_dissection(adj)
        self.sym = symbolic_mod.analyze(adj, perm)
        sym = self.sym

        # -- the dense root split ------------------------------------------
        # Levels whose column count falls below min_level_cols form the
        # tree's sequential tail; its columns (ancestor-closed) are
        # eliminated as ONE dense frontal matrix.
        nlev_all = len(sym.levels)
        L_cut = nlev_all
        for lv, cols in enumerate(sym.levels):
            if len(cols) < min_level_cols:
                L_cut = lv
                break
        tail_mask = sym.col_level >= L_cut  # by NEW column id
        self.tail_cols = np.where(tail_mask)[0].astype(np.int32)
        self.tail_pos = np.full(self.nvars, -1, dtype=np.int32)
        self.tail_pos[self.tail_cols] = np.arange(len(self.tail_cols))
        self.n_tail = len(self.tail_cols)
        self.L_cut = L_cut

        # -- per-level index bundles ---------------------------------------
        self.level_indices: List[_LevelIndices] = []
        col_arrays, row_arrays = {}, {}
        for bid in range(sym.nnz_blocks):
            i, j = int(sym.block_row[bid]), int(sym.block_col[bid])
            if i != j:
                col_arrays.setdefault(j, []).append(bid)
                row_arrays.setdefault(i, []).append((bid, j))
        self._col_arrays = col_arrays
        for lv, cols in enumerate(sym.levels[:L_cut]):
            sub_ids, sub_pos = [], []
            for p, j in enumerate(cols):
                for bid in col_arrays.get(int(j), []):
                    sub_ids.append(bid)
                    sub_pos.append(p)
            fwd_ids, fwd_src, fwd_dst = [], [], []
            for j in cols:
                for (bid, k) in row_arrays.get(int(j), []):
                    fwd_ids.append(bid)
                    fwd_src.append(int(k))
                    fwd_dst.append(int(j))
            self.level_indices.append(_LevelIndices(
                cols=np.asarray(cols, dtype=np.int32),
                diag_ids=np.asarray(sym.diag_block_by_col[cols],
                                    dtype=np.int32),
                sub_ids=np.asarray(sub_ids, dtype=np.int32),
                sub_col_pos=np.asarray(sub_pos, dtype=np.int32),
                triples=sym.triples_by_level[lv],
                fwd_ids=np.asarray(fwd_ids, dtype=np.int32),
                fwd_src=np.asarray(fwd_src, dtype=np.int32),
                fwd_dst=np.asarray(fwd_dst, dtype=np.int32)))

        # -- late triples: tail targets, sources from LEADING columns -------
        lt_t, lt_ik, lt_jk = [], [], []
        for lv in range(L_cut, nlev_all):
            t, ik, jk = sym.triples_by_level[lv]
            if len(t) == 0:
                continue
            keep = sym.col_level[sym.block_col[ik]] < L_cut
            lt_t.append(t[keep])
            lt_ik.append(ik[keep])
            lt_jk.append(jk[keep])
        self.late_triples = (_cat(lt_t), _cat(lt_ik), _cat(lt_jk))

        # -- the tail's dense structure -------------------------------------
        self.tail_bids = np.where(tail_mask[sym.block_col])[0].astype(
            np.int32)
        self.tail_r = self.tail_pos[sym.block_row[self.tail_bids]]
        self.tail_c = self.tail_pos[sym.block_col[self.tail_bids]]
        # blocks with row in the tail, col leading (the tail's forward rhs)
        ft_mask = tail_mask[sym.block_row] & ~tail_mask[sym.block_col]
        self.ftail_bids = np.where(ft_mask)[0].astype(np.int32)
        self.ftail_src = sym.block_col[self.ftail_bids]
        self.ftail_dst = self.tail_pos[sym.block_row[self.ftail_bids]]

        # -- the assembly plan: per (batch, slot pair) target blocks, flips -
        self.assembly = []
        for ids in self.batch_var_ids:
            arity = ids.shape[1]
            plan = []
            for s1 in range(arity):
                for s2 in range(s1, arity):
                    ni = sym.inv_perm[ids[:, s1]]
                    nj = sym.inv_perm[ids[:, s2]]
                    lo, hi = np.minimum(ni, nj), np.maximum(ni, nj)
                    bids = np.asarray(
                        [sym.block_of[(int(h), int(lw))]
                         for h, lw in zip(hi, lo)], dtype=np.int32)
                    plan.append((s1, s2, bids, ni < nj))
            self.assembly.append(plan)

        # padding by NEW column id
        self.pad_diag = np.zeros((self.nvars, self.d))
        for v in range(self.nvars):
            self.pad_diag[sym.inv_perm[v], self.var_dims[v]:] = 1.0
        self.bound = bound
        self._port_plans()
        self.to(bound.device)

    # -- the port's plans ------------------------------------------------

    def _port_plans(self):
        """The arrays kernels 6, 13 and 14 read on top of the JAX plans."""
        sym, n, d, B = self.sym, self.nvars, self.d, self.sym.nnz_blocks
        self.B = B
        # system: the graph's contribution plan, summed per block of T (the
        # blocks H puts something into, and every diagonal) in the JAX
        # plan's order, and per variable for g
        cp = self._cplan = self.bound.contribution_plan()
        asm = cp.assembly(
            [[bids for _, _, bids, _ in plan] for plan in self.assembly],
            [[sym.inv_perm[ids[:, s]] for s in range(ids.shape[1])]
             for ids in self.batch_var_ids], B, sym.diag_block_by_col, n)
        self._n_hc, self._n_gc = cp.n_hc, cp.n_gc
        for key in ("asm_src", "asm_ptr", "asm_blk", "asm_diag", "g_src",
                    "g_ptr"):
            setattr(self, key, asm[key])

        # kernel 13: per leading column (level order) its blocks, diagonal
        # first, and per block its triples sorted by target (stable: the
        # JAX triple order)
        cols_all, cptr, cblk, tptr, tik, tjk, lev_off = \
            [], [0], [], [0], [], [], [0]
        for li in self.level_indices:
            t, ik, jk = (np.asarray(a, dtype=np.int64) for a in li.triples)
            o = np.argsort(t, kind="stable")
            t, ik, jk = t[o], ik[o], jk[o]
            for j in li.cols:
                cols_all.append(int(j))
                for b in [int(sym.diag_block_by_col[j])] + \
                        self._col_arrays.get(int(j), []):
                    a, z = np.searchsorted(t, [b, b + 1])
                    cblk.append(b)
                    tik.append(ik[a:z])
                    tjk.append(jk[a:z])
                    tptr.append(tptr[-1] + z - a)
                cptr.append(len(cblk))
            lev_off.append(len(cols_all))
        self.f_cols = np.asarray(cols_all, dtype=np.int32)
        self.f_cptr = np.asarray(cptr, dtype=np.int32)
        self.f_cblk = np.asarray(cblk, dtype=np.int32)
        self.f_tptr = np.asarray(tptr, dtype=np.int32)
        self.f_tik, self.f_tjk = _cat(tik), _cat(tjk)
        self.lev_off = lev_off
        self._factor_jobs()

        # kernel 13's dense root: M's block map and the late triples by
        # stored tail block (stable: the JAX order)
        T = self.n_tail
        self.t_map = np.full(T * T, -1, dtype=np.int32)
        self.t_pos = (self.tail_r.astype(np.int64) * T
                      + self.tail_c).astype(np.int32)
        self.t_map[self.t_pos] = np.arange(len(self.tail_bids),
                                           dtype=np.int32)
        pos = np.full(B, -1, np.int64)
        pos[self.tail_bids] = np.arange(len(self.tail_bids))
        lt, lik, ljk = self.late_triples
        owner = pos[lt]
        o = np.argsort(owner, kind="stable")
        self.l_ik, self.l_jk = lik[o].astype(np.int32), ljk[o].astype(
            np.int32)
        self.l_ptr = _csr(owner[o], len(self.tail_bids))

        # kernel 14's jobs, a level's columns after another's: forward
        # (then the tail's rhs) and backward (levels in reverse, the tail's
        # columns copied with the first); one launch a direction
        # rows of U: x of leading column j at j, of tail column at n + pos
        urow = np.where(self.tail_pos >= 0, n + self.tail_pos,
                        np.arange(n)).astype(np.int32)
        fw = []
        for li in self.level_indices:
            o = np.argsort(li.fwd_dst, kind="stable")
            own = np.searchsorted(li.cols, li.fwd_dst[o])
            fw.append(dict(cols=li.cols, orow=li.cols,
                           dbid=sym.diag_block_by_col[li.cols],
                           fbid=li.fwd_ids[o], fsrc=li.fwd_src[o],
                           owner=own, diag=True))
        if T:
            o = np.argsort(self.ftail_dst, kind="stable")
            fw.append(dict(cols=self.tail_cols,
                           orow=np.arange(T, dtype=np.int32),
                           dbid=np.zeros(T, np.int32),
                           fbid=self.ftail_bids[o],
                           fsrc=self.ftail_src[o],
                           owner=self.ftail_dst[o], diag=False))
        bw = []
        for k, li in enumerate(reversed(self.level_indices)):
            sub_rows = sym.block_row[li.sub_ids]
            job = dict(cols=li.cols, xrow=li.cols,
                       dbid=sym.diag_block_by_col[li.cols],
                       bbid=li.sub_ids, bsrc=urow[sub_rows],
                       owner=li.sub_col_pos)
            bw.append(job)
        if T:
            copy = dict(cols=self.tail_cols, xrow=urow[self.tail_cols],
                        dbid=np.full(T, -1, np.int32),
                        bbid=np.zeros(0, np.int32),
                        bsrc=np.zeros(0, np.int32),
                        owner=np.zeros(0, np.int64))
            if bw:
                first = bw[0]
                J0 = len(first["cols"])
                bw[0] = {key: np.concatenate([first[key], copy[key]])
                         for key in ("cols", "xrow", "dbid", "bbid", "bsrc")}
                bw[0]["owner"] = first["owner"]
                bw[0]["njob"] = J0 + T
            else:
                bw.append(copy)
        self._fw_jobs, self._bw_jobs = fw, bw

        # the rhs and delta maps: flat entry of (permuted column j, c)
        canon = np.full((n, d), -1, dtype=np.int64)
        for v in range(n):
            canon[sym.inv_perm[v], :self.var_dims[v]] = \
                self.var_offsets[v] + np.arange(self.var_dims[v])
        self.map_canon = canon.reshape(-1).astype(np.int32)

    def _factor_jobs(self):
        """Kernel 13's one launch over every leading level: the jobs are the
        leading columns in level order (f_cols; f_lptr the levels' first
        jobs); each job waits on the columns that its triples read
        (f_wptr, f_wsrc: the sorted source columns, all in earlier
        levels)."""
        col = self.sym.block_col
        wptr, wsrc = [0], []
        tp = self.f_tptr[self.f_cptr]
        for q in range(len(self.f_cols)):
            t0, t1 = tp[q], tp[q + 1]
            k = np.unique(col[np.concatenate([self.f_tik[t0:t1],
                                              self.f_tjk[t0:t1]])])
            wsrc.append(k)
            wptr.append(wptr[-1] + len(k))
        self.f_wptr = np.asarray(wptr, dtype=np.int32)
        self.f_wsrc = _cat(wsrc)
        self.f_lptr = np.asarray(self.lev_off, dtype=np.int32)

    @staticmethod
    def _job_arrays(jobs, ptr_key, keys):
        """Concatenate a direction's levels of jobs in order: the job
        arrays, their CSR over the entries of `keys` (ptr), the level
        pointers (lptr: each level's first job, then the count) and the
        jobs that substitute (ndiag: the levels before the first with
        diag False, the tail's rhs)."""
        out = {k: [] for k in ("cols", "rows", "dbid") + keys}
        ptr, lptr, e0, ndiag = [0], [0], 0, None
        for job in jobs:
            J = job.get("njob", len(job["cols"]))
            counts = np.bincount(job["owner"], minlength=J)
            ptr.extend((e0 + np.cumsum(counts)).tolist())
            out["cols"].append(job["cols"])
            out["rows"].append(job[ptr_key])
            out["dbid"].append(job["dbid"])
            for k in keys:
                out[k].append(job[k])
            if ndiag is None and not job.get("diag", True):
                ndiag = lptr[-1]
            e0 += len(job[keys[0]])
            lptr.append(lptr[-1] + J)
        arrs = {k: _cat(v) for k, v in out.items()}
        arrs["ptr"] = np.asarray(ptr, dtype=np.int32)
        arrs["lptr"] = np.asarray(lptr, dtype=np.int32)
        return arrs, lptr[-1] if ndiag is None else ndiag

    def to(self, device) -> "SparseCholeskySolver":
        """Move the plans to `device` (once; the solver then runs there)."""
        dev = torch.device(device)
        self.device = dev

        def t(a, dtype=I32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        sym, n, d, T = self.sym, self.nvars, self.d, self.n_tail
        fw, self._fw_ndiag = self._job_arrays(self._fw_jobs, "orow",
                                              ("fbid", "fsrc"))
        bw, _ = self._job_arrays(self._bw_jobs, "xrow", ("bbid", "bsrc"))
        self.dev = types.SimpleNamespace(
            asm_src=t(self.asm_src), asm_ptr=t(self.asm_ptr),
            asm_blk=t(self.asm_blk), asm_diag=t(self.asm_diag),
            g_src=t(self.g_src), g_ptr=t(self.g_ptr),
            pad_diag=t(self.pad_diag, F64),
            flips=self._cplan.row_flips(
                [[flip for (_, _, _, flip) in plan]
                 for plan in self.assembly], dev),
            f_cols=t(self.f_cols), f_cptr=t(self.f_cptr),
            f_cblk=t(self.f_cblk), f_tptr=t(self.f_tptr),
            f_tik=t(self.f_tik), f_tjk=t(self.f_tjk),
            f_wptr=t(self.f_wptr), f_wsrc=t(self.f_wsrc),
            f_lptr=t(self.f_lptr),
            t_map=t(self.t_map), t_bid=t(self.tail_bids),
            t_pos=t(self.t_pos),
            l_ptr=t(self.l_ptr), l_ik=t(self.l_ik), l_jk=t(self.l_jk),
            t_cols=t(self.tail_cols),
            fw={k: t(v) for k, v in fw.items()},
            bw={k: t(v) for k, v in bw.items()},
            map_canon=t(self.map_canon))
        self._scratch = None
        self._epoch = 0
        return self

    # -- system assembly -------------------------------------------------

    def new_store(self):
        """A zeroed block store (B, d*d) on the solver's device, for
        system(..., out=)."""
        return torch.zeros((self.B, self.d * self.d), dtype=F64,
                           device=self.device)

    def system(self, arrays, out=None):
        """Linearize and assemble: (blocks (B, d*d), the lower block store
        of H with the identity on the padding's diagonal, and g (nvars, d)
        in the permuted order).  blocks is `out` when given (a store that is
        zero outside H's own blocks, of which only those are written), else
        a new store."""
        d, dv, bound = self.d, self.dev, self.bound
        hc = torch.empty((self._n_hc, d * d), dtype=F64, device=self.device)
        gc = torch.empty((self._n_gc, d), dtype=F64, device=self.device)
        for bi in range(len(bound.graph.batches)):
            bound.contributions(bi, arrays, self._cplan, hc, gc, dv.flips[bi])
        return SK.pg_assemble(hc, gc, dv.asm_src, dv.asm_ptr, dv.asm_blk,
                              dv.asm_diag, dv.g_src, dv.g_ptr, dv.pad_diag,
                              self.B, out)

    # -- numeric factorization and solve ----------------------------------

    def factorize(self, blocks, lam=0.0) -> Factored:
        """The leading levels' L blocks and the dense root's factor of
        H + lam I (true dimensions only); `blocks` is not written."""
        dv, dev, d, T = self.dev, self.device, self.d, self.n_tail
        L = torch.empty_like(blocks)
        rec = torch.empty(len(self.f_cols), dtype=I32, device=dev)
        if len(rec):
            flags = self._scratch_buffers()[4]
            K.sp_level_factor(blocks, dv.f_cols, dv.f_cptr, dv.f_cblk,
                              dv.f_tptr, dv.f_tik, dv.f_tjk, dv.f_lptr,
                              dv.f_wptr, dv.f_wsrc, dv.pad_diag, lam, L,
                              rec, flags[2], self._next_epoch(flags))
        state = None
        ok = torch.ones((), dtype=torch.bool, device=dev)
        if len(rec):
            state = torch.empty(2, dtype=I32, device=dev)
            SK.sn_pivot_check(rec, state)
            ok = state[0] == 1
        tail = None
        if T:
            M = _kernels.row_strided(T * d, F64, dev)
            K.sp_tail_assemble(blocks, L, dv.t_map, dv.t_bid, dv.t_pos,
                               dv.l_ptr, dv.l_ik, dv.l_jk, dv.t_cols,
                               dv.pad_diag, lam, M)
            tail = dense_blocked.blocked_cholesky(M)
            ok = ok & (tail[2] == 0)
        return Factored(L, tail, ok, rec, state)

    def solve_factored(self, factored: Factored, g, rhs_map=None,
                       stop=None, out=None):
        """Forward and backward substitution; returns the flat delta
        (canonical layout; `out` when given).  g is (nvars, d) in the
        permuted order, or with rhs_map (n*d,) int32 any flat vector that
        the map reads (-1: zero); stop: a CG loop's done word (every launch
        returns at once where it is set)."""
        dv, dev, n, d, T = self.dev, self.device, self.nvars, self.d, \
            self.n_tail
        L = factored.L
        rhs = g.reshape(-1)
        Y, U, rt, yt, flags = self._scratch_buffers()
        epoch = self._next_epoch(flags)
        delta = out if out is not None else torch.empty(
            self.layout.total_dim, dtype=F64, device=dev)
        fw, bw = dv.fw, dv.bw
        if len(fw["cols"]):
            K.sp_level_forward(L, rhs, rhs_map, Y, rt, fw["cols"],
                               fw["rows"], fw["dbid"], fw["ptr"], fw["fbid"],
                               fw["fsrc"], fw["lptr"], self._fw_ndiag,
                               flags[0], epoch, stop)
        if T:
            Lt, Dinv, _ = factored.tail
            dense_kernels.solve_forward(Lt, Dinv, rt.view(-1), yt, stop=stop)
            dense_kernels.solve_backward(Lt, Dinv, yt, U[n:].view(-1),
                                         stop=stop)
        if len(bw["cols"]):
            K.sp_level_backward(L, Y, U, dv.map_canon, bw["cols"],
                                bw["rows"], bw["dbid"], bw["ptr"],
                                bw["bbid"], bw["bsrc"], bw["lptr"], delta,
                                flags[1], epoch, stop)
        return delta

    def _scratch_buffers(self):
        """(Y, U, rt, yt, flags): y of the leading columns, x of every
        column (the root's at n + its position), the root's rhs and y, and
        the flags (3, n): kernel 14's, a row a direction, and kernel 13's;
        one factorization or solve at a time."""
        if self._scratch is None:
            dev, n, d, T = self.device, self.nvars, self.d, self.n_tail
            self._scratch = (
                torch.empty((n, d), dtype=F64, device=dev),
                torch.empty((n + T, d), dtype=F64, device=dev),
                torch.empty((T, d), dtype=F64, device=dev),
                torch.empty(T * d, dtype=F64, device=dev),
                torch.zeros((3, n), dtype=I32, device=dev))
        return self._scratch

    def _next_epoch(self, flags):
        """Kernels 13 and 14's number of this factorization or solve, a new
        one each; before the numbers start again the flags are zeroed, so
        none is stale."""
        if self._epoch == 2 ** 31 - 1:
            flags.zero_()
            self._epoch = 0
        self._epoch += 1
        return self._epoch

    def solve(self, arrays, lam=0.0):
        blocks, g = self.system(arrays)
        return self.solve_factored(self.factorize(blocks, lam), g)

    def launches_per_factorization(self) -> dict:
        """Kernel launches of one factorize(): kernel 13 once over every
        leading level and once for the dense root, kernel 7's pivot check
        once (with leading levels), kernel 10 a panel of the root."""
        T = self.n_tail
        return {"sp_level_factor": int(self.L_cut > 0),
                "sp_tail_assemble": int(T > 0),
                "sn_pivot_check": int(self.L_cut > 0),
                "dense_factor_diag": dense_kernels.panels(T * self.d)
                if T else 0}

    def launches_per_solve(self) -> dict:
        """Kernel launches of one solve_factored(): kernel 14 once a
        direction (every level, and the root's rhs or its copy), kernel 11
        once a direction."""
        return {"sp_level_forward": int(len(self.dev.fw["cols"]) > 0),
                "sp_level_backward": int(len(self.dev.bw["cols"]) > 0),
                "dense_forward": int(self.n_tail > 0),
                "dense_backward": int(self.n_tail > 0)}
