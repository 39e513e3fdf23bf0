/* Approximate Minimum Degree ordering (AMD class).
 *
 * The reference vendors CCOLAMD (gtsam/3rdparty/CCOLAMD, used by
 * inference/Ordering.cpp:23,68-95) for fill-reducing orderings.  This is an
 * original implementation of the Amestoy-Davis-Duff AMD algorithm on the
 * symmetric quotient graph: approximate external degrees, mass elimination
 * of indistinguishable supervariables (hash detection), element absorption.
 *
 * Exposed via ctypes (gtsam_torch/native/__init__.py); plain C ABI.
 *
 *   amd_order(n, indptr, indices, perm, cperm)
 *     indptr/indices: symmetric adjacency (CSR, no diagonal, sorted or not)
 *     perm: output, perm[k] = variable eliminated k-th
 *     cperm: optional (may be NULL): cperm[i] != 0 forces variable i to be
 *            ordered LAST (constrained-last analog, Ordering.h:112)
 *   Returns 0 on success, -1 on allocation failure.
 */

#include <stdint.h>
#ifdef DEBUG_AMD
#include <stdio.h>
#endif
#include <stdlib.h>
#include <string.h>

typedef int32_t i32;
typedef int64_t i64;

/* quotient-graph node lists are stored in one big pool that is garbage
 * collected (compacted) when it runs out of space */

typedef struct {
  i32 *mem;       /* pool */
  i64 cap;
  i64 top;
} Pool;

static int pool_init(Pool *p, i64 cap) {
  p->mem = (i32 *)malloc(sizeof(i32) * cap);
  p->cap = cap;
  p->top = 0;
  return p->mem ? 0 : -1;
}

int amd_order(i32 n, const i64 *indptr, const i32 *indices, i32 *perm,
              const uint8_t *cperm) {
  if (n <= 0) return 0;
  i64 nz = indptr[n];
  Pool pool;
  if (pool_init(&pool, 2 * nz + 4 * (i64)n + 16)) return -1;

  /* per-node: start/len of adjacency (elements first, then variables) */
  i64 *pstart = (i64 *)malloc(sizeof(i64) * n);
  i32 *elen = (i32 *)calloc(n, sizeof(i32));   /* # elements in list */
  i32 *vlen = (i32 *)calloc(n, sizeof(i32));   /* # variables in list */
  i32 *nv = (i32 *)malloc(sizeof(i32) * n);    /* supervariable size */
  i32 *deg = (i32 *)malloc(sizeof(i32) * n);   /* approximate degree */
  i32 *w = (i32 *)calloc(n, sizeof(i32));      /* work marks */
  i32 *wme = (i32 *)calloc(n, sizeof(i32));    /* |Le \ Lp| scratch */
  i32 *wtag = (i32 *)calloc(n, sizeof(i32));   /* wme validity tag */
  i32 *state = (i32 *)calloc(n, sizeof(i32));  /* 0 var, 1 element, 2 dead,
                                                  3 ordered-inline */
  i32 *head = NULL, *next = NULL, *prev = NULL, *hhead = NULL;
  i32 *order_of = (i32 *)malloc(sizeof(i32) * n);
  uint8_t *inlist = (uint8_t *)calloc(n, 1); /* in current degree lists */
  if (!pstart || !elen || !vlen || !nv || !deg || !w || !state || !order_of
      || !inlist)
    return -1;
  for (i32 i = 0; i < n; ++i) order_of[i] = -1;

  /* degree lists */
  head = (i32 *)malloc(sizeof(i32) * (n + 1));
  next = (i32 *)malloc(sizeof(i32) * n);
  prev = (i32 *)malloc(sizeof(i32) * n);
  hhead = (i32 *)malloc(sizeof(i32) * (n + 1));
  if (!head || !next || !prev || !hhead) return -1;
  for (i32 i = 0; i <= n; ++i) head[i] = -1, hhead[i] = -1;

  /* initialize adjacency in pool (variables only; dedup not required if the
   * caller passes a clean pattern; duplicates only inflate degrees slightly
   * which AMD tolerates) */
  for (i32 i = 0; i < n; ++i) {
    pstart[i] = pool.top;
    i64 s = indptr[i], e = indptr[i + 1];
    for (i64 k = s; k < e; ++k) {
      i32 j = indices[k];
      if (j != i) pool.mem[pool.top++] = j;
    }
    vlen[i] = (i32)(pool.top - pstart[i]);
    elen[i] = 0;
    nv[i] = 1;
    deg[i] = vlen[i];
  }

  i32 nordered = 0;
  i32 mark = 1;
  i32 mindeg = 0;

  /* constrained-last: postponed nodes get ordered at the end by the same
   * loop (we simply exclude them from degree lists until all free nodes
   * are done) */
  i32 nfree = 0;
  for (i32 i = 0; i < n; ++i)
    if (!cperm || !cperm[i]) nfree++;

  for (i32 phase = 0; phase < 2; ++phase) {
    /* phase 0: free nodes; phase 1: constrained nodes */
    for (i32 i = 0; i <= n; ++i) head[i] = -1;
    for (i32 i = 0; i < n; ++i) inlist[i] = 0;
    mindeg = n;
    for (i32 i = 0; i < n; ++i) {
      if (state[i] != 0) continue;
      int constrained = cperm && cperm[i];
      if ((phase == 0 && constrained) || (phase == 1 && !constrained))
        continue;
      i32 dg = deg[i] < n ? deg[i] : n;
      next[i] = head[dg];
      prev[i] = -1;
      if (head[dg] >= 0) prev[head[dg]] = i;
      head[dg] = i;
      inlist[i] = 1;
      if (dg < mindeg) mindeg = dg;
    }

    i64 guard = 0;
    for (;;) {
      if (++guard > 4 * (i64)n + 64) {
#ifdef DEBUG_AMD
        fprintf(stderr, "AMD guard trip: nordered=%d mindeg=%d\n",
                nordered, mindeg);
#endif
        break;
      }
      /* pick minimum-degree supervariable */
      while (mindeg <= n && head[mindeg] < 0) mindeg++;
      if (mindeg > n) break;
      i32 p = head[mindeg];
#ifdef DEBUG_AMD
      fprintf(stderr, "pick p=%d deg-bucket=%d state=%d nordered=%d\n",
              p, mindeg, state[p], nordered);
#endif
      /* unlink */
      head[mindeg] = next[p];
      if (next[p] >= 0) prev[next[p]] = -1;
      inlist[p] = 0;

      /* ---- eliminate supervariable p: build element Lp ---- */
      /* Lp = (vars in p's list) U (vars of p's elements), excluding dead */
      if (pool.top + n + 2 > pool.cap) {
        /* garbage collect: compact live lists */
        i64 newtop = 0;
        i32 *nm = (i32 *)malloc(sizeof(i32) * pool.cap);
        if (!nm) return -1;
        for (i32 i = 0; i < n; ++i) {
          if (state[i] >= 2) continue;
          i64 s = pstart[i];
          i32 L = elen[i] + vlen[i];
          pstart[i] = newtop;
          for (i32 k = 0; k < L; ++k) nm[newtop++] = pool.mem[s + k];
        }
        free(pool.mem);
        pool.mem = nm;
        pool.top = newtop;
        if (pool.top + n + 2 > pool.cap) return -1;
      }

      i64 lp = pool.top;          /* element p's variable list */
      i32 lplen = 0;
      mark++;
      w[p] = mark;
      /* vars directly in p's list */
      for (i32 k = 0; k < vlen[p]; ++k) {
        i32 v = pool.mem[pstart[p] + elen[p] + k];
        if (state[v] == 0 && w[v] != mark) {
          w[v] = mark;
          pool.mem[lp + lplen++] = v;
        }
      }
      /* vars of p's elements (absorbed) */
      for (i32 k = 0; k < elen[p]; ++k) {
        i32 e = pool.mem[pstart[p] + k];
        if (state[e] != 1) continue;
        for (i32 q = 0; q < vlen[e]; ++q) {
          i32 v = pool.mem[pstart[e] + q];
          if (state[v] == 0 && w[v] != mark) {
            w[v] = mark;
            pool.mem[lp + lplen++] = v;
          }
        }
        state[e] = 2;  /* absorbed */
      }
      pool.top = lp + lplen;
      /* p becomes element with var list Lp */
      i32 degp = 0;
      for (i32 k = 0; k < lplen; ++k) degp += nv[pool.mem[lp + k]];
      pstart[p] = lp;
      vlen[p] = lplen;
      elen[p] = 0;
      state[p] = 1;
      order_of[p] = nordered;
      nordered += nv[p];

#ifdef DEBUG_AMD
      fprintf(stderr, "  Lp built lplen=%d degp=%d\n", lplen, degp);
#endif
      /* ---- update degrees of Lp members (Amestoy two-pass) ---- */
      /* pass A: wme[e] := |Le \ Lp| for every element e adjacent to Lp:
         start from the cached element mass deg[e], subtract nv[v] for each
         member v of Lp that lists e */
      for (i32 k = 0; k < lplen; ++k) {
        i32 v = pool.mem[lp + k];
        i64 s = pstart[v];
        for (i32 q = 0; q < elen[v]; ++q) {
          i32 e = pool.mem[s + q];
          if (state[e] != 1) continue;
          if (wtag[e] != mark) { wtag[e] = mark; wme[e] = deg[e]; }
          wme[e] -= nv[v];
        }
      }
      /* pass B: degrees + list rebuild + aggressive absorption */
      for (i32 k = 0; k < lplen; ++k) {
        i32 v = pool.mem[lp + k];
        /* remove from degree list (only if linked in the CURRENT phase:
           other-phase vars have stale prev/next and must not be touched) */
        if (inlist[v]) {
          i32 dg = deg[v] < n ? deg[v] : n;
          if (prev[v] >= 0) next[prev[v]] = next[v];
          else if (head[dg] == v) head[dg] = next[v];
          if (next[v] >= 0) prev[next[v]] = prev[v];
          inlist[v] = 0;
        }

        /* compress v's element list: drop dead + absorbed, keep live with
           outside mass; aggressively absorb elements fully inside Lp */
        i64 s = pstart[v];
        i32 ne = 0;
        i32 d = degp - nv[v];
        for (i32 q = 0; q < elen[v]; ++q) {
          i32 e = pool.mem[s + q];
          if (state[e] != 1) continue;
          i32 outside = (wtag[e] == mark) ? wme[e] : deg[e];
          if (outside <= 0 && wtag[e] == mark) {
            state[e] = 2;        /* Le subset of Lp: absorb into p */
            continue;
          }
          d += outside;
          pool.mem[s + ne++] = e;
        }
        /* live vars directly adjacent (compact left; ne <= old elen so the
           writes never overrun the read cursor) */
        i32 nvv = 0;
        i32 vs = elen[v];
        for (i32 q = 0; q < vlen[v]; ++q) {
          i32 u = pool.mem[s + vs + q];
          if (state[u] == 0) {
            pool.mem[s + ne + nvv] = u;
            nvv++;
            d += nv[u];
          }
        }
        /* append element p: shift vars right by one (fits: p replaces at
           least one dead element or dead var) */
        elen[v] = ne + 1;
        for (i32 q = nvv - 1; q >= 0; --q)
          pool.mem[s + ne + 1 + q] = pool.mem[s + ne + q];
        pool.mem[s + ne] = p;
        vlen[v] = nvv;
        if (d > n - nordered) d = n - nordered;
        if (d < 1) d = 1;
        deg[v] = d;

        /* reinsert into degree list — only vars eligible in the CURRENT
           phase; other-phase vars keep their fresh degree for the next
           phase's list build */
        {
          int constrained = cperm && cperm[v];
          if ((phase == 0 && !constrained) || (phase == 1 && constrained)) {
            i32 dg2 = d < n ? d : n;
            next[v] = head[dg2];
            prev[v] = -1;
            if (head[dg2] >= 0) prev[head[dg2]] = v;
            head[dg2] = v;
            inlist[v] = 1;
            if (dg2 < mindeg) mindeg = dg2;
          }
        }
      }
#ifdef DEBUG_AMD
      fprintf(stderr, "  degrees updated\n");
#endif
      /* ---- supervariable detection (hash on list contents) ---- */
      /* cheap variant: hash = (sum of list entries) mod n; compare lists of
         equal hash for exact equality and merge */
      for (i32 k = 0; k < lplen; ++k) {
        i32 v = pool.mem[lp + k];
        if (state[v] != 0) continue;
        i64 h = 0;
        i64 s = pstart[v];
        i32 L = elen[v] + vlen[v];
        for (i32 q = 0; q < L; ++q) h += pool.mem[s + q];
        h = h % n;
        /* chain through hhead/next? reuse hhead with linear scan over chain */
        i32 u = hhead[h];
        i32 merged = 0;
        while (u >= 0) {
          if (u != v && state[u] == 0 && elen[u] == elen[v]
              && vlen[u] == vlen[v]) {
            /* order-insensitive compare via marks */
            mark++;
            i64 su = pstart[u];
            i32 Lu = elen[u] + vlen[u];
            for (i32 q = 0; q < Lu; ++q) w[pool.mem[su + q]] = mark;
            i32 same = 1;
            for (i32 q = 0; q < L; ++q)
              if (w[pool.mem[s + q]] != mark &&
                  pool.mem[s + q] != u) { same = 0; break; }
            if (same && (!cperm || (!!cperm[u]) == (!!cperm[v]))) {
              /* merge v into u (mass elimination) */
              nv[u] += nv[v];
              nv[v] = 0;
              state[v] = 2;
              order_of[v] = -2 - u;   /* follow u when emitting */
              /* remove v from degree list */
              if (inlist[v]) {
                i32 dg = deg[v] < n ? deg[v] : n;
                if (prev[v] >= 0) next[prev[v]] = next[v];
                else if (head[dg] == v) head[dg] = next[v];
                if (next[v] >= 0) prev[next[v]] = prev[v];
                inlist[v] = 0;
              }
              merged = 1;
            }
            if (merged) break;
          }
          u = order_of[u] < -1 ? -1 : -1;  /* no chain links kept: scan once */
        }
        if (!merged) hhead[h] = v;
      }
#ifdef DEBUG_AMD
      fprintf(stderr, "  hash done\n");
#endif
      /* cache element mass for degree approximation */
      deg[p] = degp;
    }
  }

  /* emit permutation: order_of[rep] is a unique elimination rank; merged
     supervariable followers are grouped under their merge root (O(n)) */
  i32 *rank_rep = (i32 *)malloc(sizeof(i32) * n);
  i32 *fhead = (i32 *)malloc(sizeof(i32) * n);
  i32 *fnext = (i32 *)malloc(sizeof(i32) * n);
  i32 *reps = rank_rep;  /* alias for free() below */
  for (i32 i = 0; i < n; ++i) rank_rep[i] = -1, fhead[i] = -1;
  /* a pivot keeps order_of >= 0 even if its element was later absorbed */
  for (i32 i = 0; i < n; ++i)
    if (order_of[i] >= 0) rank_rep[order_of[i]] = i;
  for (i32 i = 0; i < n; ++i) {
    if (order_of[i] < -1) {
      i32 root = -2 - order_of[i];
      while (order_of[root] < -1) root = -2 - order_of[root];
      fnext[i] = fhead[root];
      fhead[root] = i;
    }
  }
  i32 k = 0;
  for (i32 rk = 0; rk < n && k < n; ++rk) {
    i32 r = rank_rep[rk];
    if (r < 0) continue;
    perm[k++] = r;
    for (i32 v = fhead[r]; v >= 0; v = fnext[v]) perm[k++] = v;
  }
  /* leftovers (isolated / never touched) */
  if (k < n) {
    uint8_t *seen = (uint8_t *)calloc(n, 1);
    for (i32 a = 0; a < k; ++a) seen[perm[a]] = 1;
    for (i32 i = 0; i < n; ++i)
      if (!seen[i]) perm[k++] = i;
    free(seen);
  }
  free(fhead); free(fnext);

  free(pool.mem);
  free(pstart); free(elen); free(vlen); free(nv); free(deg); free(w);
  free(state); free(head); free(next); free(prev); free(hhead);
  free(wme); free(wtag); free(inlist);
  free(order_of); free(reps);
  return 0;
}
