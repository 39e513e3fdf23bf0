/* Multilevel nested dissection (METIS-class), original implementation.
 *
 * The reference uses METIS for its ND orderings (gtsam/inference/
 * MetisIndex.h:37, Ordering.h:201 Metis, gtsam_unstable/partition/
 * FindSeparator-inl.h:240 for submap partitioning).  This module provides the
 * same capability natively: multilevel vertex bisection —
 *
 *   coarsen by heavy-edge matching  ->  BFS initial bisection at the
 *   coarsest level  ->  project + boundary Fiduccia–Mattheyses refinement
 *   at every level  ->  vertex separator from the refined edge cut  ->
 *   recurse on the parts, separator ordered LAST; leaves ordered by the
 *   native AMD (amd.c).
 *
 * Exposed via ctypes (gtsam_torch/native/__init__.py):
 *   nd_order(n, indptr, indices, perm, leaf_size)   CSR symmetric, no diag
 *   nd_bisect(n, indptr, indices, part)             part[i] in {0,1,2=sep}
 * Both return 0 on success, -1 on allocation failure.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int32_t i32;
typedef int64_t i64;

int amd_order(i32 n, const i64 *indptr, const i32 *indices, i32 *perm,
              const uint8_t *cperm);

typedef struct {
  i32 n;
  i64 *xadj;   /* n+1 */
  i32 *adj;    /* edges (both directions) */
  i32 *vwgt;   /* vertex weights (fine-vertex counts) */
  i32 *ewgt;   /* edge weights (contracted multiplicities) */
} Graph;

static int graph_alloc(Graph *g, i32 n, i64 m) {
  g->n = n;
  g->xadj = (i64 *)malloc(sizeof(i64) * (n + 1));
  g->adj = (i32 *)malloc(sizeof(i32) * (m > 0 ? m : 1));
  g->vwgt = (i32 *)malloc(sizeof(i32) * (n > 0 ? n : 1));
  g->ewgt = (i32 *)malloc(sizeof(i32) * (m > 0 ? m : 1));
  return (g->xadj && g->adj && g->vwgt && g->ewgt) ? 0 : -1;
}

static void graph_free(Graph *g) {
  free(g->xadj); free(g->adj); free(g->vwgt); free(g->ewgt);
  g->xadj = NULL; g->adj = NULL; g->vwgt = NULL; g->ewgt = NULL;
}

/* ---- heavy-edge matching ---- */
static i32 match_heavy(const Graph *g, i32 *cmap) {
  i32 n = g->n;
  i32 *match = (i32 *)malloc(sizeof(i32) * n);
  if (!match) return -1;
  for (i32 i = 0; i < n; ++i) match[i] = -1;
  /* visit in increasing-degree order (classic HEM heuristic) */
  i32 *ord = (i32 *)malloc(sizeof(i32) * n);
  i32 *cnt = (i32 *)calloc(n + 2, sizeof(i32));
  if (!ord || !cnt) { free(match); free(ord); free(cnt); return -1; }
  i32 maxd = 0;
  for (i32 i = 0; i < n; ++i) {
    i32 d = (i32)(g->xadj[i + 1] - g->xadj[i]);
    if (d > maxd) maxd = d;
  }
  /* counting sort by degree */
  for (i32 i = 0; i < n; ++i)
    cnt[(i32)(g->xadj[i + 1] - g->xadj[i]) + 1]++;
  for (i32 d = 1; d <= maxd + 1; ++d) cnt[d] += cnt[d - 1];
  for (i32 i = 0; i < n; ++i)
    ord[cnt[(i32)(g->xadj[i + 1] - g->xadj[i])]++] = i;

  i32 cn = 0;
  for (i32 k = 0; k < n; ++k) {
    i32 v = ord[k];
    if (match[v] >= 0) continue;
    i32 best = -1, bw = -1;
    for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e) {
      i32 u = g->adj[e];
      if (u != v && match[u] < 0 && g->ewgt[e] > bw) {
        bw = g->ewgt[e];
        best = u;
      }
    }
    if (best >= 0) {
      match[v] = best;
      match[best] = v;
      cmap[v] = cn;
      cmap[best] = cn;
    } else {
      match[v] = v;
      cmap[v] = cn;
    }
    cn++;
  }
  free(match); free(ord); free(cnt);
  return cn;
}

/* contract g by cmap into cg (cn coarse vertices) */
static int contract(const Graph *g, const i32 *cmap, i32 cn, Graph *cg) {
  i32 n = g->n;
  i64 m = g->xadj[n];
  if (graph_alloc(cg, cn, m)) return -1;
  i32 *tag = (i32 *)malloc(sizeof(i32) * cn);
  i64 *pos = (i64 *)malloc(sizeof(i64) * cn);
  if (!tag || !pos) { free(tag); free(pos); return -1; }
  for (i32 i = 0; i < cn; ++i) tag[i] = -1, cg->vwgt[i] = 0;
  for (i32 v = 0; v < n; ++v) cg->vwgt[cmap[v]] += g->vwgt[v];

  /* coarse adjacency: group fine vertices by coarse id */
  i32 *chead = (i32 *)malloc(sizeof(i32) * cn);
  i32 *cnext = (i32 *)malloc(sizeof(i32) * n);
  if (!chead || !cnext) { free(tag); free(pos); free(chead); free(cnext); return -1; }
  for (i32 i = 0; i < cn; ++i) chead[i] = -1;
  for (i32 v = n - 1; v >= 0; --v) {
    cnext[v] = chead[cmap[v]];
    chead[cmap[v]] = v;
  }
  i64 top = 0;
  for (i32 c = 0; c < cn; ++c) {
    cg->xadj[c] = top;
    for (i32 v = chead[c]; v >= 0; v = cnext[v]) {
      for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e) {
        i32 cu = cmap[g->adj[e]];
        if (cu == c) continue;
        if (tag[cu] != c) {
          tag[cu] = c;
          pos[cu] = top;
          cg->adj[top] = cu;
          cg->ewgt[top] = g->ewgt[e];
          top++;
        } else {
          cg->ewgt[pos[cu]] += g->ewgt[e];
        }
      }
    }
  }
  cg->xadj[cn] = top;
  free(tag); free(pos); free(chead); free(cnext);
  return 0;
}

/* ---- initial bisection: BFS from a pseudo-peripheral vertex ---- */
static int initial_partition(const Graph *g, i32 *part) {
  i32 n = g->n;
  if (n == 0) return 0;
  i32 *queue = (i32 *)malloc(sizeof(i32) * n);
  i32 *seen = (i32 *)calloc(n, sizeof(i32));
  if (!queue || !seen) { free(queue); free(seen); return -1; }

  i32 start = 0;
  for (int round = 0; round < 2; ++round) {   /* 2 BFS sweeps -> peripheral */
    i32 qh = 0, qt = 0;
    memset(seen, 0, sizeof(i32) * n);
    queue[qt++] = start;
    seen[start] = 1;
    i32 last = start;
    while (qh < qt) {
      i32 v = queue[qh++];
      last = v;
      for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e) {
        i32 u = g->adj[e];
        if (!seen[u]) { seen[u] = 1; queue[qt++] = u; }
      }
    }
    /* disconnected leftovers: append */
    for (i32 v = 0; v < n && qt < n; ++v)
      if (!seen[v]) { seen[v] = 1; queue[qt++] = v; }
    start = last;
  }
  /* final BFS order in queue[]; grow side 0 to half the total weight */
  i64 tot = 0;
  for (i32 i = 0; i < n; ++i) tot += g->vwgt[i];
  i64 acc = 0;
  for (i32 k = 0; k < n; ++k) {
    i32 v = queue[k];
    part[v] = (acc * 2 < tot) ? 0 : 1;
    acc += g->vwgt[v];
  }
  free(queue); free(seen);
  return 0;
}

/* ---- boundary FM refinement (simplified, greedy positive-gain passes) ---- */
static void fm_refine(const Graph *g, i32 *part, int passes) {
  i32 n = g->n;
  i64 tot = 0;
  i64 w0 = 0;
  for (i32 i = 0; i < n; ++i) {
    tot += g->vwgt[i];
    if (part[i] == 0) w0 += g->vwgt[i];
  }
  i64 lo = (i64)(tot * 45LL) / 100, hi = (i64)(tot * 55LL) / 100;
  i32 *gain = (i32 *)malloc(sizeof(i32) * n);
  if (!gain) return;
  for (int pass = 0; pass < passes; ++pass) {
    /* gains: (cut edges to other side) - (edges to own side) */
    for (i32 v = 0; v < n; ++v) {
      i32 gsum = 0;
      for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e)
        gsum += (part[g->adj[e]] != part[v]) ? g->ewgt[e] : -g->ewgt[e];
      gain[v] = gsum;
    }
    i32 moved = 0;
    for (i32 v = 0; v < n; ++v) {
      if (gain[v] <= 0) continue;
      i64 nw0 = part[v] == 0 ? w0 - g->vwgt[v] : w0 + g->vwgt[v];
      if (nw0 < lo || nw0 > hi) continue;
      /* move v; update neighbor gains locally */
      part[v] ^= 1;
      w0 = nw0;
      gain[v] = -gain[v];
      for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e) {
        i32 u = g->adj[e];
        gain[u] += (part[u] != part[v]) ? 2 * g->ewgt[e]
                                        : -2 * g->ewgt[e];
      }
      moved++;
    }
    if (!moved) break;
  }
  free(gain);
}

#define COARSEST 96

static int bisect_ml(Graph *g, i32 *part) {
  if (g->n <= COARSEST) {
    if (initial_partition(g, part)) return -1;
    fm_refine(g, part, 6);
    return 0;
  }
  i32 *cmap = (i32 *)malloc(sizeof(i32) * g->n);
  if (!cmap) return -1;
  i32 cn = match_heavy(g, cmap);
  if (cn < 0) { free(cmap); return -1; }
  if (cn >= g->n * 95 / 100) {
    /* matching stalled (star graphs etc.): bisect directly */
    free(cmap);
    if (initial_partition(g, part)) return -1;
    fm_refine(g, part, 6);
    return 0;
  }
  Graph cg;
  if (contract(g, cmap, cn, &cg)) { free(cmap); return -1; }
  i32 *cpart = (i32 *)malloc(sizeof(i32) * cn);
  if (!cpart) { graph_free(&cg); free(cmap); return -1; }
  int rc = bisect_ml(&cg, cpart);
  graph_free(&cg);
  if (rc) { free(cmap); free(cpart); return rc; }
  for (i32 v = 0; v < g->n; ++v) part[v] = cpart[cmap[v]];
  free(cmap); free(cpart);
  fm_refine(g, part, 3);
  return 0;
}

/* vertex separator from an edge bisection: greedy minimum vertex cover of
 * the cut edges (take the endpoint covering the most uncovered cut edges
 * first — approximates the METIS edge->vertex separator conversion) */
static i64 vertex_separator(const Graph *g, i32 *part) {
  i32 n = g->n;
  i32 *cutdeg = (i32 *)calloc(n, sizeof(i32));
  if (!cutdeg) return 0;
  i32 maxcd = 0;
  for (i32 v = 0; v < n; ++v) {
    for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e)
      if (part[g->adj[e]] == (part[v] ^ 1)) cutdeg[v]++;
    if (cutdeg[v] > maxcd) maxcd = cutdeg[v];
  }
  /* bucket queue over cut degree (max-first) */
  i32 *bhead = (i32 *)malloc(sizeof(i32) * (maxcd + 1));
  i32 *bnext = (i32 *)malloc(sizeof(i32) * n);
  i32 *bprev = (i32 *)malloc(sizeof(i32) * n);
  uint8_t *inq = (uint8_t *)calloc(n, 1);
  if (!bhead || !bnext || !bprev || !inq) {
    free(cutdeg); free(bhead); free(bnext); free(bprev); free(inq);
    return 0;
  }
  for (i32 d = 0; d <= maxcd; ++d) bhead[d] = -1;
  for (i32 v = 0; v < n; ++v) {
    if (cutdeg[v] == 0) continue;
    bnext[v] = bhead[cutdeg[v]];
    bprev[v] = -1;
    if (bhead[cutdeg[v]] >= 0) bprev[bhead[cutdeg[v]]] = v;
    bhead[cutdeg[v]] = v;
    inq[v] = 1;
  }
  i64 nsep = 0;
  i32 cur = maxcd;
  while (cur > 0) {
    if (bhead[cur] < 0) { cur--; continue; }
    i32 v = bhead[cur];
    /* unlink + move to separator */
    bhead[cur] = bnext[v];
    if (bnext[v] >= 0) bprev[bnext[v]] = -1;
    inq[v] = 0;
    i32 oldside = part[v];
    part[v] = 2;
    nsep++;
    /* covered cut edges: decrement neighbors' cut degrees */
    for (i64 e = g->xadj[v]; e < g->xadj[v + 1]; ++e) {
      i32 u = g->adj[e];
      if (part[u] != (oldside ^ 1) || !inq[u]) continue;
      i32 du = cutdeg[u];
      /* unlink u from bucket du */
      if (bprev[u] >= 0) bnext[bprev[u]] = bnext[u];
      else bhead[du] = bnext[u];
      if (bnext[u] >= 0) bprev[bnext[u]] = bprev[u];
      cutdeg[u] = du - 1;
      if (cutdeg[u] > 0) {
        bnext[u] = bhead[cutdeg[u]];
        bprev[u] = -1;
        if (bhead[cutdeg[u]] >= 0) bprev[bhead[cutdeg[u]]] = u;
        bhead[cutdeg[u]] = u;
      } else {
        inq[u] = 0;
      }
    }
  }
  free(cutdeg); free(bhead); free(bnext); free(bprev); free(inq);
  return nsep;
}

/* ---- recursion ---- */

typedef struct {
  i32 *perm;       /* output, global ids in elimination order */
  i64 emitted;
  i32 leaf_size;
} NDCtx;

static int nd_rec(NDCtx *ctx, i32 n, i64 *xadj, i32 *adj, i32 *gid);

static int nd_leaf(NDCtx *ctx, i32 n, i64 *xadj, i32 *adj, i32 *gid) {
  i32 *lperm = (i32 *)malloc(sizeof(i32) * (n > 0 ? n : 1));
  if (!lperm) return -1;
  if (amd_order(n, xadj, adj, lperm, NULL)) { free(lperm); return -1; }
  for (i32 k = 0; k < n; ++k)
    ctx->perm[ctx->emitted++] = gid[lperm[k]];
  free(lperm);
  return 0;
}

/* extract the subgraph of vertices with mask[v]==want into fresh arrays */
static int extract(i32 n, const i64 *xadj, const i32 *adj, const i32 *gid,
                   const i32 *mask, i32 want, i32 *sn_out, i64 **sxadj,
                   i32 **sadj, i32 **sgid) {
  i32 *lid = (i32 *)malloc(sizeof(i32) * n);
  if (!lid) return -1;
  i32 sn = 0;
  for (i32 v = 0; v < n; ++v) lid[v] = (mask[v] == want) ? sn++ : -1;
  i64 sm = 0;
  for (i32 v = 0; v < n; ++v) {
    if (lid[v] < 0) continue;
    for (i64 e = xadj[v]; e < xadj[v + 1]; ++e)
      if (lid[adj[e]] >= 0) sm++;
  }
  *sxadj = (i64 *)malloc(sizeof(i64) * (sn + 1));
  *sadj = (i32 *)malloc(sizeof(i32) * (sm > 0 ? sm : 1));
  *sgid = (i32 *)malloc(sizeof(i32) * (sn > 0 ? sn : 1));
  if (!*sxadj || !*sadj || !*sgid) { free(lid); return -1; }
  i64 top = 0;
  i32 c = 0;
  for (i32 v = 0; v < n; ++v) {
    if (lid[v] < 0) continue;
    (*sxadj)[c] = top;
    (*sgid)[c] = gid[v];
    for (i64 e = xadj[v]; e < xadj[v + 1]; ++e)
      if (lid[adj[e]] >= 0) (*sadj)[top++] = lid[adj[e]];
    c++;
  }
  (*sxadj)[sn] = top;
  *sn_out = sn;
  free(lid);
  return 0;
}

static int nd_rec(NDCtx *ctx, i32 n, i64 *xadj, i32 *adj, i32 *gid) {
  if (n <= ctx->leaf_size)
    return nd_leaf(ctx, n, xadj, adj, gid);
  Graph g;
  g.n = n; g.xadj = xadj; g.adj = adj;
  g.vwgt = (i32 *)malloc(sizeof(i32) * n);
  g.ewgt = (i32 *)malloc(sizeof(i32) * (xadj[n] > 0 ? xadj[n] : 1));
  i32 *part = (i32 *)malloc(sizeof(i32) * n);
  i32 *part2 = (i32 *)malloc(sizeof(i32) * n);
  if (!g.vwgt || !g.ewgt || !part || !part2) return -1;
  for (i32 i = 0; i < n; ++i) g.vwgt[i] = 1;
  for (i64 e = 0; e < xadj[n]; ++e) g.ewgt[e] = 1;
  /* two candidate bisections — multilevel HEM+FM, and plain BFS-grow+FM
   * (BFS 'latitude' cuts are near-optimal on geometric graphs like pose
   * spheres/grids; multilevel wins on irregular graphs) — keep the one
   * with the smaller vertex separator */
  int rc = bisect_ml(&g, part);
  if (rc) { free(g.vwgt); free(g.ewgt); free(part); free(part2); return rc; }
  rc = initial_partition(&g, part2);
  if (rc) { free(g.vwgt); free(g.ewgt); free(part); free(part2); return rc; }
  fm_refine(&g, part2, 6);
  i64 n0 = 0, n1 = 0;
  for (i32 v = 0; v < n; ++v) { if (part[v] == 0) n0++; else n1++; }
  i64 s1 = (n0 && n1) ? vertex_separator(&g, part) : (i64)n + 1;
  n0 = n1 = 0;
  for (i32 v = 0; v < n; ++v) { if (part2[v] == 0) n0++; else n1++; }
  i64 s2 = (n0 && n1) ? vertex_separator(&g, part2) : (i64)n + 1;
  if (s2 < s1) { i32 *t = part; part = part2; part2 = t; s1 = s2; }
  free(part2);
  if (s1 > n) {   /* both degenerate -> AMD the whole thing */
    free(g.vwgt); free(g.ewgt); free(part);
    return nd_leaf(ctx, n, xadj, adj, gid);
  }
  free(g.vwgt); free(g.ewgt);

  for (i32 side = 0; side < 2; ++side) {
    i32 sn; i64 *sxadj; i32 *sadj, *sgid;
    if (extract(n, xadj, adj, gid, part, side, &sn, &sxadj, &sadj, &sgid)) {
      free(part); return -1;
    }
    if (sn > 0) {
      rc = nd_rec(ctx, sn, sxadj, sadj, sgid);
      if (rc) { free(sxadj); free(sadj); free(sgid); free(part); return rc; }
    }
    free(sxadj); free(sadj); free(sgid);
  }
  /* separator last, AMD-ordered on its induced subgraph for fat separators */
  {
    i32 sn; i64 *sxadj; i32 *sadj, *sgid;
    if (extract(n, xadj, adj, gid, part, 2, &sn, &sxadj, &sadj, &sgid)) {
      free(part); return -1;
    }
    if (sn > 0) rc = nd_leaf(ctx, sn, sxadj, sadj, sgid);
    free(sxadj); free(sadj); free(sgid);
  }
  free(part);
  return rc;
}

int nd_order(i32 n, const i64 *indptr, const i32 *indices, i32 *perm,
             i32 leaf_size) {
  if (n <= 0) return 0;
  NDCtx ctx;
  ctx.perm = perm;
  ctx.emitted = 0;
  ctx.leaf_size = leaf_size > 1 ? leaf_size : 32;
  /* copy so recursion owns mutable arrays */
  i64 m = indptr[n];
  i64 *xadj = (i64 *)malloc(sizeof(i64) * (n + 1));
  i32 *adj = (i32 *)malloc(sizeof(i32) * (m > 0 ? m : 1));
  i32 *gid = (i32 *)malloc(sizeof(i32) * n);
  if (!xadj || !adj || !gid) return -1;
  memcpy(xadj, indptr, sizeof(i64) * (n + 1));
  /* strip self loops */
  i64 top = 0;
  for (i32 v = 0; v < n; ++v) {
    i64 s = xadj[v];
    xadj[v] = top;
    for (i64 e = s; e < indptr[v + 1]; ++e)
      if (indices[e] != v) adj[top++] = indices[e];
  }
  xadj[n] = top;
  for (i32 i = 0; i < n; ++i) gid[i] = i;
  int rc = nd_rec(&ctx, n, xadj, adj, gid);
  free(xadj); free(adj); free(gid);
  if (rc == 0 && ctx.emitted != n) return -1;
  return rc;
}

/* one-shot balanced vertex bisection (P5 partition cut): part[i] in
 * {0, 1, 2=separator} */
int nd_bisect(i32 n, const i64 *indptr, const i32 *indices, i32 *part) {
  if (n <= 0) return 0;
  Graph g;
  i64 m = indptr[n];
  g.n = n;
  g.xadj = (i64 *)malloc(sizeof(i64) * (n + 1));
  g.adj = (i32 *)malloc(sizeof(i32) * (m > 0 ? m : 1));
  g.vwgt = (i32 *)malloc(sizeof(i32) * n);
  g.ewgt = (i32 *)malloc(sizeof(i32) * (m > 0 ? m : 1));
  if (!g.xadj || !g.adj || !g.vwgt || !g.ewgt) return -1;
  i64 top = 0;
  for (i32 v = 0; v < n; ++v) {
    g.xadj[v] = top;
    for (i64 e = indptr[v]; e < indptr[v + 1]; ++e)
      if (indices[e] != v) g.adj[top++] = indices[e];
    g.vwgt[v] = 1;
  }
  g.xadj[n] = top;
  for (i64 e = 0; e < top; ++e) g.ewgt[e] = 1;
  int rc = bisect_ml(&g, part);
  if (rc == 0) vertex_separator(&g, part);
  graph_free(&g);
  return rc;
}
