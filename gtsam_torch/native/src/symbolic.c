/* Native symbolic block-Cholesky analysis.
 *
 * The host-side symbolic phase (inference/symbolic.py) is the per-update /
 * per-graph planning hot loop: elimination structures, level schedule, and
 * update-triple generation.  This C implementation replaces the Python sets
 * with sorted-merge row lists (the reference keeps this phase native too —
 * its entire inference/ module is C++).
 *
 * Exposed via ctypes (see gtsam_torch/native/__init__.py); plain C ABI.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Merge two sorted int32 arrays (unique). Returns new length. */
static int32_t merge_sorted(const int32_t *a, int32_t na, const int32_t *b,
                            int32_t nb, int32_t *out) {
  int32_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) out[k++] = a[i++];
    else if (a[i] > b[j]) out[k++] = b[j++];
    else { out[k++] = a[i]; i++; j++; }
  }
  while (i < na) out[k++] = a[i++];
  while (j < nb) out[k++] = b[j++];
  return k;
}

/* Symbolic elimination on the permuted adjacency.
 *
 * Inputs:
 *   n               number of (block) columns
 *   nbr_indptr/nbr  CSR lower-adjacency in PERMUTED indices: for column j,
 *                   neighbors i > j (sorted)
 * Outputs (caller-allocated):
 *   parent (n)      etree parent or -1
 *   level  (n)      height from leaves
 *   struct_indptr (n+1), struct_rows (cap_rows)  column structures (sorted)
 * Returns total nnz rows, or -1 if cap_rows exceeded.
 */
int64_t symbolic_analyze(int32_t n, const int64_t *nbr_indptr,
                         const int32_t *nbr, int32_t *parent, int32_t *level,
                         int64_t *struct_indptr, int32_t *struct_rows,
                         int64_t cap_rows) {
  /* per-column dynamic row lists */
  int32_t **rows = (int32_t **)calloc(n, sizeof(int32_t *));
  int32_t *len = (int32_t *)calloc(n, sizeof(int32_t));
  int32_t *capa = (int32_t *)calloc(n, sizeof(int32_t));
  int32_t *tmp = NULL;
  int32_t tmp_cap = 0;
  int64_t total = 0;

  for (int32_t j = 0; j < n; ++j) {
    parent[j] = -1;
    level[j] = 0;
  }

  for (int32_t j = 0; j < n; ++j) {
    /* start from original neighbors below j, merged with accumulated fill */
    int32_t na = (int32_t)(nbr_indptr[j + 1] - nbr_indptr[j]);
    const int32_t *a = nbr + nbr_indptr[j];
    int32_t need = na + len[j];
    if (need > tmp_cap) {
      tmp_cap = need * 2 + 16;
      tmp = (int32_t *)realloc(tmp, tmp_cap * sizeof(int32_t));
    }
    int32_t m = merge_sorted(a, na, rows[j], len[j], tmp);
    /* store struct of column j */
    struct_indptr[j] = total;
    if (total + m > cap_rows) { total = -1; goto done; }
    memcpy(struct_rows + total, tmp, m * sizeof(int32_t));
    total += m;
    free(rows[j]);
    rows[j] = NULL;
    len[j] = 0;
    if (m > 0) {
      int32_t p = tmp[0];
      parent[j] = p;
      if (level[j] + 1 > level[p]) level[p] = level[j] + 1;
      /* merge struct\{p} into rows[p] */
      int32_t need_p = len[p] + m - 1;
      int32_t *merged = (int32_t *)malloc((need_p > 0 ? need_p : 1)
                                          * sizeof(int32_t));
      int32_t mp = merge_sorted(tmp + 1, m - 1, rows[p], len[p], merged);
      free(rows[p]);
      rows[p] = merged;
      len[p] = mp;
      capa[p] = need_p;
    }
  }
  struct_indptr[n] = total;

done:
  for (int32_t j = 0; j < n; ++j) free(rows[j]);
  free(rows);
  free(len);
  free(capa);
  free(tmp);
  return total;
}

/* Count update triples per target level (pass 1) or emit them (pass 2).
 *
 * block ids: diagonal of column j is dblock[j]; subdiagonal block (i, j) has
 * id found by binary search in struct_rows[struct_indptr[j]..] with base
 * sub_base[j].
 */
static int64_t find_block(const int64_t *struct_indptr,
                          const int32_t *struct_rows, const int64_t *sub_base,
                          int32_t col, int32_t row) {
  int64_t lo = struct_indptr[col], hi = struct_indptr[col + 1] - 1;
  while (lo <= hi) {
    int64_t mid = (lo + hi) / 2;
    int32_t v = struct_rows[mid];
    if (v == row) return sub_base[col] + (mid - struct_indptr[col]);
    if (v < row) lo = mid + 1;
    else hi = mid - 1;
  }
  return -1;
}

int64_t count_triples(int32_t n, const int64_t *struct_indptr) {
  int64_t total = 0;
  for (int32_t k = 0; k < n; ++k) {
    int64_t m = struct_indptr[k + 1] - struct_indptr[k];
    total += m * (m + 1) / 2;
  }
  return total;
}

/* Emit triples: for each column k, rows S_k; for a<=b in S_k:
 *   target block (S_k[b], S_k[a])  [note b >= a so row >= col]
 *   via blocks (S_k[a], k), (S_k[b], k) -- wait convention below.
 * We emit: target = block(i=S[b], j=S[a])?  The python code emits for
 * a <= b over sorted S: target (i=S[b], j=S[a]) with i >= j:
 *   tr_target = block(i, j), tr_ik = block(i, k), tr_jk = block(j, k)
 * grouped by level of j.  Here we just emit flat arrays; grouping by level
 * happens in numpy (cheap vectorized).
 */
int64_t emit_triples(int32_t n, const int64_t *struct_indptr,
                     const int32_t *struct_rows, const int64_t *sub_base,
                     const int32_t *dblock, int32_t *t_target, int32_t *t_ik,
                     int32_t *t_jk, int32_t *t_level,
                     const int32_t *level_of_col) {
  int64_t out = 0;
  for (int32_t k = 0; k < n; ++k) {
    int64_t s0 = struct_indptr[k], s1 = struct_indptr[k + 1];
    for (int64_t a = s0; a < s1; ++a) {
      int32_t j = struct_rows[a];
      int64_t bjk = sub_base[k] + (a - s0);
      for (int64_t b = a; b < s1; ++b) {
        int32_t i = struct_rows[b];
        int64_t tgt;
        if (i == j) tgt = dblock[j];
        else tgt = find_block(struct_indptr, struct_rows, sub_base, j, i);
        int64_t bik = sub_base[k] + (b - s0);
        t_target[out] = (int32_t)tgt;
        t_ik[out] = (int32_t)bik;
        t_jk[out] = (int32_t)bjk;
        t_level[out] = level_of_col[j];
        out++;
      }
    }
  }
  return out;
}
