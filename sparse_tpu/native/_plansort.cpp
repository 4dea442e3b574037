// Native helpers for host-side plan construction (symbolic passes).
//
// The once-per-pattern symbolic passes (SpGEMM product schedules, RCM) are
// dominated by argsorts of fused integer keys; NumPy's
// comparison sort runs at ~1 M keys/s on the small deployment hosts this
// library targets.  This stable LSD radix argsort is ~10x faster and keeps
// plan-build latency proportionate to the transfer/compile costs around it.
//
// Build: g++ -O3 -shared -fPIC -o _plansort.so _plansort.cpp
// (lazy, via sparse_tpu/native/plansort.py; NumPy fallback if unavailable).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Stable argsort of u64 keys: fills idx with a permutation such that
// keys[idx[i]] is non-decreasing and equal keys keep input order.
// Returns 0 on success, nonzero on bad arguments.
long long radix_argsort_u64(const uint64_t* keys, long long n,
                            long long* idx) {
  if (n < 0 || (n > 0 && (!keys || !idx))) return 1;
  if (n == 0) return 0;
  uint64_t maxk = 0;
  for (long long i = 0; i < n; ++i) {
    idx[i] = i;
    if (keys[i] > maxk) maxk = keys[i];
  }
  int passes = 1;
  while (passes < 8 && (maxk >> (8 * passes)) != 0) ++passes;

  std::vector<long long> tmp(static_cast<size_t>(n));
  long long* src = idx;
  long long* dst = tmp.data();
  long long count[256];
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    std::memset(count, 0, sizeof(count));
    for (long long i = 0; i < n; ++i)
      ++count[(keys[src[i]] >> shift) & 0xff];
    long long pos = 0;
    for (int b = 0; b < 256; ++b) {
      long long c = count[b];
      count[b] = pos;
      pos += c;
    }
    for (long long i = 0; i < n; ++i) {
      const uint64_t d = (keys[src[i]] >> shift) & 0xff;
      dst[count[d]++] = src[i];
    }
    long long* t = src;
    src = dst;
    dst = t;
  }
  if (src != idx) std::memcpy(idx, src, sizeof(long long) * n);
  return 0;
}

}  // extern "C"

#include <algorithm>

extern "C" {

// SpGEMM product schedule (the symbolic pass of ops/spgemm.py:
// spgemm_prepare): enumerate every scalar product (A entry x matching
// prepared-B entry), sort by output coordinate (row-major), and emit the
// packed schedule + output CSR structure.  One enumeration pass + one
// radix argsort + one emission pass, all O(F).
//
// Inputs: A's row pointer/indices (valid entries packed first), prepared
// B's per-row starts (b_starts, length m+1), per-position output column
// (b_cols) and original storage position (b_src).  F = caller-computed
// product count.  Outputs (length F): a_pos/b_pos/seg in output order;
// out_rows/out_cols hold the nse_out unique coordinates.
// Returns nse_out, or -1 on bad arguments.
long long spgemm_schedule(const long long* a_indptr, long long n,
                          const long long* a_indices,
                          const long long* b_starts, long long m,
                          const long long* b_cols, const long long* b_src,
                          long long k, long long F,
                          long long* a_pos, long long* b_pos, long long* seg,
                          long long* out_rows, long long* out_cols) {
  if (n < 0 || m < 0 || k < 0 || F < 0) return -1;
  std::vector<uint64_t> key(static_cast<size_t>(F));
  long long f = 0;
  const uint64_t kw = static_cast<uint64_t>(k) + 1;
  for (long long r = 0; r < n; ++r) {
    for (long long p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
      const long long s = a_indices[p];
      if (s < 0 || s >= m) return -1;
      for (long long q = b_starts[s]; q < b_starts[s + 1]; ++q) {
        if (f >= F) return -1;
        key[f] = static_cast<uint64_t>(r) * kw +
                 static_cast<uint64_t>(b_cols[q]);
        a_pos[f] = p;
        b_pos[f] = b_src[q];
        ++f;
      }
    }
  }
  if (f != F) return -1;
  std::vector<long long> order(static_cast<size_t>(F));
  if (radix_argsort_u64(key.data(), F, order.data()) != 0) return -1;
  // emit in sorted order, reusing seg as scratch is not possible (outputs
  // alias nothing); permute via gather into temporaries
  std::vector<long long> ta(static_cast<size_t>(F)), tb(static_cast<size_t>(F));
  for (long long i = 0; i < F; ++i) {
    ta[i] = a_pos[order[i]];
    tb[i] = b_pos[order[i]];
  }
  std::memcpy(a_pos, ta.data(), sizeof(long long) * F);
  std::memcpy(b_pos, tb.data(), sizeof(long long) * F);
  long long nse = 0;
  uint64_t prev = ~uint64_t{0};
  for (long long i = 0; i < F; ++i) {
    const uint64_t kk = key[order[i]];
    if (i == 0 || kk != prev) {
      out_rows[nse] = static_cast<long long>(kk / kw);
      out_cols[nse] = static_cast<long long>(kk % kw);
      ++nse;
      prev = kk;
    }
    seg[i] = nse - 1;
  }
  return nse;
}

}  // extern "C"

extern "C" {

// Reverse Cuthill-McKee ordering on the symmetrized pattern (A + A^T).
// The classic bandwidth-reducing permutation: BFS per connected component
// from a minimum-degree seed, frontier neighbours appended in ascending
// symmetrized-degree order (stable over ascending node id), whole order
// reversed at the end.  Matches SciPy's reverse_cuthill_mckee semantics
// (component seed = first unvisited minimum-degree node; per-node stable
// degree sort).  Self-loops and reciprocal duplicates are deduplicated.
//
// Inputs: CSR pattern indptr [n+1] / cols [nnz] of an n x n matrix (column
// order within a row does not matter).  Output: perm [n] with perm[k] = the
// OLD index placed at NEW position k, i.e. A[perm][:, perm] is banded.
// Returns 0 on success, -1 on bad arguments.
long long rcm_order(const long long* indptr, long long n,
                    const long long* cols, long long* perm) {
  if (n < 0 || (n > 0 && (!indptr || !perm))) return -1;
  if (n == 0) return 0;
  const long long nnz = indptr[n];
  if (nnz < 0 || (nnz > 0 && !cols)) return -1;

  // symmetrize + dedup: emit (i,j) and (j,i) per entry, radix sort fused
  // u64 keys, unique.
  std::vector<uint64_t> keys;
  keys.reserve(static_cast<size_t>(2 * nnz));
  const uint64_t un = static_cast<uint64_t>(n);
  for (long long i = 0; i < n; ++i) {
    for (long long p = indptr[i]; p < indptr[i + 1]; ++p) {
      const long long j = cols[p];
      if (j < 0 || j >= n) return -1;
      if (j == static_cast<long long>(i)) continue;  // self-loops: no edge
      keys.push_back(static_cast<uint64_t>(i) * un + static_cast<uint64_t>(j));
      keys.push_back(static_cast<uint64_t>(j) * un + static_cast<uint64_t>(i));
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  const long long ne = static_cast<long long>(keys.size());

  std::vector<long long> adj_ptr(static_cast<size_t>(n) + 1, 0);
  std::vector<long long> adj(static_cast<size_t>(ne));
  for (long long e = 0; e < ne; ++e)
    ++adj_ptr[keys[e] / un + 1];
  for (long long i = 0; i < n; ++i) adj_ptr[i + 1] += adj_ptr[i];
  for (long long e = 0; e < ne; ++e)
    adj[e] = static_cast<long long>(keys[e] % un);  // sorted keys: rows
                                                    // grouped, cols ascending

  std::vector<long long> deg(static_cast<size_t>(n));
  for (long long i = 0; i < n; ++i) deg[i] = adj_ptr[i + 1] - adj_ptr[i];

  std::vector<unsigned char> visited(static_cast<size_t>(n), 0);
  std::vector<std::pair<long long, long long>> nbr;  // (degree, node)
  long long head = 0, tail = 0;   // perm doubles as the BFS queue
  long long seed_scan = 0;        // nodes before this are all visited
  while (tail < n) {
    // next component: first unvisited minimum-degree node
    while (visited[seed_scan]) ++seed_scan;
    long long seed = seed_scan;
    for (long long i = seed_scan + 1; i < n; ++i)
      if (!visited[i] && deg[i] < deg[seed]) seed = i;
    visited[seed] = 1;
    perm[tail++] = seed;
    while (head < tail) {
      const long long u = perm[head++];
      nbr.clear();
      for (long long p = adj_ptr[u]; p < adj_ptr[u + 1]; ++p) {
        const long long v = adj[p];
        if (!visited[v]) {
          visited[v] = 1;
          nbr.emplace_back(deg[v], v);
        }
      }
      std::stable_sort(nbr.begin(), nbr.end(),
                       [](const std::pair<long long, long long>& a,
                          const std::pair<long long, long long>& b) {
                         return a.first < b.first;
                       });
      for (const auto& dv : nbr) perm[tail++] = dv.second;
    }
  }
  // reverse
  for (long long i = 0, j = n - 1; i < j; ++i, --j) {
    const long long t = perm[i];
    perm[i] = perm[j];
    perm[j] = t;
  }
  return 0;
}

}  // extern "C"
