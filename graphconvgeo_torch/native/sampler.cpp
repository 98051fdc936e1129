// Per-row distinct neighbor sampling for the GraphSAGE-style mini-batch
// path (data/sampling.py :: NeighborSampler — reference has no sampler;
// BASELINE config 5 requires one).
//
// The numpy fallback draws a [rows, max_degree] uniform matrix and argsorts
// it to get distinct offsets — O(rows * max_degree * log) per layer, which
// power-law hubs blow up (measured 195 ms/batch at 400k nodes, max degree
// 2045). Here each row uses Floyd's distinct-sampling algorithm:
// O(fanout^2) per row independent of degree, ~O(rows * fanout) total.
//
// Semantics match the numpy path exactly where it matters:
//   - degree d <= fanout: take ALL d neighbors, unscaled;
//   - d > fanout: `fanout` DISTINCT neighbors, values rescaled by d/fanout
//     (unbiased estimate of the full row aggregate);
//   - selected slots are contiguous from 0 (slot k real iff k < take[i]).
// The random stream differs from numpy's (documented in the caller).

#include <cstdint>

static inline uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s;
  inline uint64_t next() { return s = mix64(s); }
  // unbiased bounded draw (Lemire-style rejection kept simple)
  inline uint64_t below(uint64_t n) {
    uint64_t x, r;
    do {
      x = next();
      r = x % n;
    } while (x - r > UINT64_MAX - (n - 1));
    return r;
  }
};

extern "C" int64_t sample_neighbors(
    const int64_t* indptr, const int32_t* indices, const float* data,
    const int64_t* nodes, const float* node_mask, int64_t n_rows,
    int32_t fanout, uint64_t seed,
    int32_t* out_nbrs,  // [n_rows * fanout]
    float* out_vals,    // [n_rows * fanout] rescaled, 0 where invalid
    uint8_t* out_sel,   // [n_rows * fanout] 1 = real slot
    int32_t* out_take   // [n_rows] = min(degree, fanout) for real rows
) {
  int64_t total = 0;
  // small scratch for Floyd's set; fanout is small (typically 5-25)
  int64_t* picked = new int64_t[fanout];
  for (int64_t i = 0; i < n_rows; ++i) {
    int32_t* nb = out_nbrs + i * fanout;
    float* vv = out_vals + i * fanout;
    uint8_t* sl = out_sel + i * fanout;
    for (int32_t k = 0; k < fanout; ++k) { nb[k] = 0; vv[k] = 0.0f; sl[k] = 0; }
    out_take[i] = 0;
    if (node_mask[i] <= 0.0f) continue;
    const int64_t u = nodes[i];
    const int64_t lo = indptr[u], hi = indptr[u + 1];
    const int64_t d = hi - lo;
    if (d <= 0) continue;
    if (d <= fanout) {
      for (int64_t k = 0; k < d; ++k) {
        nb[k] = indices[lo + k];
        vv[k] = data[lo + k];
        sl[k] = 1;
      }
      out_take[i] = (int32_t)d;
      total += d;
      continue;
    }
    // Floyd: distinct sample of `fanout` offsets from [0, d).
    // Seed mixes BOTH the node id and the frontier row index: hubs repeat
    // within a layer's frontier on power-law graphs, and seeding by node id
    // alone would give every duplicate the same picks — correlated sibling
    // subtree estimates (still unbiased, but higher estimator variance).
    Rng rng{mix64(seed ^ (uint64_t)(u + 1) * 0xD6E8FEB86659FD93ULL ^
                  mix64((uint64_t)i + 0x853C49E6748FEA9BULL))};
    int32_t m = 0;
    for (int64_t j = d - fanout; j < d; ++j) {
      int64_t t = (int64_t)rng.below((uint64_t)(j + 1));
      bool dup = false;
      for (int32_t k = 0; k < m; ++k)
        if (picked[k] == t) { dup = true; break; }
      picked[m++] = dup ? j : t;
    }
    const float scale = (float)d / (float)fanout;
    for (int32_t k = 0; k < fanout; ++k) {
      nb[k] = indices[lo + picked[k]];
      vv[k] = data[lo + picked[k]] * scale;
      sl[k] = 1;
    }
    out_take[i] = fanout;
    total += fanout;
  }
  delete[] picked;
  return total;
}
