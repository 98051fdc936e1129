// Native clique projection for the @-mention graph builder.
//
// Reference: data.py :: efficient_collaboration_weighted_projected_graph2 —
// for every external (mentioned) account, connect all pairs of dataset users
// that mention it. O(Σ deg²) over external accounts; the dominant
// preprocessing cost at Twitter-World scale, hence native.
//
// C ABI (ctypes-friendly):
//   count_clique_edges(offsets, n_groups) -> total pair count
//   project_cliques(offsets, n_groups, members, out_src, out_dst) -> count
// where members[offsets[g] : offsets[g+1]] are the user ids mentioning
// external account g.

#include <cstdint>

extern "C" {

int64_t count_clique_edges(const int64_t* offsets, int64_t n_groups) {
    int64_t total = 0;
    for (int64_t g = 0; g < n_groups; ++g) {
        int64_t k = offsets[g + 1] - offsets[g];
        total += k * (k - 1) / 2;
    }
    return total;
}

int64_t project_cliques(const int64_t* offsets, int64_t n_groups,
                        const int64_t* members, int64_t* out_src,
                        int64_t* out_dst) {
    int64_t pos = 0;
    for (int64_t g = 0; g < n_groups; ++g) {
        const int64_t lo = offsets[g];
        const int64_t hi = offsets[g + 1];
        for (int64_t a = lo; a < hi; ++a) {
            const int64_t u = members[a];
            for (int64_t b = a + 1; b < hi; ++b) {
                out_src[pos] = u;
                out_dst[pos] = members[b];
                ++pos;
            }
        }
    }
    return pos;
}

}  // extern "C"
