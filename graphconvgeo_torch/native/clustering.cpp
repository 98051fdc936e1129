// Native label-propagation community detection.
//
// Purpose: community-clustered node ordering drives the hybrid SpMM's
// dense-tile coverage (sparse/reorder.py). networkx Louvain recovers
// communities well but is O(minutes) at Twitter-World scale; synchronous
// label propagation gets comparable tile coverage in O(iters · M) with a
// tiny constant. Ties break toward the smaller label id so the iteration is
// deterministic.
//
// C ABI: label_propagation(indptr, indices, n, iters, labels_inout)

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

void label_propagation(const int64_t* indptr, const int32_t* indices,
                       int64_t n, int32_t iters, int32_t* labels) {
    std::vector<int32_t> buf;
    std::vector<int32_t> next(static_cast<size_t>(n));
    for (int32_t it = 0; it < iters; ++it) {
        bool changed = false;
        for (int64_t u = 0; u < n; ++u) {
            const int64_t lo = indptr[u], hi = indptr[u + 1];
            if (lo == hi) {
                next[u] = labels[u];
                continue;
            }
            buf.clear();
            buf.reserve(hi - lo);
            for (int64_t e = lo; e < hi; ++e) buf.push_back(labels[indices[e]]);
            std::sort(buf.begin(), buf.end());
            // most frequent label, ties -> smallest id (buf sorted)
            int32_t best = buf[0], best_cnt = 1, cur = buf[0], cnt = 1;
            for (size_t i = 1; i < buf.size(); ++i) {
                if (buf[i] == cur) {
                    ++cnt;
                } else {
                    if (cnt > best_cnt) { best = cur; best_cnt = cnt; }
                    cur = buf[i];
                    cnt = 1;
                }
            }
            if (cnt > best_cnt) { best = cur; best_cnt = cnt; }
            next[u] = best;
            changed |= (best != labels[u]);
        }
        std::copy(next.begin(), next.end(), labels);
        if (!changed) break;
    }
}

}  // extern "C"
