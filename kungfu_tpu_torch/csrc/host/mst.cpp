// Prim's minimum-spanning-tree over a dense symmetric weight matrix,
// emitting a father array (forest form used by the collective engine).
//
// The port's own copy of native/mst.cpp, the same code. The host control
// plane probes per-peer RTTs, allgathers them into an n x n latency
// matrix, and this function turns the matrix into a low-latency
// reduce/broadcast tree for the HOST-plane collectives (capability
// parity: the reference's MST topology optimization,
// srcs/cpp/include/kungfu/mst.hpp + the MinimumSpanningTree TF op).
// Bound by kungfu_tpu_torch/plan/mst.py.

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// weights: n*n row-major, w[i*n+j] = cost(i<->j); father: out, length n.
// Node 0 is the root (father[0] == 0). Returns 0 on success.
int kf_mst(int64_t n, const double* weights, int32_t* father) {
    if (n <= 0 || weights == nullptr || father == nullptr) return 1;
    const double inf = std::numeric_limits<double>::infinity();
    std::vector<char> done(static_cast<size_t>(n), 0);
    std::vector<double> best_cost(static_cast<size_t>(n), inf);
    std::vector<int32_t> best_from(static_cast<size_t>(n), 0);

    father[0] = 0;
    done[0] = 1;
    for (int64_t j = 1; j < n; ++j) {
        best_cost[j] = weights[j];  // row 0
        best_from[j] = 0;
    }
    for (int64_t added = 1; added < n; ++added) {
        int64_t pick = -1;
        for (int64_t j = 0; j < n; ++j) {
            if (!done[j] && (pick < 0 || best_cost[j] < best_cost[pick])) pick = j;
        }
        if (pick < 0 || !(best_cost[pick] < inf)) return 2;  // disconnected
        done[pick] = 1;
        father[pick] = best_from[pick];
        const double* row = weights + pick * n;
        for (int64_t j = 0; j < n; ++j) {
            if (!done[j] && row[j] < best_cost[j]) {
                best_cost[j] = row[j];
                best_from[j] = static_cast<int32_t>(pick);
            }
        }
    }
    return 0;
}

}  // extern "C"
