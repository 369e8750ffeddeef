// Balanced cluster placement for the IVF build.
//
// Mirrors photo_search_engine_tpu/models/ivf.py balanced_layout(): each row
// goes to its nearest of 3 ranked clusters with remaining capacity;
// overflow rows go to the globally least-filled cluster (min-heap).
// Returns the number of placed rows.  The Python loop over a million rows
// costs ~10s; this runs in milliseconds.

#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

int64_t pse_balanced_layout(
    const int32_t* ranked,      // [n * 3] nearest cluster candidates
    int64_t n,
    int64_t nlist,
    int64_t capacity,
    int64_t* cluster_of_row,    // out [n]
    int64_t* perm               // out [nlist * capacity], -1 padded
) {
  std::vector<int64_t> fill(nlist, 0);
  std::vector<int64_t> spill;
  spill.reserve(64);

  for (int64_t row = 0; row < n; ++row) {
    bool placed = false;
    for (int choice = 0; choice < 3; ++choice) {
      int64_t cluster = ranked[row * 3 + choice];
      if (cluster >= 0 && cluster < nlist && fill[cluster] < capacity) {
        cluster_of_row[row] = cluster;
        ++fill[cluster];
        placed = true;
        break;
      }
    }
    if (!placed) spill.push_back(row);
  }

  if (!spill.empty()) {
    // min-heap over (fill, cluster) so each spill lands in the emptiest list
    using Entry = std::pair<int64_t, int64_t>;
    std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
    for (int64_t c = 0; c < nlist; ++c) heap.emplace(fill[c], c);
    for (int64_t row : spill) {
      while (!heap.empty()) {
        auto [count, cluster] = heap.top();
        heap.pop();
        if (count != fill[cluster]) continue;  // stale entry
        if (fill[cluster] >= capacity) continue;
        cluster_of_row[row] = cluster;
        ++fill[cluster];
        heap.emplace(fill[cluster], cluster);
        break;
      }
    }
  }

  for (int64_t slot = 0; slot < nlist * capacity; ++slot) perm[slot] = -1;
  std::vector<int64_t> cursor(nlist, 0);
  int64_t placed_total = 0;
  for (int64_t row = 0; row < n; ++row) {
    int64_t cluster = cluster_of_row[row];
    if (cluster < 0 || cluster >= nlist) continue;
    perm[cluster * capacity + cursor[cluster]] = row;
    ++cursor[cluster];
    ++placed_total;
  }
  return placed_total;
}

}  // extern "C"
