// Single-pass breadth-first octree construction from sorted unique Morton
// keys.  Produces the same flat BFS arrays as the numpy builder in
// scp_tpu_torch/core/octree.py (semantics of the reference's GenOctree,
// reference data_preproc/Octree.py:148-181).  A copy of the JAX
// package's scp_tpu/native/src/octree.cpp: the port builds and loads its
// own library (scp_tpu_torch/native/build.py).
//
// Algorithm: walking keys in sorted order, the first digit position where
// key[i] differs from key[i-1] tells exactly which new tree nodes begin at
// key[i] (one per depth below the divergence point).  Every node is touched
// O(1) times -> O(total nodes) time, no hashing.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tree {
  int bits = 0;
  // Per-depth flat arrays (depth d in [0, bits-1] -> node level d+1).
  std::vector<std::vector<int32_t>> occ;
  std::vector<std::vector<int32_t>> octant;
  std::vector<std::vector<int64_t>> parent;   // local index in depth-1 level
  std::vector<std::vector<uint64_t>> prefix;  // Morton prefix (d digits)
  int64_t total = 0;
};

inline uint64_t compact_axis(uint64_t v) {
  v &= 0x1249249249249249ull;
  v = (v | (v >> 2)) & 0x10C30C30C30C30C3ull;
  v = (v | (v >> 4)) & 0x100F00F00F00F00Full;
  v = (v | (v >> 8)) & 0x1F0000FF0000FFull;
  v = (v | (v >> 16)) & 0x1F00000000FFFFull;
  v = (v | (v >> 32)) & 0x1FFFFFull;
  return v;
}

Tree* build(const uint64_t* keys, int64_t n, int bits) {
  Tree* t = new Tree();
  t->bits = bits;
  t->occ.resize(bits);
  t->octant.resize(bits);
  t->parent.resize(bits);
  t->prefix.resize(bits);

  if (n <= 0) return t;

  auto open_node = [&](int d, uint64_t pfx) {
    // pfx = first d digits of the current key (node at depth d).
    t->occ[d].push_back(0);
    t->octant[d].push_back(d == 0 ? 1
                                  : static_cast<int32_t>((pfx & 7u) + 1));
    t->parent[d].push_back(
        d == 0 ? -1 : static_cast<int64_t>(t->prefix[d - 1].size()) - 1);
    t->prefix[d].push_back(pfx);
  };

  // Open the chain of nodes covering the first key.
  for (int d = 0; d < bits; ++d) {
    open_node(d, keys[0] >> (3 * (bits - d)));
    t->occ[d].back() |= 1 << ((keys[0] >> (3 * (bits - d - 1))) & 7u);
  }

  for (int64_t i = 1; i < n; ++i) {
    const uint64_t diff = keys[i] ^ keys[i - 1];
    // Highest differing bit -> first digit (depth) where the paths diverge.
    const int hb = 63 - __builtin_clzll(diff);
    int dd = bits - 1 - hb / 3;  // depth whose CHILD digit first differs
    if (dd < 0) dd = 0;
    // Node at depth dd is shared; its occupancy gains the new child bit.
    t->occ[dd].back() |=
        1 << ((keys[i] >> (3 * (bits - dd - 1))) & 7u);
    // Deeper nodes are fresh.
    for (int d = dd + 1; d < bits; ++d) {
      open_node(d, keys[i] >> (3 * (bits - d)));
      t->occ[d].back() |= 1 << ((keys[i] >> (3 * (bits - d - 1))) & 7u);
    }
  }

  for (int d = 0; d < bits; ++d) t->total += t->occ[d].size();
  return t;
}

}  // namespace

extern "C" {

void* octree_build(const uint64_t* keys, int64_t n, int32_t bits) {
  return build(keys, n, bits);
}

int64_t octree_num_nodes(void* h) { return static_cast<Tree*>(h)->total; }

// Fill caller-allocated flat BFS arrays.  level_starts has bits+1 entries;
// pos is (num_nodes, 3) row-major int64 cell origins at full resolution.
void octree_fill(void* h, int32_t* occ, int32_t* level, int32_t* octant,
                 int64_t* parent, int64_t* pos, int64_t* level_starts) {
  Tree* t = static_cast<Tree*>(h);
  int64_t off = 0;
  int64_t prev_off = 0;
  level_starts[0] = 0;
  for (int d = 0; d < t->bits; ++d) {
    const int64_t m = static_cast<int64_t>(t->occ[d].size());
    std::memcpy(occ + off, t->occ[d].data(), m * sizeof(int32_t));
    std::memcpy(octant + off, t->octant[d].data(), m * sizeof(int32_t));
    for (int64_t i = 0; i < m; ++i) {
      level[off + i] = d + 1;
      parent[off + i] =
          t->parent[d][i] < 0 ? -1 : t->parent[d][i] + prev_off;
      const uint64_t pfx = t->prefix[d][i];
      const int shift = t->bits - d;  // cell side = 2^shift
      pos[(off + i) * 3 + 0] =
          static_cast<int64_t>(compact_axis(pfx >> 2)) << shift;
      pos[(off + i) * 3 + 1] =
          static_cast<int64_t>(compact_axis(pfx >> 1)) << shift;
      pos[(off + i) * 3 + 2] =
          static_cast<int64_t>(compact_axis(pfx)) << shift;
    }
    prev_off = off;
    off += m;
    level_starts[d + 1] = off;
  }
}

void octree_free(void* h) { delete static_cast<Tree*>(h); }

}  // extern "C"
