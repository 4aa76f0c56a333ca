// Host-side native core of the port: coordinate hash map, voxelizer and
// submanifold rulebook construction (a copy of the JAX package's
// native/sparse_host.cpp, owned by the port).
//
// It serves the host input pipeline: the Loader's worker threads voxelize
// scenes here while the card runs the step (data/pipeline.py), and it is an
// independent implementation for cross-checks against the device path
// (open-addressing hash against sort + search).
//
// Semantics contract (must match ops/voxelize.py and ops/rulebook.py):
//   * the unique voxel table is sorted lexicographically by (x, y, z)
//   * on overflow keep the lexicographically smallest `capacity` coords
//   * p2v == -1 for invalid or dropped points
//   * subm rulebook: idx[k][i] = row of (coords[i] - offset_k), else -1
//
// Built at first use by sparse_rcnn_tpu_torch/native/__init__.py
// (g++ -O3 -fPIC -std=c++17 -shared) into sparse_rcnn_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Open-addressing hash map: packed 48-bit coord key -> row index.
// Power-of-two sizing, linear probing; keys are packed as in
// ops/coords.py: 16 bits per axis, offset by 2^15.
class CoordHash {
 public:
  explicit CoordHash(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    mask_ = cap - 1;
    keys_.assign(cap, kEmpty);
    vals_.assign(cap, -1);
  }

  static inline uint64_t pack(int x, int y, int z) {
    return (uint64_t(uint16_t(x + 32768)) << 32) |
           (uint64_t(uint16_t(y + 32768)) << 16) |
           uint64_t(uint16_t(z + 32768));
  }

  static inline uint64_t hash(uint64_t k) {
    k *= 0x9E3779B97F4A7C15ull;  // Fibonacci hashing
    return k ^ (k >> 29);
  }

  // Insert if absent; returns existing or new value.
  int32_t insert(uint64_t key, int32_t val) {
    size_t i = hash(key) & mask_;
    while (true) {
      if (keys_[i] == kEmpty) {
        keys_[i] = key;
        vals_[i] = val;
        return val;
      }
      if (keys_[i] == key) return vals_[i];
      i = (i + 1) & mask_;
    }
  }

  int32_t find(uint64_t key) const {
    size_t i = hash(key) & mask_;
    while (true) {
      if (keys_[i] == kEmpty) return -1;
      if (keys_[i] == key) return vals_[i];
      i = (i + 1) & mask_;
    }
  }

  void set(uint64_t key, int32_t val) {
    size_t i = hash(key) & mask_;
    while (true) {
      if (keys_[i] == key) { vals_[i] = val; return; }
      if (keys_[i] == kEmpty) { keys_[i] = key; vals_[i] = val; return; }
      i = (i + 1) & mask_;
    }
  }

 private:
  static constexpr uint64_t kEmpty = ~0ull;
  size_t mask_;
  std::vector<uint64_t> keys_;
  std::vector<int32_t> vals_;
};

}  // namespace

extern "C" {

// Voxelize one scene.
//   points  [n,3] f32, feats [n,c] f32, valid [n] u8
//   voxel_size [3] f32, capacity M
// Outputs (caller-allocated):
//   out_coords [M,3] i32 (sentinel 32767-padded), out_feats [M,c] f32,
//   out_p2v [n] i32, out_n_voxels [1] i32, out_overflow [1] i32
void voxelize_scene(const float* points, const float* feats,
                    const uint8_t* valid, int64_t n, int64_t c,
                    const float* voxel_size, int64_t capacity,
                    int32_t* out_coords, float* out_feats, int32_t* out_p2v,
                    int32_t* out_n_voxels, int32_t* out_overflow) {
  std::vector<int32_t> icoords(n * 3);
  std::vector<uint64_t> pkeys(n);
  CoordHash map{size_t(n)};
  std::vector<uint64_t> unique_keys;
  unique_keys.reserve(size_t(n) / 4 + 16);

  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) { pkeys[i] = ~0ull; continue; }
    int32_t ix = (int32_t)std::floor(points[i * 3 + 0] / voxel_size[0]);
    int32_t iy = (int32_t)std::floor(points[i * 3 + 1] / voxel_size[1]);
    int32_t iz = (int32_t)std::floor(points[i * 3 + 2] / voxel_size[2]);
    icoords[i * 3 + 0] = ix;
    icoords[i * 3 + 1] = iy;
    icoords[i * 3 + 2] = iz;
    uint64_t key = CoordHash::pack(ix, iy, iz);
    pkeys[i] = key;
    int32_t row = map.insert(key, (int32_t)unique_keys.size());
    if (row == (int32_t)unique_keys.size()) unique_keys.push_back(key);
  }

  // lexicographic order == packed-key order (unsigned)
  std::sort(unique_keys.begin(), unique_keys.end());
  int64_t n_unique = (int64_t)unique_keys.size();
  int64_t n_kept = std::min(n_unique, capacity);
  *out_overflow = (int32_t)(n_unique - n_kept);
  *out_n_voxels = (int32_t)n_kept;

  // remap keys to sorted rows (dropped voxels -> -1)
  for (int64_t r = 0; r < n_unique; ++r)
    map.set(unique_keys[r], r < capacity ? (int32_t)r : -1);

  for (int64_t r = 0; r < capacity; ++r) {
    if (r < n_kept) {
      uint64_t k = unique_keys[r];
      out_coords[r * 3 + 0] = (int32_t)((k >> 32) & 0xFFFF) - 32768;
      out_coords[r * 3 + 1] = (int32_t)((k >> 16) & 0xFFFF) - 32768;
      out_coords[r * 3 + 2] = (int32_t)(k & 0xFFFF) - 32768;
    } else {
      out_coords[r * 3 + 0] = 32767;
      out_coords[r * 3 + 1] = 32767;
      out_coords[r * 3 + 2] = 32767;
    }
  }

  std::vector<float> counts(size_t(capacity), 0.f);
  std::memset(out_feats, 0, sizeof(float) * size_t(capacity) * size_t(c));
  for (int64_t i = 0; i < n; ++i) {
    int32_t row = -1;
    if (pkeys[i] != ~0ull) row = map.find(pkeys[i]);
    out_p2v[i] = row;
    if (row >= 0) {
      counts[row] += 1.f;
      const float* src = feats + i * c;
      float* dst = out_feats + (int64_t)row * c;
      for (int64_t j = 0; j < c; ++j) dst[j] += src[j];
    }
  }
  for (int64_t r = 0; r < n_kept; ++r) {
    float inv = counts[r] > 0 ? 1.f / counts[r] : 0.f;
    float* dst = out_feats + r * c;
    for (int64_t j = 0; j < c; ++j) dst[j] *= inv;
  }
}

// Submanifold rulebook: coords [m,3] i32 (sorted, sentinel-padded),
// n_valid live rows, cubic kernel k (odd) -> out_idx [k^3, m] i32.
void subm_rulebook(const int32_t* coords, int64_t m, int64_t n_valid,
                   int64_t k, int32_t* out_idx) {
  CoordHash map{size_t(n_valid)};
  for (int64_t i = 0; i < n_valid; ++i)
    map.insert(CoordHash::pack(coords[i * 3], coords[i * 3 + 1],
                               coords[i * 3 + 2]),
               (int32_t)i);
  int64_t half = k / 2;
  int64_t tap = 0;
  for (int64_t dx = -half; dx < k - half; ++dx)
    for (int64_t dy = -half; dy < k - half; ++dy)
      for (int64_t dz = -half; dz < k - half; ++dz, ++tap) {
        int32_t* row = out_idx + tap * m;
        for (int64_t i = 0; i < m; ++i) {
          if (i >= n_valid) { row[i] = -1; continue; }
          row[i] = map.find(CoordHash::pack(
              coords[i * 3] - (int32_t)dx, coords[i * 3 + 1] - (int32_t)dy,
              coords[i * 3 + 2] - (int32_t)dz));
        }
      }
}

}  // extern "C"
