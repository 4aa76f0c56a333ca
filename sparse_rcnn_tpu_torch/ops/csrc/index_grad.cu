// Gather-form backwards of the train step's two indexing reads, for Hopper (sm_90a).
//
//   roi_crop_grad:  d_feats[j, :] = sum_{e in map[j]} round(g[s_e, :] * w[e])
//   mask_read_map:  the map of the mask read's kept entries, built per proposal
//   mask_read_grad: d_mask[r]     = sum_{e in map[r]} g[e], grouped as index_put_ groups it
//
// Neither replaces a TPU kernel. They replace autograd's backward of two reads that the
// port wrote as plain torch indexing: the RoI crop's corner gather feats[safe] in
// ops/roi.py::sample_trilinear (JAX: sparse_rcnn_tpu/ops/roi.py:76, whose transpose XLA
// makes a scatter-add) and the bf16 mask-logit read of models/heads.py::
// sample_mask_at_positions (JAX: sparse_rcnn_tpu/models/heads.py:99). Autograd makes
// each an accumulating index_put_: CUDA sorts the destination indices stably and then
// one warp adds each run of equal indices in turn, its loads one after another.
//
// The crop's map. ops/index_grad.py builds it in the forward, only when a gradient is
// wanted, with torch.sort(stable=True) and torch.searchsorted (no host sync): perm lists
// the entries e sorted stably by destination, offsets[j] .. offsets[j + 1] is row j's
// run, in ascending e, the order in which index_put_ adds it. roi_crop_grad has rows of
// C channels (16 at config 1, 32 at config 2), where index_put_ runs its small-stride
// kernel (C <= 32): one f32 sum per channel, in run order, rounded once. Here
// lanes_per_row lanes (C rounded up to a power of two, at most 32) of a warp share a
// row, one channel a lane; the product g * w is rounded to the feats type first, as
// autograd's mul does. Dead corners are not in the map: they add g * 0 = +-0 to row 0,
// which leaves a finite sum's bits as they are.
//
// The mask read. Entry e = p N + n reads row p G^3 + cell[p, n]; every point outside
// its proposal's box is clamped onto a border cell, so one row can hold all N entries
// of a proposal (262,144 at config 2). The caller passes keep and promises a cotangent
// of exactly 0 wherever keep is false (the training loss passes the points it weights:
// none outside a box). The map holds the kept entries only, so the rows are
// short, and it is built per proposal by mask_map_*_kernel below, with no global sort and
// no host sync. A unit is up to 32768 points of one proposal, taken by one block of up to
// 8 warps, each warp a contiguous part, 32 points a pass:
//   keep:   the kept points of each unit and proposal;
//   count:  per cell, the unit's (all entries << 16 | kept entries) in a shared counter,
//           added by one lane per group of equal cells (__match_any_sync), integer
//           atomics only, so the counts do not depend on the order; a proposal that keeps
//           no point (a box that holds none) is skipped;
//   scan:   one block per proposal: per cell, exclusive sums over its units of both
//           counts; an exclusive scan over cells of the kept totals; the proposal's base
//           is the sum of the earlier proposals' kept totals. Writes offsets;
//   place:  per unit that keeps a point: each warp counts its part per cell again into
//           counters of its own, a scan over the warps gives each warp's first ranks,
//           then each warp reads its points again in order: an entry's place in its row
//           is its unit's base + the kept entries of the row before it in the unit (the
//           running counter + the lower lanes of its group, __popc), so a row keeps
//           ascending e, as the stable sort of the plain version does.
// perm[0 .. offsets[rows]) and offsets equal the plain version's (the stable sort of
// the keys, an entry outside its box keyed `rows`) bit for bit; perm past
// offsets[rows] is not written.
//
// Leaving out the zeros must not regroup index_put_'s sum. Its stride-1 kernel adds a
// run of n entries so: lane l adds entries l, l + 32, ... of the first 32 floor(n / 32)
// in f32, a shuffle-down tree sums the lanes into lane 0, which adds the rest in order
// and rounds once to bf16. Which lane an entry joins depends on its rank f among ALL
// entries of its row, the outside ones too; a sum over the kept entries alone in that
// pattern would group them otherwise, and f32 sums in another grouping can differ. So
// the map also gives each kept entry its lane in the full run, lane[i] = f mod 32 when
// f < 32 floor(n_all / 32), else 32 (the tail): the place pass knows f (all entries of
// the row earlier in its unit, plus the unit's base) and n_all (the row's total).
// mask_read_grad then adds lane by lane, trees the 32 lane sums and adds the tail, as
// index_put_ does over the full run: the left-out terms are zeros, and x + 0 = x (a lane
// starts at +0 and never becomes -0), so every row is index_put_'s bit for bit. A row
// whose entries are all in the tail (fewer than 32 entries in all) is one thread's
// sequential sum; a row with lanes takes a warp, which hands each entry to its lane
// (__ballot_sync per lane, then __shfl_sync), loading kAhead passes ahead so that a long
// run costs its bytes and not a chain of dependent loads.
//
// What bounds them: bytes (no products to speak of). roi_crop_grad reads g [S, C] and w
// [8, S] in the feats type, perm [8 S] and offsets [M + 1] int32, and writes d_feats
// [M, C]. mask_read_map reads keep once, cell and keep once more in the proposals that
// keep a point and twice more in the units that do, and writes the kept entries' perm
// and lane and the offsets; mask_read_grad reads offsets and the kept entries' lane, perm
// and g, and writes [P G^3] bf16. Every destination row is written, +0 where it has no
// kept entry. No floating-point atomics: results are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;        // passes of a mask run loaded before they are added

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// g [S, C], w [8, S] (e = corner * S + sample), perm [8 S], offsets [M + 1], out [M, C].
// Thread t: row t >> lane_shift, channels lane, lane + lanes, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_crop_grad_kernel(const T* __restrict__ g, const T* __restrict__ w,
                     const int* __restrict__ perm, const int* __restrict__ offsets,
                     T* __restrict__ out, int m, int c, int s, int lane_shift) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = t >> lane_shift;
  const int lane = static_cast<int>(t & ((1 << lane_shift) - 1));
  if (row >= m) return;
  const int begin = __ldg(offsets + row), end = __ldg(offsets + row + 1);
  for (int ch = lane; ch < c; ch += 1 << lane_shift) {
    float acc = 0.f;
    int k = begin;
    for (; k + 4 <= end; k += 4) {
      int e[4];
      float gv[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) e[u] = __ldg(perm + k + u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        gv[u] = to_f32(g[static_cast<long long>(e[u] % s) * c + ch]);
        wv[u] = to_f32(w[e[u]]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc = __fadd_rn(acc, to_f32(from_f32<T>(__fmul_rn(gv[u], wv[u]))));
    }
    for (; k < end; ++k) {
      const int e = __ldg(perm + k);
      const float p = __fmul_rn(to_f32(g[static_cast<long long>(e % s) * c + ch]), to_f32(w[e]));
      acc = __fadd_rn(acc, to_f32(from_f32<T>(p)));
    }
    out[row * c + ch] = from_f32<T>(acc);
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTail = 32;        // lane code of an entry in a run's tail
constexpr int kMapAhead = 8;     // passes of a warp's points loaded before they are used
constexpr int kMaxMapWarps = 8;  // warps of a map block, at most

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The points [lo, hi) of the row of entries row0.., 32 a pass, kMapAhead passes loaded at
// once. fn(pass base, cell, kept, valid) runs once per pass in order, on every lane of the
// warp; a lane past hi has cell -1 and is neither kept nor valid.
template <typename Fn>
__device__ __forceinline__ void for_points(const int* __restrict__ cell,
                                           const unsigned char* __restrict__ keep,
                                           long long row0, int lo, int hi, Fn fn) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32 * kMapAhead) {
    int c[kMapAhead];
    bool k[kMapAhead];
#pragma unroll
    for (int u = 0; u < kMapAhead; ++u) {
      const int i = base + 32 * u + lane;
      c[u] = i < hi ? __ldg(cell + row0 + i) : -1;
      k[u] = i < hi && __ldg(keep + row0 + i) != 0;
    }
#pragma unroll
    for (int u = 0; u < kMapAhead; ++u) {
      if (base + 32 * u >= hi) break;            // warp-uniform
      fn(base + 32 * u, c[u], k[u], base + 32 * u + lane < hi);
    }
  }
}

// Adds a pass of points to per-cell counters (all << 16 | kept, unsigned: a unit's 32768
// entries of one cell fill the top bit): one lane a group of equal cells adds the group's
// counts, with an atomic where other warps share the counters. A pass whose points all
// lie in one cell (a box's clamped outside points) skips the match. Lane 0 is valid in
// every pass of for_points.
template <bool kAtomic>
__device__ __forceinline__ void count_pass(unsigned* counter, int c, bool k, bool valid) {
  const unsigned kept = __ballot_sync(kFull, k);
  const unsigned live = __ballot_sync(kFull, valid);
  const int c0 = __shfl_sync(kFull, c, 0);
  unsigned grp;
  if (__all_sync(kFull, c == c0 || !valid)) grp = live;
  else grp = __match_any_sync(kFull, c);
  if (valid && (grp & lanes_below()) == 0) {
    const unsigned add = (static_cast<unsigned>(__popc(grp)) << 16) | __popc(grp & kept);
    if (kAtomic) atomicAdd(counter + c, add);
    else counter[c] += add;
  }
}

// A unit is `unit` points of one proposal, taken by one block of `warps` warps, warp w
// the points [w sub, (w + 1) sub) of the unit (sub = unit / warps). Block b is unit
// b % units of proposal b / units.

// Pass 0. The kept points of each unit, kc[p units + j], and of each proposal, tot[p]
// (zeroed before).
__global__ void __launch_bounds__(256)
mask_map_keep_kernel(const unsigned char* __restrict__ keep, int n, int units, int unit,
                     int* __restrict__ kc, int* __restrict__ tot) {
  const int p = blockIdx.x / units, j = blockIdx.x % units;
  const int lo = j * unit, hi = min(n, lo + unit);
  int k = 0;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    k += __ldg(keep + static_cast<long long>(p) * n + i) != 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) k += __shfl_down_sync(kFull, k, off);
  __shared__ int warp_k[8];
  if ((threadIdx.x & 31) == 0) warp_k[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < (blockDim.x >> 5); ++w) sum += warp_k[w];
    kc[blockIdx.x] = sum;
    if (sum) atomicAdd(tot + p, sum);
  }
}

// Pass 1. Per cell, the unit's (all << 16 | kept) entries into cnt[b][cell]; a proposal
// that keeps no point is skipped (its rows hold nothing).
__global__ void __launch_bounds__(32 * kMaxMapWarps)
mask_map_count_kernel(const int* __restrict__ cell, const unsigned char* __restrict__ keep,
                      int n, int cells, int units, int unit, const int* __restrict__ tot,
                      unsigned* __restrict__ cnt) {
  extern __shared__ int smem[];
  unsigned* counter = reinterpret_cast<unsigned*>(smem);
  const int p = blockIdx.x / units, j = blockIdx.x % units;
  if (tot[p] == 0) return;                       // the whole block
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5, sub = unit / warps;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) counter[c] = 0;
  __syncthreads();
  const int lo = min(n, j * unit + warp * sub), hi = min(n, lo + sub);
  for_points(cell, keep, static_cast<long long>(p) * n, lo, hi,
             [&](int, int c, bool k, bool valid) { count_pass<true>(counter, c, k, valid); });
  __syncthreads();
  unsigned* out = cnt + static_cast<long long>(blockIdx.x) * cells;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) out[c] = counter[c];
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32, at most 1024);
// returns the sum of the threads before this one, *total the block's sum.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  __shared__ int block_sum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += o;
    }
    warp_sums[lane] = wi - w;                    // exclusive, over warps
    if (lane == 31) block_sum = wi;
  }
  __syncthreads();
  const int before = warp_sums[warp] + incl - v;
  *total = block_sum;
  __syncthreads();
  return before;
}

// Pass 2. One block a proposal. Thread t takes the cells [t per, (t + 1) per). Rewrites
// cnt[b][cell] as the global place of unit b's first kept entry of the row and fills
// fpk[b][cell] = max(0, tail - f0) << 5 | (f0 & 31), with f0 the unit's first rank among
// all entries of the row and tail = 32 floor(all entries of the row / 32); writes
// offsets[p cells + cell], and offsets[rows] in the last proposal's block. A proposal
// that keeps no point reads nothing: its rows are empty.
__global__ void __launch_bounds__(1024)
mask_map_scan_kernel(int p_count, int cells, int units, int* __restrict__ cnt,
                     int* __restrict__ fpk, const int* __restrict__ tot,
                     int* __restrict__ offsets) {
  const int p = blockIdx.x;
  __shared__ int base_s;
  if (threadIdx.x < 32) {                        // the earlier proposals' kept entries
    int b = 0;
    for (int q = threadIdx.x; q < p; q += 32) b += tot[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) b += __shfl_down_sync(kFull, b, off);
    if (threadIdx.x == 0) base_s = b;
  }
  const bool empty = tot[p] == 0;
  const int per = (cells + blockDim.x - 1) / blockDim.x;
  const int c0 = min(cells, static_cast<int>(threadIdx.x) * per), c1 = min(cells, c0 + per);
  int* cu = cnt + static_cast<long long>(p) * units * cells;
  int* fu = fpk + static_cast<long long>(p) * units * cells;
  int kept_sum = 0;
  if (!empty)
    for (int c = c0; c < c1; ++c)
      for (int j = 0; j < units; ++j)
        kept_sum += static_cast<int>(static_cast<unsigned>(cu[j * cells + c]) & 0xffff);
  int total;
  const int before = block_exclusive_scan(kept_sum, &total);   // syncs: base_s is set
  int row_start = base_s + before;
  for (int c = c0; c < c1; ++c) {
    offsets[static_cast<long long>(p) * cells + c] = row_start;
    if (empty) continue;
    int all = 0, kept = 0;
    for (int j = 0; j < units; ++j) all += static_cast<unsigned>(cu[j * cells + c]) >> 16;
    const int tail = all & ~31;
    all = 0;
    for (int j = 0; j < units; ++j) {
      const unsigned v = static_cast<unsigned>(cu[j * cells + c]);
      cu[j * cells + c] = row_start + kept;
      fu[j * cells + c] = (max(0, tail - all) << 5) | (all & 31);
      kept += static_cast<int>(v & 0xffff);
      all += static_cast<int>(v >> 16);
    }
    row_start += kept;
  }
  if (p == p_count - 1 && threadIdx.x == 0)
    offsets[static_cast<long long>(p_count) * cells] = base_s + total;
}

// Pass 3. The unit's kept entries into place, in point order, by the block of pass 1's
// shape: each warp counts its points per cell (its own counters), a scan over the warps
// turns the counts into each warp's first ranks in the unit, then each warp reads its
// points again and places its kept ones. Shared memory: the unit's places and lane data
// (2 ints a cell) and each warp's counters (1 int a cell). A unit that keeps no point
// is skipped.
__global__ void __launch_bounds__(32 * kMaxMapWarps)
mask_map_place_kernel(const int* __restrict__ cell, const unsigned char* __restrict__ keep,
                      int n, int cells, int units, int unit, const int* __restrict__ kc,
                      const int* __restrict__ cnt, const int* __restrict__ fpk,
                      int* __restrict__ perm, unsigned char* __restrict__ lanes) {
  extern __shared__ int smem[];
  if (kc[blockIdx.x] == 0) return;               // the whole block
  unsigned* counts = reinterpret_cast<unsigned*>(smem);
  const int p = blockIdx.x / units, j = blockIdx.x % units;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, sub = unit / warps;
  int* place = smem;
  int* fp = smem + cells;
  unsigned* run = counts + (2 + warp) * cells;   // this warp's counters
  const long long b = blockIdx.x;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    place[c] = cnt[b * cells + c];
    fp[c] = fpk[b * cells + c];
  }
  for (int c = lane; c < cells; c += 32) run[c] = 0;
  __syncwarp();
  const int lo = min(n, j * unit + warp * sub), hi = min(n, lo + sub);
  const long long row0 = static_cast<long long>(p) * n;
  for_points(cell, keep, row0, lo, hi, [&](int, int c, bool k, bool valid) {
    count_pass<false>(run, c, k, valid);
    __syncwarp();
  });
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {   // counts -> first ranks
    unsigned acc = 0;
    for (int w = 0; w < warps; ++w) {
      const unsigned v = counts[(2 + w) * cells + c];
      counts[(2 + w) * cells + c] = acc;
      acc += v;
    }
  }
  __syncthreads();
  for_points(cell, keep, row0, lo, hi, [&](int base, int c, bool k, bool valid) {
    const unsigned kept = __ballot_sync(kFull, k);
    if (kept == 0) {                             // nothing to place: count the pass
      count_pass<false>(run, c, k, valid);
      __syncwarp();
      return;
    }
    const unsigned live = __ballot_sync(kFull, valid);
    const int c0 = __shfl_sync(kFull, c, 0);     // lane 0 is valid in every pass
    const unsigned grp = __all_sync(kFull, c == c0 || !valid) ? live
                                                              : __match_any_sync(kFull, c);
    const unsigned below = lanes_below();
    unsigned r = 0;
    if (valid) r = run[c];
    if (k) {
      const int at = place[c] + static_cast<int>(r & 0xffff) + __popc(grp & kept & below);
      const int f = static_cast<int>(r >> 16) + __popc(grp & below);  // rank in the unit's row
      const int q = fp[c];
      perm[at] = static_cast<int>(row0 + base + lane);
      lanes[at] = static_cast<unsigned char>(f < (q >> 5) ? ((q + f) & 31) : kTail);
    }
    __syncwarp();
    if (valid && (grp & below) == 0)
      run[c] = r + ((static_cast<unsigned>(__popc(grp)) << 16) | __popc(grp & kept));
    __syncwarp();
  });
}

// mask_read_grad over the map: rows [32 w, 32 w + 32) for warp w, lane l's row 32 w + l.
// A row whose first entry is in the tail (lane 32) has all its entries there: fewer than
// 32, added in order by its own lane. Every other row is taken by the whole warp, one
// after another: passes of 32 entries, each entry handed to the lane of its code in
// entry order, then the shuffle-down tree, then lane 0 adds the tail.
__device__ float warp_row_sum(const __nv_bfloat16* __restrict__ g,
                              const int* __restrict__ perm,
                              const unsigned char* __restrict__ lanes, int begin, int end) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  int tail_begin = end;
  for (int base = begin; base < end; base += 32 * kAhead) {
    int code[kAhead];
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + 32 * u + lane;
      code[u] = i < end ? __ldg(lanes + i) : kTail + 1;
      v[u] = i < end ? __bfloat162float(g[__ldg(perm + i)]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const unsigned tail = __ballot_sync(kFull, code[u] == kTail);
      if (tail != 0 && tail_begin == end) tail_begin = base + 32 * u + __ffs(tail) - 1;
      if (__all_sync(kFull, code[u] == lane || code[u] > kTail - 1)) {
        if (code[u] == lane) acc = __fadd_rn(acc, v[u]);     // each entry in its own lane
        continue;
      }
      unsigned mine = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const unsigned b = __ballot_sync(kFull, code[u] == t);
        if (lane == t) mine = b;
      }
      while (__any_sync(kFull, mine != 0)) {
        const int src = mine != 0 ? __ffs(mine) - 1 : lane;
        const float w = __shfl_sync(kFull, v[u], src);
        if (mine != 0) {
          acc = __fadd_rn(acc, w);
          mine &= mine - 1;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  if (lane == 0)
    for (int i = tail_begin; i < end; ++i)
      acc = __fadd_rn(acc, __bfloat162float(g[__ldg(perm + i)]));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
mask_read_grad_kernel(const __nv_bfloat16* __restrict__ g, const int* __restrict__ perm,
                      const int* __restrict__ offsets, const unsigned char* __restrict__ lanes,
                      __nv_bfloat16* __restrict__ out, int rows) {
  const long long row0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) & ~31LL;
  const int lane = threadIdx.x & 31;
  if (row0 >= rows) return;       // whole warps: kThreads is a multiple of 32
  const long long row = row0 + lane;
  int begin = 0, end = 0;
  if (row < rows) {
    begin = __ldg(offsets + row);
    end = __ldg(offsets + row + 1);
  }
  const bool warp_row = end > begin && __ldg(lanes + begin) != kTail;
  if (row < rows && !warp_row) {
    float acc = 0.f;
    for (int i = begin; i < end; ++i) acc = __fadd_rn(acc, __bfloat162float(g[__ldg(perm + i)]));
    out[row] = __float2bfloat16_rn(acc);
  }
  for (unsigned todo = __ballot_sync(kFull, warp_row); todo != 0; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const float acc = warp_row_sum(g, perm, lanes, __shfl_sync(kFull, begin, src),
                                   __shfl_sync(kFull, end, src));
    if (lane == 0) out[row0 + src] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

// d_feats [M, C] from g [S, C] and w [8, S] (both float32 if dtype is 0, bfloat16 if
// 1), perm [n_entries] and offsets [M + 1] int32. Returns cudaGetLastError() after the
// launch.
extern "C" int roi_crop_grad(const void* g, const void* w, const void* perm,
                             const void* offsets, void* out, int m, int c, int s, int dtype,
                             void* stream) {
  if (m < 1 || c < 1 || s < 1 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(m) * c >= (1LL << 31) ||
      static_cast<long long>(s) * c >= (1LL << 31) || 8LL * s >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int lane_shift = 0;
  while ((1 << lane_shift) < c && lane_shift < 5) ++lane_shift;
  const long long threads = static_cast<long long>(m) << lane_shift;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pm = static_cast<const int*>(perm);
  const int* of = static_cast<const int*>(offsets);
  if (dtype == 0)
    roi_crop_grad_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(w), pm, of,
        static_cast<float*>(out), m, c, s, lane_shift);
  else
    roi_crop_grad_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(w), pm, of,
        static_cast<__nv_bfloat16*>(out), m, c, s, lane_shift);
  return static_cast<int>(cudaGetLastError());
}

// The most cells a mask grid may have here (a place block of one warp holds 3 ints a cell
// in shared memory), or a negative CUDA error.
extern "C" int mask_read_map_max_cells(int device) {
  int optin = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return optin / static_cast<int>(3 * sizeof(int));
}

// The map of the mask read's kept entries: cell [p, n] int32 (each entry's cell in its
// proposal's grid of `cells`), keep [p, n] bool, into perm [p n] and
// lanes [p n] (the first offsets[p cells] written), offsets [p cells + 1], with `ws` of
// 2 p units cells + p units + p int32 (units = ceil(n / unit)). unit is a multiple of 256
// and at most 32768 (a unit's counts are 16-bit), n below 2^26 (a rank shifted by 5 bits
// stays in an int). Returns cudaGetLastError() after the launches, cudaErrorInvalidValue
// on bad sizes (a mask grid past mask_read_map_max_cells included).
extern "C" int mask_read_map(const void* cell, const void* keep, int p, int n, int cells,
                             int unit, void* perm, void* lanes, void* offsets, void* ws,
                             void* stream) {
  int device = 0;
  cudaGetDevice(&device);
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (p < 1 || n < 1 || cells < 1 || unit < 256 || unit > 32768 || unit % 256 != 0 ||
      n >= (1 << 26) || static_cast<long long>(p) * n >= (1LL << 31) ||
      static_cast<long long>(p) * cells >= (1LL << 31) ||
      static_cast<long long>(3) * sizeof(int) * cells > static_cast<unsigned long long>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = kMaxMapWarps;                      // as many as the place block's memory allows
  while (warps > 1 && static_cast<long long>(2 + warps) * sizeof(int) * cells > optin)
    warps >>= 1;
  const int units = (n + unit - 1) / unit;
  const long long blocks = static_cast<long long>(p) * units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(ws);
  int* fpk = cnt + blocks * cells;
  int* kc = fpk + blocks * cells;
  int* tot = kc + blocks;
  const int* cl = static_cast<const int*>(cell);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  const size_t count_smem = sizeof(int) * cells;
  const size_t place_smem = sizeof(int) * (2 + warps) * cells;
  static size_t smem_set = 0;     // the largest dynamic shared size granted so far
  if (place_smem > 48 * 1024 && place_smem > smem_set) {
    cudaFuncSetAttribute(mask_map_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(place_smem));
    cudaFuncSetAttribute(mask_map_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(place_smem));
    smem_set = place_smem;
  }
  cudaMemsetAsync(tot, 0, sizeof(int) * p, st);
  mask_map_keep_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(kp, n, units, unit, kc,
                                                                      tot);
  mask_map_count_kernel<<<static_cast<unsigned>(blocks), 32 * warps, count_smem, st>>>(
      cl, kp, n, cells, units, unit, tot, reinterpret_cast<unsigned*>(cnt));
  mask_map_scan_kernel<<<p, 1024, 0, st>>>(p, cells, units, cnt, fpk, tot,
                                           static_cast<int*>(offsets));
  mask_map_place_kernel<<<static_cast<unsigned>(blocks), 32 * warps, place_smem, st>>>(
      cl, kp, n, cells, units, unit, kc, cnt, fpk, static_cast<int*>(perm),
      static_cast<unsigned char*>(lanes));
  return static_cast<int>(cudaGetLastError());
}

// d_mask [rows] bf16 from g [n_entries] bf16 and the map (perm, lanes, offsets [rows + 1]
// int32) of mask_read_map. Returns cudaGetLastError() after the launch.
extern "C" int mask_read_grad(const void* g, const void* perm, const void* offsets,
                              const void* lanes, void* out, int rows, void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  mask_read_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<const unsigned char*>(lanes),
      static_cast<__nv_bfloat16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
