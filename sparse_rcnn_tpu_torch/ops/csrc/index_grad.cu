// Gather-form backwards of the train step's two indexing reads, for Hopper (sm_90a).
//
//   roi_crop_grad:  d_feats[j, :] = sum_{e in map[j]} round(g[s_e, :] * w[e])
//   mask_read_grad: d_mask[r]     = sum_{e in map[r]} g[e]
//
// Neither replaces a TPU kernel. They replace autograd's backward of two reads that the
// port wrote as plain torch indexing: the RoI crop's corner gather feats[safe] in
// ops/roi.py::sample_trilinear (JAX: sparse_rcnn_tpu/ops/roi.py:76, whose transpose XLA
// makes a scatter-add) and the bf16 mask-logit read of models/heads.py::
// sample_mask_at_positions (JAX: sparse_rcnn_tpu/models/heads.py:99). Autograd makes
// each an accumulating index_put_: CUDA sorts the destination indices and then one warp
// adds each run of equal indices in turn, its loads one after another. Both runs here
// are long (every dead RoI corner clamped to row 0; every point outside a box clamped
// to a border cell of its mask grid), so the warp with the longest run sets the time.
//
// The map. ops/index_grad.py builds it in the forward, only when a gradient is wanted,
// with torch.sort(stable=True) and torch.searchsorted (no host sync): perm lists the
// entries e sorted stably by destination, offsets[j] .. offsets[j + 1] is row j's run.
// A stable sort keeps a run in ascending e, the order in which CUDA's index_put_ adds
// it (its radix sort is stable too), so each kernel adds exactly the terms the plain
// version adds, in its order:
//
// - roi_crop_grad: rows of C channels (16 at config 1, 32 at config 2). index_put_ runs
//   its small-stride kernel there (C <= 32): one f32 sum per channel, in run order,
//   rounded once. Here lanes_per_row lanes (C rounded up to a power of two, at most 32)
//   of a warp share a row, one channel a lane; the product g * w is rounded to the
//   feats type first, as autograd's mul does. Dead corners are not in the map: today
//   they add g * 0 = +-0 to row 0, which leaves a finite sum's bits as they are.
// - mask_read_grad: rows of one bf16 element. index_put_ runs its stride-1 kernel there:
//   one warp per run, lane l adds entries l, l + 32, ... of the first 32 * floor(n / 32)
//   in f32, a shuffle-down tree sums the lanes into lane 0, which adds the rest in
//   order and rounds once to bf16. This kernel keeps that order, and loads eight
//   passes ahead of the adds, so a long run costs its bytes and not a chain of
//   dependent loads. Every entry stays, those outside the box too (their cotangent is
//   0, but leaving them out would regroup the lanes' sums).
//
// What bounds it: bytes (no products to speak of). roi_crop_grad reads g [S, C] and w
// [8, S] in the feats type, perm [8 S] and offsets [M + 1] int32, and writes d_feats
// [M, C]; mask_read_grad reads g [P N] bf16, perm [P N] and offsets [P G^3 + 1] int32
// and writes [P G^3] bf16. Every destination row is written, zero where its run is empty.
// No floating-point atomics: results are the same from run to run.

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

// g [P N] bf16 (e = proposal * N + point), perm [P N], offsets [rows + 1], out [rows].
// One warp a row.
__global__ void __launch_bounds__(kThreads)
mask_read_grad_kernel(const __nv_bfloat16* __restrict__ g, const int* __restrict__ perm,
                      const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out,
                      int rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;       // whole warps: kThreads is a multiple of 32
  const int begin = __ldg(offsets + row);
  const int n = __ldg(offsets + row + 1) - begin;
  const int passes = n >> 5;
  const int* p = perm + begin + lane;
  float acc = 0.f;
  int i = 0;
  for (; i + kAhead <= passes; i += kAhead) {
    int e[kAhead];
    float v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) e[u] = __ldg(p + (i + u) * 32);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = __bfloat162float(g[e[u]]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; i < passes; ++i) acc = __fadd_rn(acc, __bfloat162float(g[__ldg(p + i * 32)]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) {
    for (int k = passes << 5; k < n; ++k)
      acc = __fadd_rn(acc, __bfloat162float(g[__ldg(perm + begin + k)]));
    out[row] = __float2bfloat16_rn(acc);
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

// d_mask [rows] bf16 from g [n_entries] bf16, perm [n_entries] and offsets [rows + 1]
// int32. Returns cudaGetLastError() after the launch.
extern "C" int mask_read_grad(const void* g, const void* perm, const void* offsets, void* out,
                              int rows, void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  mask_read_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
