// Greedy 3D NMS with a fixed output budget, for Hopper (sm_90a): one launch for a batch
// of scenes, one block a scene.
//
//   s_j = valid_j ? score_j : -inf
//   for i in 0 .. P-1:  b = argmax_j s_j  (the first of equal maxima; a NaN above all)
//                       if not s_b > -inf: keep_idx[i..] = -1, keep_mask[i..] = false; stop
//                       keep_idx[i] = b, keep_mask[i] = true
//                       s_j = -inf where IoU(b, j) >= threshold or j == b
//
// Not a TPU kernel. It replaces the loop of ops/nms.py::nms_3d_reference (the JAX
// package's sparse_rcnn_tpu/ops/nms.py::nms_3d, a lax.fori_loop that XLA keeps on the
// device), which the port ran as P = num_proposals iterations of about 14 device
// operations a scene, each behind a Python dispatch and a launch: about 3,700 launches a
// config-2 train step and 1,850 an online sweep, for a few microseconds of work each.
//
// What bounds it: neither bytes nor operations. A scene reads N boxes once (28 N bytes
// with their volumes: 14 KB at N = 512) and computes P N IoUs (65 k at config 2, a few
// dozen flops each). Its P iterations depend on each other, and each is a block-wide
// argmax, so the time is P barriers and reductions; a block a scene runs the scenes of
// a batch side by side. The boxes and volumes go to shared memory once; each thread
// keeps its candidates' scores (j = t, t + blockDim, ...) in registers; an iteration is
// one argmax by warp shuffles of (value, index) pairs, one barrier, a scan of the warps'
// winners (kept in two alternating shared buffers, so one barrier an iteration is
// enough), then each thread computes the IoU of the winner with its own candidates. No
// N x N matrix is built.
//
// Arithmetic, bit for bit with the plain version on the card (ops/nms.py::box_iou_3d):
//   lo = maximum(b_lo, j_lo), hi = minimum(b_hi, j_hi)      (a NaN operand wins, as torch)
//   e = clamp_min(hi - lo, 0)                               (a NaN stays NaN, as torch)
//   inter = (e0 * e2) * e1       the order of torch.prod over a last dim of 3 on CUDA: two
//                                threads a row, thread 0 multiplies entries 0 and 2, then
//                                takes thread 1's entry 1 by a shuffle
//   vol = (d0 * d1) * d2         box_volume's products, left to right
//   union = (vol_b + vol_j) - inter;  IoU = inter / max(union, (float)1e-9)  (IEEE division)
//   suppress where IoU >= threshold, the threshold a float (torch compares an f32 tensor
//   with a Python float in f32). Every product and sum is an __f*_rn intrinsic and the
//   library is built with -fmad=false, so nothing is contracted into an FMA.
// The argmax ranks as torch.argmax does: a NaN above every number (the first NaN among
// NaNs), then the larger value, equal values (+0 and -0 too) to the lower index. Scores
// are not assumed sorted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPer = 16;                          // candidates a thread, at most
constexpr int kMaxCandidates = kMaxThreads * kMaxPer;
constexpr int kNoIndex = 0x7fffffff;

// Whether (av, ai) ranks above (bv, bi) in torch.argmax's order.
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (isnan(av)) return !isnan(bv) || ai < bi;
  if (isnan(bv)) return false;
  return av == bv ? ai < bi : av > bv;
}

// torch.maximum / torch.minimum / clamp_min on CUDA: a NaN operand is returned.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
nms_3d_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
              const bool* __restrict__ valid, int n, int p, float threshold,
              int* __restrict__ keep_idx, bool* __restrict__ keep_mask) {
  extern __shared__ float smem[];
  float* box = smem;            // [n][6]
  float* vol = smem + 6 * n;    // [n]
  __shared__ float win_v[2][kMaxWarps];
  __shared__ int win_i[2][kMaxWarps];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const long long scene = blockIdx.x;
  const float* src = boxes + scene * n * 6;
  for (int k = t; k < 6 * n; k += blockDim.x) box[k] = src[k];

  float s[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = t + k * blockDim.x;
    s[k] = (j < n && valid[scene * n + j]) ? scores[scene * n + j] : -INFINITY;
  }
  __syncthreads();
  for (int j = t; j < n; j += blockDim.x) {
    const float* q = box + 6 * j;
    const float d0 = clamp_min(__fsub_rn(q[3], q[0]), 0.f);
    const float d1 = clamp_min(__fsub_rn(q[4], q[1]), 0.f);
    const float d2 = clamp_min(__fsub_rn(q[5], q[2]), 0.f);
    vol[j] = __fmul_rn(__fmul_rn(d0, d1), d2);
  }
  __syncthreads();

  int* out_i = keep_idx + scene * p;
  bool* out_m = keep_mask + scene * p;
  for (int it = 0; it < p; ++it) {
    float bv = -INFINITY;
    int bi = kNoIndex;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = t + k * blockDim.x;
      if (j < n && beats(s[k], j, bv, bi)) { bv = s[k]; bi = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    const int buf = it & 1;
    if (lane == 0) { win_v[buf][warp] = bv; win_i[buf][warp] = bi; }
    __syncthreads();
    bv = win_v[buf][0];
    bi = win_i[buf][0];
    for (int w = 1; w < warps; ++w) {
      if (beats(win_v[buf][w], win_i[buf][w], bv, bi)) { bv = win_v[buf][w]; bi = win_i[buf][w]; }
    }
    if (!(bv > -INFINITY)) {      // -inf or NaN: this slot and every later one stay empty
      for (int k = it + t; k < p; k += blockDim.x) { out_i[k] = -1; out_m[k] = false; }
      return;
    }
    if (t == 0) { out_i[it] = bi; out_m[it] = true; }
    const float* a = box + 6 * bi;
    const float a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3], a4 = a[4], a5 = a[5];
    const float va = vol[bi];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = t + k * blockDim.x;
      if (j >= n) continue;
      const float* q = box + 6 * j;
      const float e0 = clamp_min(__fsub_rn(nan_min(a3, q[3]), nan_max(a0, q[0])), 0.f);
      const float e1 = clamp_min(__fsub_rn(nan_min(a4, q[4]), nan_max(a1, q[1])), 0.f);
      const float e2 = clamp_min(__fsub_rn(nan_min(a5, q[5]), nan_max(a2, q[2])), 0.f);
      const float inter = __fmul_rn(__fmul_rn(e0, e2), e1);
      const float uni = __fsub_rn(__fadd_rn(va, vol[j]), inter);
      const float iou = __fdiv_rn(inter, clamp_min(uni, static_cast<float>(1e-9)));
      if (iou >= threshold || j == bi) s[k] = -INFINITY;
    }
  }
}

template <int kPer>
cudaError_t launch(const float* boxes, const float* scores, const bool* valid, int b, int n,
                   int p, float threshold, int* keep_idx, bool* keep_mask, int threads,
                   cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(7) * sizeof(float) * n;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_3d_kernel<kPer>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  nms_3d_kernel<kPer><<<b, threads, bytes, stream>>>(boxes, scores, valid, n, p, threshold,
                                                     keep_idx, keep_mask);
  return cudaGetLastError();
}

}  // namespace

// The most candidates a scene may have: kMaxPer a thread of a block of kMaxThreads.
extern "C" int nms_3d_max_candidates() { return kMaxCandidates; }

// Greedy NMS of b scenes of n candidates each: boxes [b, n, 6] f32 (x1 y1 z1 x2 y2 z2),
// scores [b, n] f32, valid [b, n] bool, all contiguous, into keep_idx [b, p] int32 and
// keep_mask [b, p] bool. One launch on `stream`, no host sync. Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue on bad sizes.
extern "C" int nms_3d(const void* boxes, const void* scores, const void* valid, int b, int n,
                      int p, float threshold, void* keep_idx, void* keep_mask, void* stream) {
  if (b < 1 || n < 0 || n > kMaxCandidates || p < 1 ||
      static_cast<long long>(b) * n * 6 >= (1LL << 31) ||
      static_cast<long long>(b) * p >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp for every 32 candidates up to a full block, then several candidates a thread
  const int threads = n > kMaxThreads ? kMaxThreads : (n > 32 ? 32 * ((n + 31) / 32) : 32);
  const int need = (n + threads - 1) / threads;
  int per = 1;
  while (per < need) per <<= 1;
  const float* bx = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  const bool* va = static_cast<const bool*>(valid);
  int* ki = static_cast<int*>(keep_idx);
  bool* km = static_cast<bool*>(keep_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (per) {
    case 1: e = launch<1>(bx, sc, va, b, n, p, threshold, ki, km, threads, st); break;
    case 2: e = launch<2>(bx, sc, va, b, n, p, threshold, ki, km, threads, st); break;
    case 4: e = launch<4>(bx, sc, va, b, n, p, threshold, ki, km, threads, st); break;
    case 8: e = launch<8>(bx, sc, va, b, n, p, threshold, ki, km, threads, st); break;
    case 16: e = launch<16>(bx, sc, va, b, n, p, threshold, ki, km, threads, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
