// The train step's optimizer update, for Hopper (sm_90a):
//
//   global_sumsq_partial:  s[c] = fixed-order sum of g^2 over chunk c of the gradients
//   global_sumsq_finish:   norm = sqrt(fixed-order sum of s[c])        (a device scalar)
//   optim_apply:           clip -> AdamW | SGD -> p update -> EMA, one pass over every entry
//
// Not a TPU kernel. It replaces the update that the JAX package builds with optax
// (sparse_rcnn_tpu/train/loop.py:75-87 make_optimizer, chain(clip_by_global_norm, adamw |
// sgd), applied at :286-313 with the EMA) and that XLA fuses inside the jitted step. The
// port wrote it as torch._foreach_* calls and a per-tensor norm and clip: about 1,850
// device operations a config-2 step for about 330 MB of traffic.
//
// What bounds it: bytes. AdamW reads g, p, mu, nu and writes p, mu, nu (28 B an entry),
// the EMA reads and writes e (8 B more), the norm reads g (4 B); there are a few dozen
// flops an entry. Each block takes one chunk of one tensor (16 B loads where every
// pointer of the tensor is 16-byte aligned, plain loads otherwise), so one launch covers
// every tensor and the whole list is one wave of blocks.
//
// Layouts. Parameters, moments and the EMA are contiguous. A gradient may also be stored
// channels-last (dims [O, C, spatial...] laid out [O, spatial..., C]): cuDNN returns a
// conv3d weight's gradient so, and 17 of config 2's 165 gradients come that way. The
// kernels read such a gradient in place, entry j of the row-major order at
// (o S + s) C + c for j = (o C + c) S + s (g_at below), so the sums run in the same order
// and no copy is made; a chunk of one such tensor spans a few output channels, so its
// strided reads stay in L2.
//
// Arithmetic, bit for bit with the plain version (ops/optim.py):
// - The norm adds in a fixed order that depends on the shapes alone. A chunk is a run of
//   at most kChunk consecutive entries of one tensor, chunks in tensor order. Thread t of
//   a chunk's block adds the squares of entries 4 (i kThreads + t) + u in the order
//   (i, u), each square and each sum rounded on its own; the block then halves its
//   kThreads sums in a fixed tree (t + w onto t, w = kThreads / 2, ..., 1). The finish
//   block adds the partials the same way (thread t: partials t, t + kThreads, ...; then
//   the tree) and takes sqrtf. An entry past a tensor's end counts as 0, which leaves a
//   sum of squares as it is.
// - optim_apply repeats the plain chain's operations in its order, each one rounded:
//     g' = (norm < clip) ? g : (g / norm) * clip        (a NaN norm gives NaN, as optax)
//     AdamW: mu = g' c1 + mu b1;  nu = (g' g') c2 + nu b2;
//            u = (mu r1) / (sqrt(nu r2) + eps) + p wd;  p = p + u (-lr)
//     SGD:   mu = mu m + g';  p = p + mu (-lr)
//     EMA:   e = e d + p (1 - d), on the updated p
//   r1 and r2 are the float32 reciprocals of the bias corrections: the plain chain
//   divides by them as Python scalars, and torch's CUDA _foreach_div by a scalar
//   multiplies by the scalar's reciprocal (on an H100 with torch 2.11 bit-equal to that
//   product, not to the quotient). The library is built with -fmad=false, and every
//   product and sum below is an __f*_rn intrinsic, so no product is fused into a sum.
//
// Tensor lists travel by value: one launch takes a struct of pointers and sizes as its
// kernel parameter (CUDA >= 12.1 on sm_70+ allows 32,764 bytes), so nothing is copied
// to the card before a launch and nothing synchronises. A list longer than kMaxTensors
// is split by the caller into launches of whole tensors, in order; the norm's partials
// of all launches go to one buffer, in chunk order, and one finish block reads them.
// No atomics: results are the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;                       // entries a block
constexpr int kGroups = kChunk / (4 * kThreads);    // groups of 4 entries a thread
constexpr int kMaxTensors = 192;                    // tensors a launch

static_assert(kChunk % (4 * kThreads) == 0, "a chunk is whole groups of 4 a thread");

enum Kind { kAdamW = 0, kSGD = 1, kEmaOnly = 2 };

struct NormList {
  const float* x[kMaxTensors];
  int numel[kMaxTensors];
  int gc[kMaxTensors], gs[kMaxTensors];   // a channels-last x: C and S; 0 and 0 if contiguous
  int chunk_first[kMaxTensors + 1];   // first chunk of tensor i in this launch; [n] = all
  int n;
};

struct ApplyList {
  const float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  float* e[kMaxTensors];
  int numel[kMaxTensors];
  int gc[kMaxTensors], gs[kMaxTensors];   // a channels-last g: C and S; 0 and 0 if contiguous
  int chunk_first[kMaxTensors + 1];
  int n;
};

struct Scalars {
  float clip, c1, b1, c2, b2, r1, r2, eps, wd, neg_lr, d, one_minus_d;
  int kind, ema;
};

// The tensor that owns block b: the last i with chunk_first[i] <= b (a tensor with no
// chunk shares its chunk_first with the next one and owns no block).
template <typename List>
__device__ __forceinline__ int owner(const List& a, int b) {
  int lo = 0, hi = a.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.chunk_first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Where entry j (row-major) of a gradient lies: j itself if c == 0, else in the
// channels-last layout of [O, c, s] (c channels, s spatial entries).
__device__ __forceinline__ long long g_at(long long j, int c, int s) {
  if (c == 0) return j;
  const long long cs = static_cast<long long>(c) * s;
  const long long o = j / cs;
  const int r = static_cast<int>(j - o * cs);
  const int ch = r / s;
  return o * cs + static_cast<long long>(r - ch * s) * c + ch;
}

// Sum over the block's kThreads values in the fixed halving tree; thread 0 gets it.
__device__ __forceinline__ float block_tree(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] = __fadd_rn(sh[threadIdx.x], sh[threadIdx.x + w]);
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(kThreads)
global_sumsq_partial_kernel(const __grid_constant__ NormList a, float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  const int ti = owner(a, blockIdx.x);
  const long long start = static_cast<long long>(blockIdx.x - a.chunk_first[ti]) * kChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kChunk), a.numel[ti] - start));
  const float* x = a.x[ti];
  const int gc = a.gc[ti], gs = a.gs[ti];
  const bool vec = gc == 0 && (reinterpret_cast<uintptr_t>(x + start) & 15) == 0;
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < kGroups; ++i) {
    const int base = (i * kThreads + threadIdx.x) * 4;
    if (base >= len) break;
    float v[4];
    if (vec && base + 4 <= len) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(x + start + base));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = base + u < len ? __ldg(x + g_at(start + base + u, gc, gs)) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = __fadd_rn(acc, __fmul_rn(v[u], v[u]));
  }
  const float s = block_tree(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
global_sumsq_finish_kernel(const float* __restrict__ partials, int n, float* __restrict__ norm) {
  __shared__ float sh[kThreads];
  float acc = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) acc = __fadd_rn(acc, __ldg(partials + j));
  const float s = block_tree(acc, sh);
  if (threadIdx.x == 0) *norm = __fsqrt_rn(s);
}

// One entry through the chain; g, mu, nu are read only where the kind uses them.
__device__ __forceinline__ void update(const Scalars& k, float nrm, float g, float& p,
                                       float& mu, float& nu, float& e) {
  if (k.kind != kEmaOnly) {
    if (!(nrm < k.clip)) g = __fmul_rn(__fdiv_rn(g, nrm), k.clip);
    if (k.kind == kAdamW) {
      mu = __fadd_rn(__fmul_rn(g, k.c1), __fmul_rn(mu, k.b1));
      nu = __fadd_rn(__fmul_rn(__fmul_rn(g, g), k.c2), __fmul_rn(nu, k.b2));
      const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, k.r2)), k.eps);
      const float u = __fadd_rn(__fdiv_rn(__fmul_rn(mu, k.r1), den), __fmul_rn(p, k.wd));
      p = __fadd_rn(p, __fmul_rn(u, k.neg_lr));
    } else {
      mu = __fadd_rn(__fmul_rn(mu, k.b1), g);
      p = __fadd_rn(p, __fmul_rn(mu, k.neg_lr));
    }
  }
  if (k.ema) e = __fadd_rn(__fmul_rn(e, k.d), __fmul_rn(p, k.one_minus_d));
}

__device__ __forceinline__ float4 ld4(const float* q) {
  return *reinterpret_cast<const float4*>(q);
}
__device__ __forceinline__ void st4(float* q, float4 v) { *reinterpret_cast<float4*>(q) = v; }

__global__ void __launch_bounds__(kThreads)
optim_apply_kernel(const __grid_constant__ ApplyList a, const Scalars k,
                   const float* __restrict__ norm) {
  const int ti = owner(a, blockIdx.x);
  const long long start = static_cast<long long>(blockIdx.x - a.chunk_first[ti]) * kChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kChunk), a.numel[ti] - start));
  const bool upd = k.kind != kEmaOnly, adam = k.kind == kAdamW;
  const float* g = upd ? a.g[ti] : nullptr;          // the tensor's first entry (g_at)
  const int gc = a.gc[ti], gs = a.gs[ti];
  float* p = a.p[ti] + start;
  float* mu = upd ? a.mu[ti] + start : nullptr;
  float* nu = adam ? a.nu[ti] + start : nullptr;
  float* e = k.ema ? a.e[ti] + start : nullptr;
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(mu) |
                     reinterpret_cast<uintptr_t>(nu) | reinterpret_cast<uintptr_t>(e)) & 15) == 0;
  const bool gvec = upd && gc == 0 && (reinterpret_cast<uintptr_t>(g + start) & 15) == 0;
  const float nrm = upd ? __ldg(norm) : 0.f;
  for (int i = 0; i < kGroups; ++i) {
    const int base = (i * kThreads + threadIdx.x) * 4;
    if (base >= len) break;
    if (vec && base + 4 <= len) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gv = zero;
      if (gvec) {
        gv = __ldg(reinterpret_cast<const float4*>(g + start + base));
      } else if (upd) {
        gv.x = __ldg(g + g_at(start + base, gc, gs));
        gv.y = __ldg(g + g_at(start + base + 1, gc, gs));
        gv.z = __ldg(g + g_at(start + base + 2, gc, gs));
        gv.w = __ldg(g + g_at(start + base + 3, gc, gs));
      }
      float4 pv = ld4(p + base);
      float4 mv = upd ? ld4(mu + base) : zero;
      float4 nv = adam ? ld4(nu + base) : zero;
      float4 ev = k.ema ? ld4(e + base) : zero;
      update(k, nrm, gv.x, pv.x, mv.x, nv.x, ev.x);
      update(k, nrm, gv.y, pv.y, mv.y, nv.y, ev.y);
      update(k, nrm, gv.z, pv.z, mv.z, nv.z, ev.z);
      update(k, nrm, gv.w, pv.w, mv.w, nv.w, ev.w);
      if (upd) { st4(p + base, pv); st4(mu + base, mv); }
      if (adam) st4(nu + base, nv);
      if (k.ema) st4(e + base, ev);
    } else {
      for (int j = base; j < base + 4 && j < len; ++j) {
        float pv = p[j], mv = upd ? mu[j] : 0.f, nv = adam ? nu[j] : 0.f;
        float ev = k.ema ? e[j] : 0.f;
        update(k, nrm, upd ? __ldg(g + g_at(start + j, gc, gs)) : 0.f, pv, mv, nv, ev);
        if (upd) { p[j] = pv; mu[j] = mv; }
        if (adam) nu[j] = nv;
        if (k.ema) e[j] = ev;
      }
    }
  }
}

// chunk_first of n tensors from their sizes; false if a size is negative or the chunks
// pass 2^31.
template <typename List>
bool plan(List& a, const int* numel, int n) {
  if (n < 1 || n > kMaxTensors) return false;
  a.n = n;
  long long c = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return false;
    a.numel[i] = numel[i];
    a.chunk_first[i] = static_cast<int>(c);
    c += (numel[i] + kChunk - 1) / kChunk;
    if (c >= (1LL << 31)) return false;
  }
  a.chunk_first[n] = static_cast<int>(c);
  return true;
}

}  // namespace

// {kThreads, kChunk, kMaxTensors}: the wrapper checks its own copy against these.
extern "C" int optim_layout(int* out) {
  out[0] = kThreads;
  out[1] = kChunk;
  out[2] = kMaxTensors;
  return 0;
}

// Partials of n (1 .. kMaxTensors) f32 tensors x[i] of numel[i] entries, one a chunk, into
// partials[0 ..); layout[2 i], layout[2 i + 1] = C, S of a channels-last x[i], else 0, 0.
// Returns cudaGetLastError() after the launch.
extern "C" int global_sumsq_partial(const void* const* x, const int* numel, const int* layout,
                                    int n, void* partials, void* stream) {
  NormList a;
  if (!plan(a, numel, n)) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i) {
    a.x[i] = static_cast<const float*>(x[i]);
    a.gc[i] = layout[2 * i];
    a.gs[i] = layout[2 * i + 1];
  }
  const int blocks = a.chunk_first[n];
  if (blocks == 0) return 0;
  global_sumsq_partial_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// norm = sqrt(sum of partials[0 .. n)), n >= 0. Returns cudaGetLastError().
extern "C" int global_sumsq_finish(const void* partials, int n, void* norm, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  global_sumsq_finish_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), n, static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}

// One pass over n (1 .. kMaxTensors) tensors of numel[i] f32 entries: g, mu and nu may be
// null where the kind does not read them, e where ema is 0, norm for kind 2 (the EMA
// alone); layout as for global_sumsq_partial, of g. scal = {clip, 1 - b1, b1, 1 - b2, b2,
// 1 / bc1, 1 / bc2, eps, wd, -lr, d, 1 - d} (b1 is the momentum for SGD). Returns
// cudaGetLastError() after the launch.
extern "C" int optim_apply(const void* const* g, void* const* p, void* const* mu,
                           void* const* nu, void* const* e, const int* numel,
                           const int* layout, int n,
                           const float* scal, int kind, int ema, const void* norm,
                           void* stream) {
  ApplyList a;
  if (!plan(a, numel, n) || kind < kAdamW || kind > kEmaOnly) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) {
    a.g[i] = g ? static_cast<const float*>(g[i]) : nullptr;
    a.p[i] = static_cast<float*>(p[i]);
    a.mu[i] = mu ? static_cast<float*>(mu[i]) : nullptr;
    a.nu[i] = nu ? static_cast<float*>(nu[i]) : nullptr;
    a.e[i] = e ? static_cast<float*>(e[i]) : nullptr;
    a.gc[i] = layout[2 * i];
    a.gs[i] = layout[2 * i + 1];
  }
  const Scalars k{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6], scal[7],
                  scal[8], scal[9], scal[10], scal[11], kind, ema};
  const int blocks = a.chunk_first[n];
  if (blocks == 0) return 0;
  optim_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, k, static_cast<const float*>(norm));
  return static_cast<int>(cudaGetLastError());
}
