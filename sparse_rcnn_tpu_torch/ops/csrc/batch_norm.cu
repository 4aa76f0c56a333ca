// Masked BatchNorm + ReLU of the sparse UNet's norms, for Hopper (sm_90a):
//
//   bn_stats (pass 1):  s1 = [sum_live x, sum m]                fixed-order sums, f32
//   bn_stats (pass 2):  s2 = sum_live (x - mean)^2              mean = s1 / max(s1[C], 1)
//   bn_apply:           the vectors, then y = relu(((x - mean) * inv + bias) * m), each
//                       operation rounded to T
//   bn_grad (sums):     s = [sum_live g', sum_live g' xh]       g' = g where z > 0, else 0
//   bn_grad (input):    dx = m k (n g' - s[0] - xh s[1]),  k = scale rstd / n  (training)
//                       dx = m scale rstd g'                                (running stats)
//
// x, g, y and dx are [rows, C] in T (float or bf16); m is one bool a row; the statistics
// and the gradient's sums are f32; z is the ReLU's input and xh = (x - mean) rstd in f32.
// The vectors are the chain's torch operations on [C], one rounding each: n = max(s1[C],
// 1), mean = s1 / n, var = s2 / n (or the running statistics), the running statistics
// r = r momentum + (1 - momentum) batch, rstd = rsqrt(var + eps), and in T mean, inv =
// rstd scale and bias; bn_apply leaves [mean, rstd, n] (f32) and [mean, inv, bias] (T)
// for the backward.
//
// Not a TPU kernel: the JAX package's BatchNorm is plain XLA, which fuses it into the
// convs around it. The port ran it as an eager chain (models/layers.py::
// MaskedBatchNorm.normalize and the ReLU after it): about 35 launches forward and 31
// backward a norm, half of them over the whole [rows, C] tensor and mostly in f32, about
// 66 bytes an entry forward and 80 backward, some 250 GB a config-3 train step over its
// 44 norms (and the 36 that remat recomputes).
//
// What bounds it: bytes. Every pass reads each live entry of x once (and g in the
// backward), in 16-byte loads where the rows allow; a dead row (m = 0) is neither read
// nor summed, and its output is written as zero. Forward: two reads for the statistics,
// one read and one write for the apply, 8 B an entry in bf16; backward: x and g for the
// sums, x and g again and dx for the input's gradient, 10 B an entry.
//
// Layout of the work: a block is (C / V lanes) x (256 / lanes rows at once), V entries a
// lane (16 bytes of T, else 1). The statistics and the gradient's sums are deterministic:
// a partial kernel gives each block a fixed run of rows; each thread adds its rows in
// order, the block adds its row slots in order; a finish kernel adds the blocks' partials
// in a fixed order (32 slices of every 32nd partial, then a halving tree). The number of
// blocks is a function of the rows alone. No atomics: a recomputed forward gives the
// first run's bits.
//
// Arithmetic: the library is built with -fmad=false and every product and sum is an
// __f*_rn intrinsic. The apply repeats the chain's operations in T: x - mean, * inv,
// + bias, * m, each rounded to T as torch rounds each eager operation (T = float: no
// rounding beyond f32), then torch.relu's clamp_min (NaN kept, fmaxf). Given the same
// mean, inv and bias its output is the chain's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kSlices = 32;     // finish: the partials of a column are added in 32 slices

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T: the result of one eager operation in T
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 q;
    T* e = reinterpret_cast<T*>(&q);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(f[i]);
  }
}

// The ReLU's input of a live entry (m = 1), as the chain computes it in T; a dead row's
// (m = 0) is a signed zero, whose ReLU is 0.
template <typename T>
__device__ __forceinline__ float pre_relu(float x, float mean, float inv, float bias) {
  const float t = rnd<T>(__fsub_rn(x, mean));
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(t, inv)), bias));
}

// torch.relu on CUDA: clamp_min(v, 0), a NaN kept
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// The first row of block b and the end of its run.
__device__ __forceinline__ void run_of(int rows, int per_block, long long& r0, long long& r1) {
  r0 = static_cast<long long>(blockIdx.x) * per_block;
  r1 = min(r0 + per_block, static_cast<long long>(rows));
}

// Block b's sums: slot k's width values acc[k][0 .. width) (in shared memory) added over
// the slots in order, into partials[b][0 .. width).
__device__ __forceinline__ void block_sums(const float* sh, int slots, int width,
                                           float* __restrict__ partials) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  for (int c = tid; c < width; c += nt) {
    float s = 0.f;
    for (int k = 0; k < slots; ++k) s = __fadd_rn(s, sh[k * width + c]);
    partials[static_cast<long long>(blockIdx.x) * width + c] = s;
  }
}

// The batch count from pass 1's sums, as torch.clamp(min=1) gives it.
__device__ __forceinline__ float batch_count(const float* s1, int C) { return fmaxf(s1[C], 1.f); }

// Pass 1 (s1 == nullptr): partials[b] = [sum_live x (C), sum m]; pass 2: partials[b] =
// sum_live (x - mean)^2 (C) with pass 1's mean, over block b's run of rows.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                        const float* __restrict__ s1, int rows, int C, int per_block,
                        float* __restrict__ partials) {
  __shared__ float sh[kThreads * 8 + kThreads];   // [slot][C + 1]: slots * C <= kThreads * V
  const int RG = blockDim.y, rg = threadIdx.y, c0 = threadIdx.x * V;
  const bool second = s1 != nullptr;
  const int width = second ? C : C + 1;
  float mu[V], acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = second ? __fdiv_rn(s1[c0 + i], batch_count(s1, C)) : 0.f;
    acc[i] = 0.f;
  }
  float n = 0.f;
  long long r0, r1;
  run_of(rows, per_block, r0, r1);
  for (long long r = r0 + rg; r < r1; r += U * RG) {
    bool live[U];
    float f[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + u * RG;
      live[u] = rr < r1 && mask[rr];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live[u]) load<T, V>(x + (r + u * RG) * C + c0, f[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
      n = __fadd_rn(n, 1.f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (second) {
          const float d = __fsub_rn(f[u][i], mu[i]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(d, d));
        } else {
          acc[i] = __fadd_rn(acc[i], f[u][i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sh[rg * width + c0 + i] = acc[i];
  if (!second && threadIdx.x == 0) sh[rg * width + C] = n;
  __syncthreads();
  block_sums(sh, RG, width, partials);
}

// partials[b] = [sum_live g' (C), sum_live g' xh (C)] over block b's run of rows.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
bn_grad_partial_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                       const T* __restrict__ g, const T* __restrict__ mean_t,
                       const T* __restrict__ inv_t, const T* __restrict__ bias_t,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       int rows, int C, int per_block, float* __restrict__ partials) {
  __shared__ float sh[2 * kThreads * 8];          // [slot][2 C]
  const int RG = blockDim.y, rg = threadIdx.y, c0 = threadIdx.x * V;
  float mt[V], it[V], bt[V], mu[V], rs[V], a1[V], a2[V];
  load<T, V>(mean_t + c0, mt);
  load<T, V>(inv_t + c0, it);
  load<T, V>(bias_t + c0, bt);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = mean[c0 + i];
    rs[i] = rstd[c0 + i];
    a1[i] = a2[i] = 0.f;
  }
  long long r0, r1;
  run_of(rows, per_block, r0, r1);
  for (long long r = r0 + rg; r < r1; r += U * RG) {
    bool live[U];
    float f[U][V], gv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + u * RG;
      live[u] = rr < r1 && mask[rr];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
      load<T, V>(x + (r + u * RG) * C + c0, f[u]);
      load<T, V>(g + (r + u * RG) * C + c0, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gp = pre_relu<T>(f[u][i], mt[i], it[i], bt[i]) > 0.f ? gv[u][i] : 0.f;
        const float xh = __fmul_rn(__fsub_rn(f[u][i], mu[i]), rs[i]);
        a1[i] = __fadd_rn(a1[i], gp);
        a2[i] = __fadd_rn(a2[i], __fmul_rn(gp, xh));
      }
    }
  }
  const int width = 2 * C;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sh[rg * width + c0 + i] = a1[i];
    sh[rg * width + C + c0 + i] = a2[i];
  }
  __syncthreads();
  block_sums(sh, RG, width, partials);
}

// out[c] = sum over b of partials[b][c]: slice s adds b = s, s + kSlices, ... in order,
// then the slices are halved in a fixed tree (s + w onto s).
__global__ void __launch_bounds__(32 * kSlices)
bn_finish_kernel(const float* __restrict__ partials, int blocks, int width,
                 float* __restrict__ out) {
  __shared__ float sh[kSlices][33];
  const int c = blockIdx.x * 32 + threadIdx.x, s = threadIdx.y;
  float acc = 0.f;
  if (c < width) {
    for (int b = s; b < blocks; b += kSlices) {
      acc = __fadd_rn(acc, partials[static_cast<long long>(b) * width + c]);
    }
  }
  sh[s][threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int w = kSlices / 2; w > 0; w >>= 1) {
    if (s < w) sh[s][threadIdx.x] = __fadd_rn(sh[s][threadIdx.x], sh[s + w][threadIdx.x]);
    __syncthreads();
  }
  if (s == 0 && c < width) out[c] = sh[0][threadIdx.x];
}

// The vectors of the module docstring: stats = [mean, rstd, n] f32, vecs = [mean, inv,
// bias] in T; s1 == nullptr for the running statistics (n = 0); the running statistics
// move when update is set.
template <typename T>
__global__ void bn_vectors_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ bias, float* __restrict__ rmean,
                                  float* __restrict__ rvar, int C, float momentum,
                                  float one_minus, float eps, int update,
                                  float* __restrict__ stats, T* __restrict__ vecs) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float mean = rmean[c], var = rvar[c];
    if (s1) {
      const float n = batch_count(s1, C);
      mean = __fdiv_rn(s1[c], n);
      var = __fdiv_rn(s2[c], n);
      if (update) {
        rmean[c] = __fadd_rn(__fmul_rn(rmean[c], momentum), __fmul_rn(mean, one_minus));
        rvar[c] = __fadd_rn(__fmul_rn(rvar[c], momentum), __fmul_rn(var, one_minus));
      }
    }
    if (c == 0) stats[2 * C] = s1 ? batch_count(s1, C) : 0.f;
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    stats[c] = mean;
    stats[C + c] = rstd;
    vecs[c] = from_f<T>(mean);
    vecs[C + c] = from_f<T>(__fmul_rn(rstd, scale[c]));
    vecs[2 * C + c] = from_f<T>(bias[c]);
  }
}

// y = relu(((x - mean) * inv + bias) * m) over U * (rows at once) rows a block.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                const T* __restrict__ mean_t, const T* __restrict__ inv_t,
                const T* __restrict__ bias_t, int rows, int C, T* __restrict__ y) {
  const int RG = blockDim.y, c0 = threadIdx.x * V;
  float mt[V], it[V], bt[V];
  load<T, V>(mean_t + c0, mt);
  load<T, V>(inv_t + c0, it);
  load<T, V>(bias_t + c0, bt);
  const long long base = static_cast<long long>(blockIdx.x) * RG * U + threadIdx.y;
  bool live[U];
  float f[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = base + u * RG;
    live[u] = r < rows && mask[r];
    if (live[u]) load<T, V>(x + r * C + c0, f[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = base + u * RG;
    if (r >= rows) break;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      f[u][i] = live[u] ? relu(pre_relu<T>(f[u][i], mt[i], it[i], bt[i])) : 0.f;
    }
    store<T, V>(y + r * C + c0, f[u]);
  }
}

// dx of U * (rows at once) rows a block: sums == nullptr for the running statistics.
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
bn_grad_input_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                     const T* __restrict__ g, const T* __restrict__ mean_t,
                     const T* __restrict__ inv_t, const T* __restrict__ bias_t,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     const float* __restrict__ scale, const float* __restrict__ sums,
                     const float* __restrict__ count, int rows, int C, T* __restrict__ dx) {
  const int RG = blockDim.y, c0 = threadIdx.x * V;
  const bool train = sums != nullptr;
  const float n = train ? *count : 1.f;
  float mt[V], it[V], bt[V], mu[V], rs[V], k[V], s1[V], s2[V];
  load<T, V>(mean_t + c0, mt);
  load<T, V>(inv_t + c0, it);
  load<T, V>(bias_t + c0, bt);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = mean[c0 + i];
    rs[i] = rstd[c0 + i];
    const float gr = __fmul_rn(scale[c0 + i], rs[i]);
    k[i] = train ? __fdiv_rn(gr, n) : gr;
    s1[i] = train ? sums[c0 + i] : 0.f;
    s2[i] = train ? sums[C + c0 + i] : 0.f;
  }
  const long long base = static_cast<long long>(blockIdx.x) * RG * U + threadIdx.y;
  bool live[U];
  float f[U][V], gv[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = base + u * RG;
    live[u] = r < rows && mask[r];
    if (live[u]) {
      load<T, V>(x + r * C + c0, f[u]);
      load<T, V>(g + r * C + c0, gv[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = base + u * RG;
    if (r >= rows) break;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float d = 0.f;
      if (live[u]) {
        const float gp = pre_relu<T>(f[u][i], mt[i], it[i], bt[i]) > 0.f ? gv[u][i] : 0.f;
        if (train) {
          const float xh = __fmul_rn(__fsub_rn(f[u][i], mu[i]), rs[i]);
          d = __fmul_rn(k[i], __fsub_rn(__fsub_rn(__fmul_rn(n, gp), s1[i]),
                                        __fmul_rn(xh, s2[i])));
        } else {
          d = __fmul_rn(k[i], gp);
        }
      }
      f[u][i] = d;
    }
    store<T, V>(dx + r * C + c0, f[u]);
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The block of a [rows, C] pass in V-wide lanes; false if C does not fit one.
template <int V>
bool shape(int C, dim3& block) {
  if (C < 1 || C % V != 0 || C / V > kThreads) return false;
  block = dim3(C / V, kThreads / (C / V));
  return true;
}

constexpr int kStatsUnroll = 4, kGradUnroll = 2, kApplyUnroll = 4;

template <typename T, int V>
int stats(const T* x, const uint8_t* mask, const float* s1, int rows, int C, int blocks,
          float* partials, float* out, cudaStream_t st) {
  dim3 block;
  if (!shape<V>(C, block)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (rows + blocks - 1) / blocks;
  bn_stats_partial_kernel<T, V, kStatsUnroll><<<blocks, block, 0, st>>>(
      x, mask, s1, rows, C, per_block, partials);
  const int width = s1 ? C : C + 1;
  bn_finish_kernel<<<(width + 31) / 32, dim3(32, kSlices), 0, st>>>(partials, blocks, width,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}

struct Vectors {
  const float *s1, *s2, *scale, *bias;
  float *rmean, *rvar;
  float momentum, one_minus, eps;
  int update;
  float* stats;
};

template <typename T, int V>
int apply(const T* x, const uint8_t* mask, const Vectors& v, int rows, int C, T* y, T* vecs,
          cudaStream_t st) {
  dim3 block;
  if (!shape<V>(C, block)) return static_cast<int>(cudaErrorInvalidValue);
  bn_vectors_kernel<T><<<1, kThreads, 0, st>>>(v.s1, v.s2, v.scale, v.bias, v.rmean, v.rvar, C,
                                              v.momentum, v.one_minus, v.eps, v.update,
                                              v.stats, vecs);
  if (rows > 0) {
    const int per = block.y * kApplyUnroll;
    bn_apply_kernel<T, V, kApplyUnroll><<<(rows + per - 1) / per, block, 0, st>>>(
        x, mask, vecs, vecs + C, vecs + 2 * C, rows, C, y);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int grad_sums(const T* x, const uint8_t* mask, const T* g, const T* mean_t, const T* inv_t,
              const T* bias_t, const float* mean, const float* rstd, int rows, int C,
              int blocks, float* partials, float* out, cudaStream_t st) {
  dim3 block;
  if (!shape<V>(C, block)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (rows + blocks - 1) / blocks;
  bn_grad_partial_kernel<T, V, kGradUnroll><<<blocks, block, 0, st>>>(
      x, mask, g, mean_t, inv_t, bias_t, mean, rstd, rows, C, per_block, partials);
  bn_finish_kernel<<<(2 * C + 31) / 32, dim3(32, kSlices), 0, st>>>(partials, blocks, 2 * C,
                                                                    out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int grad_input(const T* x, const uint8_t* mask, const T* g, const T* mean_t, const T* inv_t,
               const T* bias_t, const float* mean, const float* rstd, const float* scale,
               const float* sums, const float* count, int rows, int C, T* dx,
               cudaStream_t st) {
  dim3 block;
  if (!shape<V>(C, block)) return static_cast<int>(cudaErrorInvalidValue);
  const int per = block.y * kGradUnroll;
  bn_grad_input_kernel<T, V, kGradUnroll><<<(rows + per - 1) / per, block, 0, st>>>(
      x, mask, g, mean_t, inv_t, bias_t, mean, rstd, scale, sums, count, rows, C, dx);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte lanes where C and every row pointer allow them, else one entry a lane.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
bool vec_ok(int C, std::initializer_list<const void*> ptrs) {
  if (C % kVec<T> != 0) return false;
  for (const void* p : ptrs) {
    if (p && !aligned(p)) return false;
  }
  return true;
}

}  // namespace

// Pass 1 (s1 null): out[0 .. C] = [sum_live x, sum m]; pass 2: out[0 .. C) =
// sum_live (x - mean)^2 with pass 1's sums s1 [C + 1]. x [rows, C] of dtype 0 (f32) or 1
// (bf16), mask [rows] bool, partials [blocks, C + 1] f32 scratch, blocks >= 1. Returns
// cudaGetLastError().
extern "C" int bn_stats(const void* x, const void* mask, const void* s1, int rows, int C,
                        int dtype, int blocks, void* partials, void* out, void* stream) {
  if (rows < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto m = static_cast<const uint8_t*>(mask);
  const auto s = static_cast<const float*>(s1);
  const auto p = static_cast<float*>(partials);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto xt = static_cast<const float*>(x);
    return vec_ok<float>(C, {x}) ? stats<float, 4>(xt, m, s, rows, C, blocks, p, o, st)
                                 : stats<float, 1>(xt, m, s, rows, C, blocks, p, o, st);
  }
  const auto xt = static_cast<const bf16*>(x);
  return vec_ok<bf16>(C, {x}) ? stats<bf16, 8>(xt, m, s, rows, C, blocks, p, o, st)
                              : stats<bf16, 1>(xt, m, s, rows, C, blocks, p, o, st);
}

// The vectors (from s1 and s2, null for the running statistics rmean and rvar, which move
// when update is set), then y = relu(((x - mean) * inv + bias) * m); scale, bias, rmean,
// rvar [C] f32; stats [2 C + 1] f32 and vecs [3 C] of x's type are written.
extern "C" int bn_apply(const void* x, const void* mask, const void* s1, const void* s2,
                        const void* scale, const void* bias, void* rmean, void* rvar, int rows,
                        int C, int dtype, float momentum, float one_minus, float eps,
                        int update, void* y, void* stats, void* vecs, void* stream) {
  if (rows < 0 || (s1 == nullptr) != (s2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Vectors v{f(s1), f(s2), f(scale), f(bias), static_cast<float*>(rmean),
                  static_cast<float*>(rvar), momentum, one_minus, eps, update,
                  static_cast<float*>(stats)};
  const auto m = static_cast<const uint8_t*>(mask);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto a = [&](auto w) {
      constexpr int V = decltype(w)::value;
      return apply<float, V>(f(x), m, v, rows, C, static_cast<float*>(y),
                             static_cast<float*>(vecs), st);
    };
    return vec_ok<float>(C, {x, y, vecs}) ? a(std::integral_constant<int, 4>())
                                          : a(std::integral_constant<int, 1>());
  }
  const auto a = [&](auto w) {
    constexpr int V = decltype(w)::value;
    return apply<bf16, V>(static_cast<const bf16*>(x), m, v, rows, C, static_cast<bf16*>(y),
                          static_cast<bf16*>(vecs), st);
  };
  return vec_ok<bf16>(C, {x, y, vecs}) ? a(std::integral_constant<int, 8>())
                                       : a(std::integral_constant<int, 1>());
}

// out[0 .. 2C) = [sum_live g', sum_live g' xh], from bn_apply's stats and vecs; partials
// [blocks, 2 C] f32 scratch, blocks >= 1.
extern "C" int bn_grad_sums(const void* x, const void* mask, const void* g, const void* stats,
                            const void* vecs, int rows, int C, int dtype, int blocks,
                            void* partials, void* out, void* stream) {
  if (rows < 0 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto m = static_cast<const uint8_t*>(mask);
  const auto sf = static_cast<const float*>(stats);
  const auto p = static_cast<float*>(partials);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto vt = static_cast<const float*>(vecs);
    const auto run = [&](auto w) {
      constexpr int V = decltype(w)::value;
      return grad_sums<float, V>(static_cast<const float*>(x), m, static_cast<const float*>(g),
                                 vt, vt + C, vt + 2 * C, sf, sf + C, rows, C, blocks, p, o, st);
    };
    return vec_ok<float>(C, {x, g, vecs}) ? run(std::integral_constant<int, 4>())
                                          : run(std::integral_constant<int, 1>());
  }
  const auto vt = static_cast<const bf16*>(vecs);
  const auto run = [&](auto w) {
    constexpr int V = decltype(w)::value;
    return grad_sums<bf16, V>(static_cast<const bf16*>(x), m, static_cast<const bf16*>(g), vt,
                              vt + C, vt + 2 * C, sf, sf + C, rows, C, blocks, p, o, st);
  };
  return vec_ok<bf16>(C, {x, g, vecs}) ? run(std::integral_constant<int, 8>())
                                       : run(std::integral_constant<int, 1>());
}

// dx [rows, C] in x's type from bn_apply's stats and vecs, scale [C] f32 and sums (the
// global [sum g', sum g' xh]; null for the running statistics).
extern "C" int bn_grad_input(const void* x, const void* mask, const void* g, const void* stats,
                             const void* vecs, const void* scale, const void* sums, int rows,
                             int C, int dtype, void* dx, void* stream) {
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto m = static_cast<const uint8_t*>(mask);
  const auto sf = static_cast<const float*>(stats);
  const auto sc = static_cast<const float*>(scale);
  const auto su = static_cast<const float*>(sums);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto vt = static_cast<const float*>(vecs);
    const auto run = [&](auto w) {
      constexpr int V = decltype(w)::value;
      return grad_input<float, V>(static_cast<const float*>(x), m,
                                  static_cast<const float*>(g), vt, vt + C, vt + 2 * C, sf,
                                  sf + C, sc, su, sf + 2 * C, rows, C, static_cast<float*>(dx),
                                  st);
    };
    return vec_ok<float>(C, {x, g, dx, vecs}) ? run(std::integral_constant<int, 4>())
                                              : run(std::integral_constant<int, 1>());
  }
  const auto vt = static_cast<const bf16*>(vecs);
  const auto run = [&](auto w) {
    constexpr int V = decltype(w)::value;
    return grad_input<bf16, V>(static_cast<const bf16*>(x), m, static_cast<const bf16*>(g), vt,
                               vt + C, vt + 2 * C, sf, sf + C, sc, su, sf + 2 * C, rows, C,
                               static_cast<bf16*>(dx), st);
  };
  return vec_ok<bf16>(C, {x, g, dx, vecs}) ? run(std::integral_constant<int, 8>())
                                           : run(std::integral_constant<int, 1>());
}
