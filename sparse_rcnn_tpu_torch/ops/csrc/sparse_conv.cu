// Fused gather-GEMM sparse convolution, forward and backward, for Hopper (sm_90a).
//
//   out[b, i, :] = sum_{k = 0..K-1} (idx[b, k, i] >= 0 ? feats[b, idx[b, k, i], :] : 0) @ W[k]
//
// Replaces the TPU kernel sparse_rcnn_tpu/ops/pallas_conv.py::tap_accumulate_matmul
// together with the XLA row gather that feeds it in pallas_conv.pallas_conv and
// sparse_conv.blocked_matmul_conv. There the [K, M, Cin] gathered tensor is written
// to HBM by XLA and read back by the kernel; here it is never materialised: each
// block gathers its rows by rulebook index straight into shared memory.
//
// What bounds it on the card: bytes. At the widths this model uses (Cout <= 32 for
// config 1), the work is K*Cin*Cout*2 flop per output row against ~K*Cin*s bytes of
// gathered input (s = 4 for f32, 2 for bf16), an arithmetic intensity far below the
// H100's ~295 flop/byte bf16 ridge and below its f32 ridge (~20) as well. (Counted
// with each input read once from HBM, the f32 convs at Cout 32 tip to operations on
// the CUDA cores, which this kernel uses; the bf16 ones stay bytes.) So the design
// keeps traffic at its minimum: the gathered rows are read once per tap, come from
// L2 (a scale's feature table is a few MB) into shared memory, the f32 sum stays in
// registers across all K taps, and the output is written once. wgmma, TMA and a
// software pipeline are later work; this is the simple, correct first form.
//
// Numerics: the sum is f32 for f32 and bf16 inputs alike; the output is stored in
// the input type (bf16 rounded to nearest even). Each tap's partial sum is formed
// over Cin in ascending order and added to the accumulator in tap order k = 0..K-1,
// as the plain version (ops/sparse_conv.py::sparse_conv_reference) does. No atomics,
// no split-K: results are the same from run to run.
//
// Contract (checked by the Python wrapper): feats [B, M_in, Cin], idx int32
// [B, K, M_out], W [K, Cin, Cout], out [B, M_out, Cout], all contiguous on one
// device, feats and W of one type. Any M_out (the ragged last tile is masked), any
// Cin >= 1, any Cout >= 1. An index outside [0, M_in) counts as no neighbour.
//
// The backward's input gradient (dgrad) is this same kernel, launched by the wrapper
// on (g, t_idx, W^T): d_feats[j] = sum_k g[t_idx[k, j]] @ W[k]^T, as the JAX package
// runs its Pallas kernel on the gathered cotangent in _bwd_shared (pallas branch,
// sparse_rcnn_tpu/ops/sparse_conv.py:536). The weight gradient (wgrad) is the second
// kernel pair below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;     // output rows per block
constexpr int kCinChunk = 32;  // input channels staged in shared memory per step

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One block per (tile of kTileM output rows, tile of kCoutTile output channels, scene).
// Thread t owns column t % kCoutTile and rows t / kCoutTile + r * kRowStep.
template <typename T, int kCoutTile>
__global__ void __launch_bounds__(kThreads)
sparse_conv_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                       const T* __restrict__ w, T* __restrict__ out,
                       int m_in, int m_out, int k_taps, int cin, int cout) {
  constexpr int kRowStep = kThreads / kCoutTile;
  constexpr int kRowsPerThread = kTileM / kRowStep;
  // +1 column of padding keeps the gather's row-major writes off one bank
  __shared__ float a_s[kTileM][kCinChunk + 1];
  __shared__ float w_s[kCinChunk][kCoutTile];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kCoutTile;
  const int tid = threadIdx.x;
  const int col = tid % kCoutTile;
  const int row0 = tid / kCoutTile;

  const T* f_b = feats + static_cast<size_t>(b) * m_in * cin;
  const int* idx_b = idx + static_cast<size_t>(b) * k_taps * m_out;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;

  for (int k = 0; k < k_taps; ++k) {
    const int* idx_k = idx_b + static_cast<size_t>(k) * m_out;
    const T* w_k = w + static_cast<size_t>(k) * cin * cout;
    float part[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) part[r] = 0.f;

    for (int c0 = 0; c0 < cin; c0 += kCinChunk) {
      const int cc = min(kCinChunk, cin - c0);
      // gather: neighbouring threads read neighbouring channels of one row
      for (int e = tid; e < kTileM * cc; e += kThreads) {
        const int r = e / cc;
        const int c = e - r * cc;
        const int m = m0 + r;
        float v = 0.f;
        if (m < m_out) {
          const int j = idx_k[m];
          if (j >= 0 && j < m_in) v = to_float(f_b[static_cast<size_t>(j) * cin + c0 + c]);
        }
        a_s[r][c] = v;
      }
      for (int e = tid; e < cc * kCoutTile; e += kThreads) {
        const int c = e / kCoutTile;
        const int n = e - c * kCoutTile;
        w_s[c][n] = (n0 + n < cout) ? to_float(w_k[static_cast<size_t>(c0 + c) * cout + n0 + n]) : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < cc; ++c) {
        const float wv = w_s[c][col];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          part[r] = fmaf(a_s[row0 + r * kRowStep][c], wv, part[r]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] += part[r];
  }

  const int n = n0 + col;
  if (n >= cout) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + row0 + r * kRowStep;
    if (m < m_out) store(out + (static_cast<size_t>(b) * m_out + m) * cout + n, acc[r]);
  }
}

template <typename T, int kCoutTile>
void launch(const void* feats, const void* idx, const void* w, void* out, int batch,
            int m_in, int m_out, int k_taps, int cin, int cout, cudaStream_t stream) {
  const dim3 grid((m_out + kTileM - 1) / kTileM, (cout + kCoutTile - 1) / kCoutTile, batch);
  sparse_conv_fwd_kernel<T, kCoutTile><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(idx), static_cast<const T*>(w),
      static_cast<T*>(out), m_in, m_out, k_taps, cin, cout);
}

template <typename T>
void dispatch(const void* feats, const void* idx, const void* w, void* out, int batch,
              int m_in, int m_out, int k_taps, int cin, int cout, cudaStream_t stream) {
  if (cout <= 16)
    launch<T, 16>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, stream);
  else if (cout <= 32)
    launch<T, 32>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, stream);
  else
    launch<T, 64>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, stream);
}

// ---------------------------------------------------------------------------
// Weight gradient (wgrad), deterministic, in two passes.
//
//   dW[k] = sum_b sum_j feats[b, j]^T (x) G_k[b, j],
//   G_k[b, j] = t_idx[b, k, j] >= 0 ? g[b, t_idx[b, k, j]] : 0      (f32 sums)
//
// Replaces the einsum "bc,kbd->kcd" of the JAX package's shared backward
// (sparse_rcnn_tpu/ops/sparse_conv.py::_bwd_shared, pallas branch, line 542), which
// XLA computes beside the Pallas dgrad on the same gathered cotangent, summed over
// row tiles in scan order and then over scenes.
//
// What bounds it on the card: bytes. Each (tap, row) pair costs Cin*Cout FMAs against
// one gathered g row and one feats row (Cin + Cout values): at config 1's widths
// (<= 32) that is below the f32 ridge of the CUDA cores once each input is counted
// once, and far below the bf16 tensor-core ridge. So the design reads each input row
// once per tap from L2 into shared memory, keeps the [Cin, Cout] sum of its rows in
// registers, and writes one partial tile per block.
//
// Pass 1: one block per (chunk of rows of one scene, tap k, tile of 32 input channels
// x 16 or 32 output channels). It stages 32 rows at a time: feats[j] and the gathered
// g[t_idx[k, j]] (-1 -> 0) into shared memory, then each thread adds the products
// of its (c, n) entries in row order. The tile goes to partials[k, chunk, Cin, Cout].
// Pass 2: one thread per (k, c, n) adds the partials of all chunks in chunk order
// (scene 0 first) into out[k, c, n], f32.
//
// No atomics: the chunking depends only on the shapes, so the result is the same bit
// for bit from run to run. Contract (checked by the Python wrapper): feats
// [B, M_in, Cin], t_idx int32 [B, K, M_in], g [B, M_out, Cout], feats and g of one
// type (f32 or bf16), partials f32 [K, B * n_chunks, Cin, Cout], out f32 [K, Cin, Cout],
// all contiguous on one device; chunk c of scene b covers rows
// [c * rows_per_chunk, min(M_in, (c + 1) * rows_per_chunk)). Any M, Cin >= 1, Cout >= 1.
// An index outside [0, M_out) counts as no neighbour.

constexpr int kWTileC = 32;  // input channels per block
constexpr int kWStage = 32;  // rows staged in shared memory per step

template <typename T, int kTileN>
__global__ void __launch_bounds__(kThreads)
sparse_conv_wgrad_partial_kernel(const T* __restrict__ feats, const int* __restrict__ t_idx,
                                 const T* __restrict__ g, float* __restrict__ partials,
                                 int m_in, int m_out, int k_taps, int cin, int cout,
                                 int rows_per_chunk, int n_chunks) {
  constexpr int kRowStep = kThreads / kTileN;        // 16 or 8 channel rows
  constexpr int kCPerThread = kWTileC / kRowStep;    // 2 or 4 entries per thread
  // +1 column of padding keeps the staging writes off one bank
  __shared__ float f_s[kWStage][kWTileC + 1];
  __shared__ float g_s[kWStage][kTileN];

  const int chunk = blockIdx.x;                       // b * n_chunks + chunk of scene b
  const int b = chunk / n_chunks;
  const int j_begin = (chunk - b * n_chunks) * rows_per_chunk;
  const int j_end = min(m_in, j_begin + rows_per_chunk);
  const int k = blockIdx.y;
  const int n_ctiles = (cin + kWTileC - 1) / kWTileC;
  const int c0 = (blockIdx.z % n_ctiles) * kWTileC;
  const int n0 = (blockIdx.z / n_ctiles) * kTileN;
  const int tid = threadIdx.x;
  const int col = tid % kTileN;
  const int crow = tid / kTileN;

  const T* f_b = feats + static_cast<size_t>(b) * m_in * cin;
  const T* g_b = g + static_cast<size_t>(b) * m_out * cout;
  const int* ti = t_idx + (static_cast<size_t>(b) * k_taps + k) * m_in;

  float acc[kCPerThread];
#pragma unroll
  for (int q = 0; q < kCPerThread; ++q) acc[q] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kWStage) {
    for (int e = tid; e < kWStage * kWTileC; e += kThreads) {
      const int r = e / kWTileC;
      const int c = e - r * kWTileC;
      const int j = j0 + r;
      f_s[r][c] = (j < j_end && c0 + c < cin)
                      ? to_float(f_b[static_cast<size_t>(j) * cin + c0 + c]) : 0.f;
    }
    for (int e = tid; e < kWStage * kTileN; e += kThreads) {
      const int r = e / kTileN;
      const int n = e - r * kTileN;
      const int j = j0 + r;
      float v = 0.f;
      if (j < j_end && n0 + n < cout) {
        const int i = ti[j];
        if (i >= 0 && i < m_out) v = to_float(g_b[static_cast<size_t>(i) * cout + n0 + n]);
      }
      g_s[r][n] = v;
    }
    __syncthreads();
    for (int r = 0; r < kWStage; ++r) {
      const float gv = g_s[r][col];
#pragma unroll
      for (int q = 0; q < kCPerThread; ++q)
        acc[q] = fmaf(f_s[r][crow + q * kRowStep], gv, acc[q]);
    }
    __syncthreads();
  }

  const int n = n0 + col;
  if (n >= cout) return;
  float* p = partials + (static_cast<size_t>(k) * gridDim.x + chunk) * cin * cout;
#pragma unroll
  for (int q = 0; q < kCPerThread; ++q) {
    const int c = c0 + crow + q * kRowStep;
    if (c < cin) p[static_cast<size_t>(c) * cout + n] = acc[q];
  }
}

// out[k, c, n] = sum over chunks, in chunk order, of partials[k, chunk, c, n]
__global__ void __launch_bounds__(kThreads)
sparse_conv_wgrad_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                int k_taps, int total_chunks, int tile) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<size_t>(k_taps) * tile) return;
  const size_t k = e / tile;
  const float* p = partials + k * total_chunks * tile + (e - k * tile);
  float s = 0.f;
  for (int c = 0; c < total_chunks; ++c) s += p[static_cast<size_t>(c) * tile];
  out[e] = s;
}

template <typename T, int kTileN>
void launch_wgrad(const void* feats, const void* t_idx, const void* g, float* partials,
                  float* out, int batch, int m_in, int m_out, int k_taps, int cin, int cout,
                  int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  const int tiles = ((cin + kWTileC - 1) / kWTileC) * ((cout + kTileN - 1) / kTileN);
  const dim3 grid(batch * n_chunks, k_taps, tiles);
  sparse_conv_wgrad_partial_kernel<T, kTileN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(t_idx), static_cast<const T*>(g),
      partials, m_in, m_out, k_taps, cin, cout, rows_per_chunk, n_chunks);
  const size_t total = static_cast<size_t>(k_taps) * cin * cout;
  sparse_conv_wgrad_reduce_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                                    kThreads, 0, stream>>>(partials, out, k_taps,
                                                           batch * n_chunks, cin * cout);
}

template <typename T>
void dispatch_wgrad(const void* feats, const void* t_idx, const void* g, float* partials,
                    float* out, int batch, int m_in, int m_out, int k_taps, int cin, int cout,
                    int rows_per_chunk, int n_chunks, cudaStream_t stream) {
  if (cout <= 16)
    launch_wgrad<T, 16>(feats, t_idx, g, partials, out, batch, m_in, m_out, k_taps, cin, cout,
                        rows_per_chunk, n_chunks, stream);
  else
    launch_wgrad<T, 32>(feats, t_idx, g, partials, out, batch, m_in, m_out, k_taps, cin, cout,
                        rows_per_chunk, n_chunks, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int sparse_conv_forward(const void* feats, const void* idx, const void* w,
                                   void* out, int batch, int m_in, int m_out, int k_taps,
                                   int cin, int cout, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || m_out < 1 || k_taps < 1 || cin < 1 || cout < 1 ||
      m_in < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, s);
  else
    dispatch<__nv_bfloat16>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, s);
  return static_cast<int>(cudaGetLastError());
}

// Weight gradient: pass 1 into partials f32 [K, batch * n_chunks, Cin, Cout], pass 2
// into out f32 [K, Cin, Cout]. dtype: 0 = float32, 1 = bfloat16 (feats and g).
// Returns cudaGetLastError() after the two launches.
extern "C" int sparse_conv_wgrad(const void* feats, const void* t_idx, const void* g,
                                 void* partials, void* out, int batch, int m_in, int m_out,
                                 int k_taps, int cin, int cout, int rows_per_chunk,
                                 int n_chunks, int dtype, void* stream) {
  if (batch < 1 || m_in < 1 || m_out < 0 || k_taps < 1 || k_taps > 65535 || cin < 1 ||
      cout < 1 || rows_per_chunk < 1 || n_chunks < 1 ||
      static_cast<long long>(rows_per_chunk) * n_chunks < m_in ||
      static_cast<long long>(rows_per_chunk) * (n_chunks - 1) >= m_in ||
      static_cast<long long>(batch) * n_chunks > 2147483647LL || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    dispatch_wgrad<float>(feats, t_idx, g, p, o, batch, m_in, m_out, k_taps, cin, cout,
                          rows_per_chunk, n_chunks, s);
  else
    dispatch_wgrad<__nv_bfloat16>(feats, t_idx, g, p, o, batch, m_in, m_out, k_taps, cin,
                                  cout, rows_per_chunk, n_chunks, s);
  return static_cast<int>(cudaGetLastError());
}
