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
// What bounds it on the card: bytes. At the widths this model uses (Cin, Cout 3..160),
// the work is K*Cin*Cout*2 flop per output row against ~K*Cin*s bytes of gathered
// input (s = 4 for f32, 2 for bf16), an arithmetic intensity far below the H100's
// ~295 flop/byte bf16 ridge and near or below its f32 ridge (~20). What held the
// first form of this kernel far from that bound was latency and dead work, so the
// design is a memory pipeline that pays only for live rows:
//
// 1. Indices first, dead tiles out. A block owns 64 output rows of one scene (and a
//    tile of 16, 32 or 64 output channels). It loads the tile's K x 64 indices once
//    into shared memory (16-byte loads where M_out allows) and marks out-of-range
//    entries -1. One barrier (__syncthreads_or) then tells whether any entry is
//    live: a tile with none writes zeros and exits, with no gather and no product.
//    Rows past a scene's valid count carry -1 on every tap, so a conv's tail tiles
//    cost only their index read; the dgrad's transposed rulebook has the same shape
//    of liveness. A live tile votes per tap and skips its dead taps (exact: a dead
//    tap adds +0).
// 2. An asynchronous ring over the live taps. Each stage holds one live tap's
//    gathered rows (a chunk of 32 input channels) and its W[k] tile. Stage s + 2 is
//    copied with cp.async (16 bytes where rows allow, else 8 or 4; a bf16 row of odd
//    width, 2-byte aligned only, is copied by plain loads) while stage s is
//    multiplied, in a ring of 3 stages. A -1 entry is a copy of source size 0: zeros
//    land in shared memory and nothing is read from global memory. TMA is not used:
//    it has no row gather on Hopper, and every row here comes from its own index.
//    With a few warps an SM, a stage's time is mostly dependent instruction
//    chains, so the loader keeps them short: where rows of Cin and Cout take
//    16-byte copies (the common case), each thread's copy slots are worked out
//    once per block; otherwise slots are dealt with shifts. Offsets within a scene
//    are 32-bit, dead copies select their source and predicate the copy instead
//    of branching, and the stages are walked with counters, not division.
// 3. Products. f32 stays on the CUDA cores (TF32 would lose the digits the f32
//    checks hold): each thread keeps a 2..8 row x 4 channel register tile and reads
//    shared memory as float4; at 2 rows (Cout 16) that is 3 bytes of shared memory
//    a FMA, which the SM's 128 bytes a cycle then bound. bf16 goes to the tensor
//    cores, mma.sync m16n8k16 with f32 sums, fed by ldmatrix from the ring; the
//    channel chunk is padded with zeros to 16. At these widths (Cout 16..160)
//    mma.sync is enough; wgmma (64-row warpgroup products from shared memory) waits
//    until a config with widths >= 64 is on the main path.
// 4. Occupancy. 128 threads and at most ~60 KB of shared memory a block, so about 4
//    blocks fit an SM and a config-1 conv's 384..512 row tiles are resident at once.
//    On the main path only 35..60 % of them are live (1.4..2.3 a SM), so what is
//    left is each live block's chain of stages (its loads' instruction chain and
//    its products' shared-memory reads), not device memory (PERF.md has the
//    measurements).
//
// Numerics: the sum is f32 for f32 and bf16 inputs alike; the output is stored in
// the input type (bf16 rounded to nearest even). Each tap's partial sum is formed
// over Cin and added to the accumulator in tap order k = 0..K-1, as the plain
// version (ops/sparse_conv.py::sparse_conv_reference) does. No atomics, no split-K:
// results are the same from run to run.
//
// Contract (checked by the Python wrapper): feats [B, M_in, Cin], idx int32
// [B, K, M_out], W [K, Cin, Cout], out [B, M_out, Cout], all contiguous on one
// device, feats and W of one type. Any M_out (the ragged last tile is masked), any
// Cin >= 1, any Cout >= 1, K up to ~680 (the tile's indices live in shared memory).
// An index outside [0, M_in) counts as no neighbour.
//
// The backward's input gradient (dgrad) is this same kernel, launched by the wrapper
// on (g, t_idx, W^T): d_feats[j] = sum_k g[t_idx[k, j]] @ W[k]^T, as the JAX package
// runs its Pallas kernel on the gathered cotangent in _bwd_shared (pallas branch,
// sparse_rcnn_tpu/ops/sparse_conv.py:536). The weight gradient (wgrad) is the second
// kernel pair below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;     // wgrad block size

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// Forward (and dgrad): the gather-GEMM.

constexpr int kFwdThreads = 128;  // 4 warps
constexpr int kTileM = 64;        // output rows per block
constexpr int kCinChunk = 32;     // input channels per ring stage
constexpr int kStages = 3;        // ring depth
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have on sm_90
constexpr int kMaxDevices = 64;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}
// row strides of a stage, in elements: 144-byte f32 rows put the float4 reads of 8
// rows on distinct banks; 80-byte bf16 rows (and W rows padded by 16 bytes) keep
// ldmatrix's 8-row reads free of bank conflicts
template <typename T>
__host__ __device__ constexpr int a_stride() {
  return is_f32<T>() ? kCinChunk + 4 : kCinChunk + 8;
}
template <typename T, int kCoutTile>
__host__ __device__ constexpr int w_stride() {
  return is_f32<T>() ? kCoutTile : kCoutTile + 8;
}
// the channels of a stage are padded with zeros to a multiple of this
template <typename T>
__host__ __device__ constexpr int chan_pad() {
  return is_f32<T>() ? 4 : 16;
}
template <typename T, int kCoutTile>
__host__ __device__ constexpr int stage_elems() {
  return kTileM * a_stride<T>() + kCinChunk * w_stride<T, kCoutTile>();
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy kBytes (16, 8, 4, or 2 for bf16) from global to shared memory if `make`; if
// !live, write zeros and read nothing (cp.async with source size 0). The predicate
// is the copy's own (@p), so a slot without a copy costs no branch. 2 bytes is a
// plain load and store.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool live, bool make) {
  if constexpr (kBytes == 2) {
    if (make)
      *static_cast<unsigned short*>(dst) =
          live ? *static_cast<const unsigned short*>(src) : static_cast<unsigned short>(0);
  } else if constexpr (kBytes == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
        " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(live ? 16u : 0u), "r"(static_cast<int>(make))
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %4, 0;\n"
        " @p cp.async.ca.shared.global [%0], [%1], %2, %3;\n}\n" ::"r"(smem_u32(dst)),
        "l"(src), "n"(kBytes), "r"(live ? static_cast<unsigned>(kBytes) : 0u),
        "r"(static_cast<int>(make))
        : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// fn(r, v, make) for the slots (r, v), r < rows, v < per_row, of one copy, dealt to
// the threads in row-major order with per_row rounded up to a power of two: the
// slots step by shifts, not by integer division, and each thread takes its slots
// in unrolled pairs with a predicate per slot (`make`) instead of a loop with
// branches, to keep the dependent chain of a stage's loads short.
template <typename Fn>
__device__ __forceinline__ void for_slots(int rows, int per_row, int tid, Fn fn) {
  const int sh = per_row <= 1 ? 0 : 32 - __clz(per_row - 1);
  const int mask = (1 << sh) - 1;
  const int total = rows << sh;
  for (int base = 0; base < total; base += 2 * kFwdThreads) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = base + i * kFwdThreads + tid;
      fn(min(e >> sh, rows - 1), e & mask, e < total && (e & mask) < per_row);
    }
  }
}

// Tap k's gathered rows: channels [c0, c0 + ccp) of feats[ix[r]], zeros for -1 rows
// and past Cin (cc channels are real). kBytes divides a row of Cin, so no copy
// straddles Cin. Offsets within a scene are 32-bit (M_in * Cin < 2^31), and dead
// copies select their source instead of branching around it.
template <int kBytes, typename T>
__device__ __forceinline__ void load_rows(T* a_s, const int* ix, const T* f_b, int c0, int cc,
                                          int ccp, int cin, int tid) {
  constexpr int kEl = kBytes / static_cast<int>(sizeof(T));
  for_slots(kTileM, ccp / kEl, tid, [&](int r, int v, bool make) {
    const int c = v * kEl;
    const int j = ix[r];
    const bool live = (j >= 0) & (c < cc);
    const unsigned off = live ? static_cast<unsigned>(j * cin + c0 + c) : 0u;
    copy_async<kBytes>(a_s + r * a_stride<T>() + c, f_b + off, live, make);
  });
}

// W[k]'s rows [c0, c0 + ccp) x columns [n0, n0 + kCoutTile) (w_k points at row c0,
// column n0), zeros past Cin and Cout. kBytes divides a row of Cout.
template <int kBytes, typename T, int kCoutTile>
__device__ __forceinline__ void load_w(T* w_s, const T* w_k, int n0, int cc, int ccp, int cout,
                                       int tid) {
  constexpr int kEl = kBytes / static_cast<int>(sizeof(T));
  for_slots(ccp, kCoutTile / kEl, tid, [&](int c, int v, bool make) {
    const int n = v * kEl;
    const bool live = (c < cc) & (n0 + n < cout);
    const unsigned off = live ? static_cast<unsigned>(c * cout + n) : 0u;
    copy_async<kBytes>(w_s + c * w_stride<T, kCoutTile>() + n, w_k + off, live, make);
  });
}

// The loader of the common case, where rows of Cin and of Cout both take 16-byte
// copies: each thread's (at most 4) slots of the A and W copies are the same in
// every stage, so they are worked out once, and a stage costs each slot one index
// read, an offset and a predicated cp.async. The general loader below works the
// slots and the copy width out in every stage, which takes about half of a stage's
// time in a block alone on an SM.
template <typename T, int kCoutTile>
struct FastLoader {
  static constexpr int kEl = 16 / static_cast<int>(sizeof(T));
  static constexpr int kSlots = 4;
  int a_r[kSlots], a_c[kSlots];  // row and channel of each A slot; a_r < 0: no copy
  int w_c[kSlots], w_n[kSlots];  // channel and column of each W slot; w_c < 0: no copy

  // ccp: the padded width of a full chunk (the widest stage). A row takes
  // ccp / kEl <= 8 copies, dealt as 2^a_sh slots; W's rows kCoutTile / kEl <= 16.
  // Both fit kSlots slots of kFwdThreads threads.
  __device__ __forceinline__ FastLoader(int ccp, int tid) {
    const int per_row = ccp / kEl;
    const int a_sh = per_row <= 1 ? 0 : 32 - __clz(per_row - 1);
    const int w_sh = 31 - __clz(kCoutTile / kEl);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int e = tid + i * kFwdThreads;
      const int v = e & ((1 << a_sh) - 1);
      a_r[i] = e < (kTileM << a_sh) && v < per_row ? e >> a_sh : -1;
      a_c[i] = v * kEl;
      w_c[i] = e < (ccp << w_sh) ? e >> w_sh : -1;
      w_n[i] = (e & ((1 << w_sh) - 1)) * kEl;
    }
  }

  __device__ __forceinline__ void load(T* stage, const int* ix, const T* f_b, const T* w, int k,
                                       int c0, int cin, int cout, int n0) const {
    const int cc = min(kCinChunk, cin - c0);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = max(a_r[i], 0);
      const int j = ix[r];
      const bool live = (j >= 0) & (a_c[i] < cc);
      const unsigned off = live ? static_cast<unsigned>(j * cin + c0 + a_c[i]) : 0u;
      copy_async<16>(stage + r * a_stride<T>() + a_c[i], f_b + off, live, a_r[i] >= 0);
    }
    T* w_s = stage + kTileM * a_stride<T>();
    const T* w_k = w + (static_cast<size_t>(k) * cin + c0) * cout + n0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int c = max(w_c[i], 0);
      const bool live = (c < cc) & (n0 + w_n[i] < cout);
      const unsigned off = live ? static_cast<unsigned>(c * cout + w_n[i]) : 0u;
      copy_async<16>(w_s + c * w_stride<T, kCoutTile>() + w_n[i], w_k + off, live, w_c[i] >= 0);
    }
  }
};

// The general loader: one ring stage (tap k's gathered rows and its W[k] tile for
// the channel chunk at c0) with the copy widths a_vec and w_vec (bytes) chosen once
// per launch.
template <typename T, int kCoutTile>
__device__ __forceinline__ void load_stage(T* stage, const int* ix, const T* f_b, const T* w,
                                           int k, int c0, int cin, int cout, int n0,
                                           int a_vec, int w_vec, int tid) {
  const int cc = min(kCinChunk, cin - c0);
  const int ccp = (cc + chan_pad<T>() - 1) / chan_pad<T>() * chan_pad<T>();
  switch (a_vec) {
    case 16: load_rows<16>(stage, ix, f_b, c0, cc, ccp, cin, tid); break;
    case 8: load_rows<8>(stage, ix, f_b, c0, cc, ccp, cin, tid); break;
    case 4: load_rows<4>(stage, ix, f_b, c0, cc, ccp, cin, tid); break;
    default:
      if constexpr (!is_f32<T>()) load_rows<2>(stage, ix, f_b, c0, cc, ccp, cin, tid);
  }
  T* w_s = stage + kTileM * a_stride<T>();
  const T* w_k = w + (static_cast<size_t>(k) * cin + c0) * cout + n0;
  switch (w_vec) {
    case 16: load_w<16, T, kCoutTile>(w_s, w_k, n0, cc, ccp, cout, tid); break;
    case 8: load_w<8, T, kCoutTile>(w_s, w_k, n0, cc, ccp, cout, tid); break;
    case 4: load_w<4, T, kCoutTile>(w_s, w_k, n0, cc, ccp, cout, tid); break;
    default:
      if constexpr (!is_f32<T>()) load_w<2, T, kCoutTile>(w_s, w_k, n0, cc, ccp, cout, tid);
  }
}

template <typename T, int kCoutTile>
struct GeneralLoader {
  int a_vec, w_vec, tid;

  __device__ __forceinline__ void load(T* stage, const int* ix, const T* f_b, const T* w, int k,
                                       int c0, int cin, int cout, int n0) const {
    load_stage<T, kCoutTile>(stage, ix, f_b, w, k, c0, cin, cout, n0, a_vec, w_vec, tid);
  }
};

// f32 products on the CUDA cores: thread (ty, tx) owns rows ty + i * kRowThreads
// and channels 4 tx .. 4 tx + 3 of the tile.
template <int kCoutTile>
struct FmaTile {
  static constexpr int kColThreads = kCoutTile / 4;
  static constexpr int kRowThreads = kFwdThreads / kColThreads;
  static constexpr int kRows = kTileM / kRowThreads;
  float part[kRows][4];
  float acc[kRows][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void end_tap() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += part[i][j];
        part[i][j] = 0.f;
      }
  }

  __device__ __forceinline__ void multiply(const float* stage, int ccp, int tid) {
    constexpr int kAStride = a_stride<float>();
    const float* a_s = stage + (tid / kColThreads) * kAStride;
    const float* w_s = stage + kTileM * kAStride + (tid % kColThreads) * 4;
#pragma unroll 2
    for (int c = 0; c < ccp; c += 4) {
      float4 wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(w_s + (c + q) * kCoutTile);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(a_s + i * kRowThreads * kAStride + c);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          part[i][0] = fmaf(av[q], wv[q].x, part[i][0]);
          part[i][1] = fmaf(av[q], wv[q].y, part[i][1]);
          part[i][2] = fmaf(av[q], wv[q].z, part[i][2]);
          part[i][3] = fmaf(av[q], wv[q].w, part[i][3]);
        }
      }
    }
  }

  __device__ __forceinline__ void write(float* out_b, int m0, int n0, int m_out, int cout,
                                        int tid) const {
    const int n = n0 + (tid % kColThreads) * 4;
    const bool vec = (cout & 3) == 0 && (reinterpret_cast<uintptr_t>(out_b) & 15) == 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int m = m0 + tid / kColThreads + i * kRowThreads;
      if (m >= m_out) continue;
      float* o = out_b + static_cast<size_t>(m) * cout;
      if (vec && n + 3 < cout) {
        *reinterpret_cast<float4*>(o + n) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < cout) o[n + j] = acc[i][j];
      }
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// bf16 products on the tensor cores: warp w owns rows 16 (w % 4) .. 16 (w % 4) + 15
// of the tile and, with more than 4 warps, one of kColGroups column groups (w / 4), as
// kBlocks m16n8 accumulators. Lane l holds rows l / 4 and l / 4 + 8, channels
// 2 (l % 4) and 2 (l % 4) + 1 of each.
template <int kCoutTile>
struct MmaTile {
  static constexpr int kColGroups = kFwdThreads / 128;
  static constexpr int kBlocks = kCoutTile / (8 * kColGroups);
  float part[kBlocks][4];
  float acc[kBlocks][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void end_tap() {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += part[i][j];
        part[i][j] = 0.f;
      }
  }

  __device__ __forceinline__ void multiply(const __nv_bfloat16* stage, int ccp, int tid) {
    constexpr int kAStride = a_stride<__nv_bfloat16>();
    constexpr int kWStride = w_stride<__nv_bfloat16, kCoutTile>();
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // ldmatrix rows: A's 16 rows of this warp, two 8-channel halves; W's 16
    // channels, one or two 8-column blocks
    const __nv_bfloat16* a_s =
        stage + ((warp & 3) * 16 + (lane & 15)) * kAStride + (lane >> 4) * 8;
    const __nv_bfloat16* w_s = stage + kTileM * kAStride + (lane & 15) * kWStride +
                               (warp >> 2) * (kBlocks * 8) + (kBlocks > 1 ? (lane >> 4) * 8 : 0);
    for (int ks = 0; ks < ccp; ks += 16) {
      unsigned a[4];
      ldmatrix_x4(a, a_s + ks);
      if constexpr (kBlocks == 1) {
        unsigned b[2];
        ldmatrix_x2_trans(b, w_s + ks * kWStride);
        mma_bf16(part[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < kBlocks / 2; ++p) {
          unsigned b[4];
          ldmatrix_x4_trans(b, w_s + ks * kWStride + p * 16);
          mma_bf16(part[2 * p], a, b[0], b[1]);
          mma_bf16(part[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void write(__nv_bfloat16* out_b, int m0, int n0, int m_out,
                                        int cout, int tid) const {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int row = m0 + (warp & 3) * 16 + (lane >> 2);
    const bool pair = (cout & 1) == 0 && (reinterpret_cast<uintptr_t>(out_b) & 3) == 0;
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      const int n = n0 + (warp >> 2) * (kBlocks * 8) + i * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (m >= m_out || n >= cout) continue;
        __nv_bfloat16* o = out_b + static_cast<size_t>(m) * cout + n;
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[i][2 * h], acc[i][2 * h + 1]);
        } else {
          o[0] = __float2bfloat16_rn(acc[i][2 * h]);
          if (n + 1 < cout) o[1] = __float2bfloat16_rn(acc[i][2 * h + 1]);
        }
      }
    }
  }
};

template <typename T, int kCoutTile>
using ProductTile =
    typename std::conditional<is_f32<T>(), FmaTile<kCoutTile>, MmaTile<kCoutTile>>::type;

__device__ __forceinline__ int live_or_dead(int j, int m_in) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(m_in) ? j : -1;
}

// The ring over (live tap, channel chunk) stages, chunks inner: the loader runs
// kStages - 1 stages ahead of the products, both walked with counters (no
// division); the products add each tap's partial sum in tap order. Then the tile's
// sums are written.
template <typename T, int kCoutTile, typename Loader>
__device__ __forceinline__ void run_ring(const Loader& loader, unsigned char* smem,
                                         const int* idx_s, const int* taps, int n_live,
                                         const T* f_b, const T* w, T* out_b, int m0, int n0,
                                         int m_out, int cin, int cout, int tid) {
  constexpr int kStage = stage_elems<T, kCoutTile>();
  T* ring = reinterpret_cast<T*>(smem);
  const int n_stages = n_live * ((cin + kCinChunk - 1) / kCinChunk);
  int load_tap = 0, load_c0 = 0, load_buf = 0;
  auto load_next = [&]() {
    const int k = taps[load_tap];
    loader.load(ring + load_buf * kStage, idx_s + k * kTileM, f_b, w, k, load_c0, cin, cout, n0);
    load_c0 += kCinChunk;
    if (load_c0 >= cin) {
      load_c0 = 0;
      ++load_tap;
    }
    load_buf = load_buf == kStages - 1 ? 0 : load_buf + 1;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_next();
    cp_async_commit();
  }
  ProductTile<T, kCoutTile> tile;
  tile.zero();
  int c0 = 0, buf = 0;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and stage s - 1 is no longer read
    if (s + kStages - 1 < n_stages) load_next();
    cp_async_commit();
    const int cc = min(kCinChunk, cin - c0);
    tile.multiply(ring + buf * kStage, (cc + chan_pad<T>() - 1) / chan_pad<T>() * chan_pad<T>(),
                  tid);
    c0 += kCinChunk;
    if (c0 >= cin) {
      c0 = 0;
      tile.end_tap();
    }
    buf = buf == kStages - 1 ? 0 : buf + 1;
  }
  tile.write(out_b, m0, n0, m_out, cout, tid);
}

// One block per (64 output rows, tile of kCoutTile output channels, scene). Dynamic
// shared memory: the ring (kStages stages), then the tile's indices [K][64], the
// per-tap live flags [K], the live taps in order [K] and their count.
template <typename T, int kCoutTile>
__global__ void __launch_bounds__(kFwdThreads, kCoutTile == 64 ? 3 : 4)
sparse_conv_fwd_kernel(const T* __restrict__ feats, const int* __restrict__ idx,
                       const T* __restrict__ w, T* __restrict__ out, int m_in, int m_out,
                       int k_taps, int cin, int cout, int a_vec, int w_vec, int idx_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* idx_s = reinterpret_cast<int*>(smem + kStages * stage_elems<T, kCoutTile>() * sizeof(T));
  int* flags = idx_s + k_taps * kTileM;
  int* taps = flags + k_taps;
  int* n_taps = taps + k_taps;

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kCoutTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* idx_b = idx + static_cast<size_t>(b) * k_taps * m_out;
  T* out_b = out + static_cast<size_t>(b) * m_out * cout;

  // 1. the tile's indices, out-of-range entries as -1
  bool any_live = false;
  if (idx_vec && m0 + kTileM <= m_out) {
    for (int e = tid; e < k_taps * (kTileM / 4); e += kFwdThreads) {
      const int k = e / (kTileM / 4);
      const int q = (e - k * (kTileM / 4)) * 4;
      int4 v = *reinterpret_cast<const int4*>(idx_b + static_cast<size_t>(k) * m_out + m0 + q);
      v.x = live_or_dead(v.x, m_in);
      v.y = live_or_dead(v.y, m_in);
      v.z = live_or_dead(v.z, m_in);
      v.w = live_or_dead(v.w, m_in);
      any_live |= (v.x & v.y & v.z & v.w) >= 0;  // some entry is not -1
      *reinterpret_cast<int4*>(idx_s + k * kTileM + q) = v;
    }
  } else {
    for (int e = tid; e < k_taps * kTileM; e += kFwdThreads) {
      const int k = e / kTileM;
      const int m = m0 + e - k * kTileM;
      const int j =
          m < m_out ? live_or_dead(idx_b[static_cast<size_t>(k) * m_out + m], m_in) : -1;
      idx_s[e] = j;
      any_live |= j >= 0;
    }
  }
  if (!__syncthreads_or(any_live)) {  // a dead tile: zeros, no gather, no product
    for (int e = tid; e < kTileM * kCoutTile; e += kFwdThreads) {
      const int m = m0 + e / kCoutTile;
      const int n = n0 + e % kCoutTile;
      if (m < m_out && n < cout) store(out_b + static_cast<size_t>(m) * cout + n, 0.f);
    }
    return;
  }
  // 2. a vote per tap, then the live taps in order
  for (int k = warp; k < k_taps; k += kFwdThreads / 32) {
    const bool any = __any_sync(0xffffffffu, idx_s[k * kTileM + lane] >= 0 ||
                                                 idx_s[k * kTileM + lane + 32] >= 0);
    if (lane == 0) flags[k] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int k0 = 0; k0 < k_taps; k0 += 32) {
      const int k = k0 + lane;
      const bool live = k < k_taps && flags[k];
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) taps[n + __popc(mask & ((1u << lane) - 1u))] = k;
      n += __popc(mask);
    }
    if (lane == 0) *n_taps = n;
  }
  __syncthreads();
  const int n_live = *n_taps;

  // 3. the ring over the live taps
  const T* f_b = feats + static_cast<size_t>(b) * m_in * cin;
  const int ccp = (min(kCinChunk, cin) + chan_pad<T>() - 1) / chan_pad<T>() * chan_pad<T>();
  if (a_vec == 16 && w_vec == 16)
    run_ring<T, kCoutTile>(FastLoader<T, kCoutTile>(ccp, tid), smem, idx_s, taps, n_live, f_b, w,
                           out_b, m0, n0, m_out, cin, cout, tid);
  else
    run_ring<T, kCoutTile>(GeneralLoader<T, kCoutTile>{a_vec, w_vec, tid}, smem, idx_s, taps,
                           n_live, f_b, w, out_b, m0, n0, m_out, cin, cout, tid);
}

// The widest copy (16, 8 or 4 bytes; 2 for bf16 rows of odd width) that divides a
// row of `row_elems` elements and the alignment of `p`.
template <typename T>
int copy_bytes(const void* p, long long row_elems) {
  const long long row = row_elems * static_cast<long long>(sizeof(T));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v > static_cast<int>(sizeof(T)); v /= 2)
    if (row % v == 0 && addr % v == 0) return v;
  return static_cast<int>(sizeof(T));
}

template <typename T, int kCoutTile>
int launch(const void* feats, const void* idx, const void* w, void* out, int batch, int m_in,
           int m_out, int k_taps, int cin, int cout, cudaStream_t stream) {
  const size_t smem = kStages * stage_elems<T, kCoutTile>() * sizeof(T) +
                      (static_cast<size_t>(k_taps) * (kTileM + 2) + 1) * sizeof(int);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB dynamic shared memory needs this once per kernel instance and device
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !granted[dev]) {
    err = cudaFuncSetAttribute(sparse_conv_fwd_kernel<T, kCoutTile>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) granted[dev] = true;
  }
  const int idx_vec = m_out % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const dim3 grid((m_out + kTileM - 1) / kTileM, (cout + kCoutTile - 1) / kCoutTile, batch);
  sparse_conv_fwd_kernel<T, kCoutTile><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const int*>(idx), static_cast<const T*>(w),
      static_cast<T*>(out), m_in, m_out, k_taps, cin, cout, copy_bytes<T>(feats, cin),
      copy_bytes<T>(w, cout), idx_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* feats, const void* idx, const void* w, void* out, int batch, int m_in,
             int m_out, int k_taps, int cin, int cout, cudaStream_t stream) {
  if (cout <= 16)
    return launch<T, 16>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, stream);
  if (cout <= 32)
    return launch<T, 32>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, stream);
  return launch<T, 64>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, stream);
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

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch (or
// the error of setting the kernel's shared-memory limit, or cudaErrorInvalidValue).
extern "C" int sparse_conv_forward(const void* feats, const void* idx, const void* w,
                                   void* out, int batch, int m_in, int m_out, int k_taps,
                                   int cin, int cout, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || m_out < 1 || k_taps < 1 || cin < 1 || cout < 1 ||
      m_in < 0 || (dtype != 0 && dtype != 1) ||
      static_cast<long long>(m_in) * cin >= (1LL << 31) ||
      static_cast<long long>(cin) * cout >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, s);
  return dispatch<__nv_bfloat16>(feats, idx, w, out, batch, m_in, m_out, k_taps, cin, cout, s);
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
