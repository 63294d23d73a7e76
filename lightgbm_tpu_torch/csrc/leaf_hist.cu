// The exact grower's leaf histogram (B5) for Hopper (sm_90a): one scan of
// the leaf ids, fused with the histogram, then a conversion that zeroes
// the sums for the next call (no memset).
//
// Replaces (JAX package, TPU Pallas):
//   lightgbm_tpu/ops/pallas_hist.py::leaf_histogram_pallas
//     (kernel _hist_kernel)             -> lgbt_leaf_hist
//
// Contract.  X (N, F) uint8 or uint16 row-major bins, w3 (N, 3) f32 (or
// float64, the f64 form of tpu_use_dp) [g*m, h*m, m], leaf_id (N,) int32,
// the leaf as a one-element int32 device tensor (read here, never on the
// host), the tree's fixed-point exponents (fixed_point.cuh).  hist[f, b, :]
// sums w3 over the rows whose leaf id is the leaf and whose bin in feature
// f is b; bins >= B are dropped.  The sums are those of B4 at K = 1
// (csrc/wave_fused.cu) to the bit: the same 64-bit (128-bit when wide)
// fixed point, added exactly and in any order.
//
// What bounds it on this card.  A call must read all N leaf ids (8 MB at
// N = 2M: 2.4 us at 3.35 TB/s), and each of the leaf's rows' bins and
// weights once; the exact grower's leaves are mostly small (up to 255 a
// tree), so the ids are the bound of most calls.  B4's chain at K = 1 is
// four device operations a call (a memset, the select pass over the ids,
// the histogram pass over its list, the conversion), each with its own
// fixed cost; at N = 2M, F = 28, 63 bins it replays in 13.5 us at no row
// and 18.0 at ~N/4096 rows (wide_hist_ab.py --b5; PERF.md, PR 21).
//
// Design.
//  1. One launch of a persistent grid (the blocks resident at once: one
//     of kThreads threads an SM) walks the leaf ids once.  Each warp
//     takes kSub chunks of kChunk rows at a time (four 16-byte loads of
//     four ids a lane, all in flight together: at N = 2M one round of the
//     grid reads every id) and picks out the leaf's rows with a ballot
//     into a queue of its own in shared memory.  A chunk with no row of
//     the leaf costs its load and one ballot.
//  2. Once the queue holds 32 rows, each lane adds one of them into the
//     block's shared histogram of all F features (its bins in 4-byte
//     words, its weights quantized as B4 does, row_quant, two 32-bit
//     shared atomics a 64-bit channel): a dense leaf keeps every lane on
//     rows of its own.  The rows left at the end of the walk (fewer than
//     32 a warp: all of a small leaf's) go as (row, feature) items over
//     the lanes, item t being row t / F's feature t % F, so a small
//     leaf's row is F short chains of atomics on F lanes and not one
//     chain of 3 F on one lane.
//  3. Each block adds only its non-zero cells into the int64 sums with
//     global atomics.  A second launch (leaf_finish_kernel) converts the
//     sums to f32 (f64 when wide) as finish_kernel does and zeroes them
//     for the next call, so a finish=True call is two launches and needs
//     no memset.  Converting in the launch's last block instead (a ticket
//     after a __threadfence, so no block waits for another) was measured
//     and dropped: at N = 2M, F = 28, 63 bins it replayed 1.0-1.9 us
//     slower a call than the second launch at every leaf size (the fence
//     waits for the block's flush; wide_hist_ab.py --b5, PERF.md, PR 21).
//     The deferred form (no conversion) leaves the sums for a distributed
//     learner's all-reduce, on sums the wrapper zeroes first (a memset:
//     its consumer reads them twice).
//  4. Where one block cannot hold the (F, B, 3) cells (uint16 at 1023
//     bins is 687 KB; f64 past 63 bins) the wrapper keeps B4's plan
//     (ops/leaf_hist.py leaf_plan).  A thread block cluster holding them
//     in distributed shared memory was measured and dropped: on an H100
//     at N = 2M, uint16 at 1023 bins, a cluster of 4 took 0.105 ms at
//     ~N/64 rows and 5.17 ms at the root, against B4's chain's 0.038 and
//     0.217 (remote shared-memory atomics).  So were four interleaved
//     copies of the cells (their zeroing and flush cost 2-3 us a call for
//     2% at the root) and items for every row (a dense leaf ran at half
//     the rate of one lane a row).
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 1024;          // one block fills an SM's warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;             // rows of one 16-byte load a lane
constexpr int kSub = 4;                 // chunks a warp loads at a time
constexpr int kQueue = 32 + kChunk;     // a warp's queue: < 32 left + a chunk

template <bool BINS16>
using BinT = typename std::conditional<BINS16, uint16_t, uint8_t>::type;
template <bool WIDE>
using Quant = typename std::conditional<WIDE, lgbt::Q128,
                                        unsigned long long>::type;

struct LeafArgs {
  const void* x;                    // X (N, F) bins
  const void* w3;                   // (N, 3) f32, or float64 when wide
  const int* lid;                   // (N,) leaf ids
  const int* leaf;                  // (1,) the leaf
  const int* exps;                  // (3,) fixed-point exponents
  unsigned long long* acc;          // F * B * 3 sums (2 words when wide)
  int F, N, B;
};

// The three channels of row `row` in the fixed point (B4's row_quant).
template <bool WIDE>
__device__ __forceinline__ void quant_row(const void* __restrict__ wv,
                                          int row, const int* e,
                                          const double* sc,
                                          Quant<WIDE> (&q)[3]) {
  if constexpr (WIDE) {
    const double* wr = static_cast<const double*>(wv) +
                       3 * static_cast<size_t>(row);
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = lgbt::quantize128(wr[c], e[c]);
  } else {
    const float* wr = static_cast<const float*>(wv) +
                      3 * static_cast<size_t>(row);
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = lgbt::quantize(wr[c], sc[c]);
  }
}

// The three channels q added to the cells at p (one word of each of the
// NW planes `words` apart).
template <bool WIDE>
__device__ __forceinline__ void add_cells(unsigned* p, int words,
                                          const Quant<WIDE> (&q)[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    if constexpr (WIDE)
      lgbt::add128(p + ch, p + ch + words, p + ch + 2 * words,
                   p + ch + 3 * words, q[ch]);
    else
      lgbt::add64(p + ch, p + ch + words, q[ch]);
  }
}

// (lo, hi) added to the int64 sums' cell o (two words when WIDE).
template <bool WIDE>
__device__ __forceinline__ void add_global(unsigned long long* acc, size_t o,
                                           unsigned long long lo,
                                           unsigned long long hi) {
  if constexpr (WIDE) {
    unsigned long long* cell = acc + 2 * o;
    const unsigned long long old = atomicAdd(cell, lo);
    const unsigned long long h = hi + (old + lo < old ? 1ull : 0ull);
    if (h != 0ull) atomicAdd(cell + 1, h);
  } else {
    atomicAdd(acc + o, lo);
  }
}

// Cell i of the sums converted (f32, or f64 from two words when WIDE).
template <bool WIDE>
__device__ __forceinline__ void put(void* hist, long long i,
                                    unsigned long long lo,
                                    unsigned long long hi, const int* e) {
  const int c = static_cast<int>(i % 3);
  if constexpr (WIDE)
    static_cast<double*>(hist)[i] = lgbt::to_f64(lo, hi, e[c]);
  else
    static_cast<float*>(hist)[i] = lgbt::to_f32(lo, e[c]);
}

// One lane's row: its F bins (4-byte words where words4) and weights
// into the shared cells.
template <bool BINS16, bool WIDE>
__device__ __forceinline__ void add_row(const LeafArgs& a, int row,
                                        unsigned* planes, int words,
                                        bool words4, const int* e,
                                        const double* sc) {
  using T = BinT<BINS16>;
  constexpr int PER = 4 / static_cast<int>(sizeof(T));   // bins a word
  constexpr unsigned MASK = (1u << (8 * sizeof(T))) - 1u;
  Quant<WIDE> q[3];
  quant_row<WIDE>(a.w3, row, e, sc, q);
  const T* xr = static_cast<const T*>(a.x) + static_cast<size_t>(row) * a.F;
  for (int f0 = 0; f0 < a.F; f0 += PER) {
    unsigned wd = 0u;
    if (words4) {
      wd = reinterpret_cast<const unsigned*>(xr)[f0 / PER];
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (f0 + k < a.F)
          wd |= static_cast<unsigned>(xr[f0 + k]) << (8 * sizeof(T) * k);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int b = static_cast<int>((wd >> (8 * sizeof(T) * k)) & MASK);
      if (f0 + k < a.F && b < a.B)
        add_cells<WIDE>(planes + ((f0 + k) * a.B + b) * 3, words, q);
    }
  }
}

// The n rows rows[0..n) as (row, feature) items over the warp's lanes:
// item t is row t / F's feature t % F.
template <bool BINS16, bool WIDE>
__device__ __forceinline__ void add_items(const LeafArgs& a, const int* rows,
                                          int n, int lane, unsigned* planes,
                                          int words, const int* e,
                                          const double* sc) {
  const BinT<BINS16>* __restrict__ x =
      static_cast<const BinT<BINS16>*>(a.x);
  const int F = a.F;
  const int dr = 32 / F, df = 32 - dr * F;   // 32 items on: rows, features
  int r = lane / F, f = lane - (lane / F) * F;
  for (int t = lane; t < n * F; t += 32) {
    const int row = rows[r];
    const int b = static_cast<int>(x[static_cast<size_t>(row) * F + f]);
    if (b < a.B) {
      Quant<WIDE> q[3];
      quant_row<WIDE>(a.w3, row, e, sc, q);
      add_cells<WIDE>(planes + (f * a.B + b) * 3, words, q);
    }
    f += df;
    r += dr;
    if (f >= F) {
      f -= F;
      ++r;
    }
  }
}

// The kernel (design above).  Dynamic shared memory: NW planes (2, or 4
// when WIDE) of `words` = F * B * 3 32-bit words.
template <bool BINS16, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
leaf_hist_kernel(LeafArgs a) {
  extern __shared__ __align__(16) unsigned planes[];
  __shared__ int queue[kWarps][kQueue];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = a.F * a.B * 3;       // the cells: one plane
  constexpr int NW = WIDE ? 4 : 2;
  {
    uint4* p = reinterpret_cast<uint4*>(planes);
    const int n4 = NW * words / 4;
    for (int i = tid; i < n4; i += kThreads) p[i] = make_uint4(0, 0, 0, 0);
    for (int i = 4 * n4 + tid; i < NW * words; i += kThreads) planes[i] = 0u;
  }
  __syncthreads();
  const int leaf = *a.leaf;
  const int e[3] = {a.exps[0], a.exps[1], a.exps[2]};
  const double sc[3] = {ldexp(1.0, e[0]), ldexp(1.0, e[1]),
                        ldexp(1.0, e[2])};
  const bool words4 =
      (a.F * static_cast<int>(sizeof(BinT<BINS16>))) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(a.x) & 3) == 0;
  const bool ids4 = (reinterpret_cast<uintptr_t>(a.lid) & 15) == 0;
  const long long N = a.N;
  const long long chunks = (N + kChunk - 1) / kChunk;
  const long long step = static_cast<long long>(gridDim.x) * kWarps * kSub;
  int* q = queue[warp];
  int qn = 0;                            // the warp's queued rows

  for (long long c0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                      kSub;
       c0 < chunks; c0 += step) {
    // kSub chunks' ids, four a lane each, loaded together (~leaf past
    // the last row: never the leaf)
    int v[kSub][4];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const long long r0 = (c0 + s) * kChunk + 4 * lane;
      if (ids4 && r0 + 3 < N) {
        const int4 t = __ldcs(reinterpret_cast<const int4*>(a.lid + r0));
        v[s][0] = t.x;
        v[s][1] = t.y;
        v[s][2] = t.z;
        v[s][3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[s][j] = r0 + j < N ? a.lid[r0 + j] : ~leaf;
      }
    }
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      int mine = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) mine += v[s][j] == leaf;
      if (__ballot_sync(0xffffffffu, mine) == 0u) continue;
      // the lanes' rows in lane order: an exclusive prefix of the counts
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      int at = qn + incl - mine;
      const long long r0 = (c0 + s) * kChunk + 4 * lane;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v[s][j] == leaf) q[at++] = static_cast<int>(r0 + j);
      qn += __shfl_sync(0xffffffffu, incl, 31);
      __syncwarp();
      while (qn >= 32) {                 // the last 32 queued rows, a lane
        const int row = q[qn - 32 + lane];   // each
        __syncwarp();
        qn -= 32;
        add_row<BINS16, WIDE>(a, row, planes, words, words4, e, sc);
      }
    }
  }
  add_items<BINS16, WIDE>(a, q, qn, lane, planes, words, e, sc);
  __syncthreads();

  // the block's non-zero cells into the sums
  for (int i = tid; i < words; i += kThreads) {
    const unsigned long long lo =
        (static_cast<unsigned long long>(planes[words + i]) << 32) |
        planes[i];
    unsigned long long hi = 0ull;
    if constexpr (WIDE)
      hi = (static_cast<unsigned long long>(planes[3 * words + i]) << 32) |
           planes[2 * words + i];
    if (lo == 0ull && hi == 0ull) continue;
    add_global<WIDE>(a.acc, i, lo, hi);
  }
}

// The conversion: hist from the sums with the exponents, the sums zeroed
// for the next call.
template <bool WIDE>
__global__ void leaf_finish_kernel(unsigned long long* __restrict__ acc,
                                   const int* __restrict__ exps,
                                   void* __restrict__ hist, long long cells) {
  const int e[3] = {exps[0], exps[1], exps[2]};
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if constexpr (WIDE) {
      put<WIDE>(hist, i, acc[2 * i], acc[2 * i + 1], e);
      acc[2 * i] = 0ull;
      acc[2 * i + 1] = 0ull;
    } else {
      put<WIDE>(hist, i, acc[i], 0ull, e);
      acc[i] = 0ull;
    }
  }
}

// The dynamic shared memory of a block: F x B x 3 cells of 64 bits (128
// when wide).
size_t leaf_smem(int F, int B, bool wide) {
  return (wide ? 16ull : 8ull) * F * B * 3;
}

using LeafKernel = void (*)(LeafArgs);

LeafKernel kernel_of(bool bins16, bool wide) {
  static const LeafKernel k[2][2] = {
      {&leaf_hist_kernel<false, false>, &leaf_hist_kernel<false, true>},
      {&leaf_hist_kernel<true, false>, &leaf_hist_kernel<true, true>}};
  return k[bins16][wide];
}

// The dynamic shared memory each kernel has been granted on each device.
int leaf_granted[2][2][lgbt::kMaxDevices];

// The blocks resident at once of each (F, B, bins16, wide) on a device,
// so that a launch asks the occupancy API once (under a lock: ctypes
// calls run without the GIL, and thread ranks share the library).
struct GridMemo {
  int key[5];
  int blocks;
};
constexpr int kMemo = 64;
GridMemo grid_memo[kMemo];
int grid_memo_n = 0;
std::mutex grid_memo_lock;

// The kernel of the form, allowed its shared memory, and its grid: one
// round of resident blocks.
cudaError_t leaf_config(int F, int B, bool bins16, bool wide,
                        LeafKernel* kern, size_t* smem, int* blocks) {
  if (F < 1 || B < 1) return cudaErrorInvalidValue;
  *kern = kernel_of(bins16, wide);
  *smem = leaf_smem(F, B, wide);
  cudaError_t e = lgbt::allow_smem(reinterpret_cast<const void*>(*kern),
                                   *smem, leaf_granted[bins16][wide]);
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  const int key[5] = {F, B, bins16, wide, dev};
  std::lock_guard<std::mutex> hold(grid_memo_lock);
  for (int i = 0; i < grid_memo_n; ++i) {
    bool same = true;
    for (int j = 0; j < 5; ++j) same = same && grid_memo[i].key[j] == key[j];
    if (same) {
      *blocks = grid_memo[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, *kern, kThreads, *smem)) != cudaSuccess)
    return e;
  *blocks = max(1, per) * sms;
  if (grid_memo_n < kMemo) {
    for (int j = 0; j < 5; ++j) grid_memo[grid_memo_n].key[j] = key[j];
    grid_memo[grid_memo_n++].blocks = *blocks;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// B5: the (F, B, 3) histogram of the rows of leaf *leaf.  acc: the F * B
// * 3 int64 sums (two words each when wide); they must be zero on entry
// unless `zero`, which zeroes them first (a memset).  hist: the output
// (f32, or f64 when wide), converted by a second launch that leaves the
// sums zero; or null for the deferred form, which leaves the sums in acc.
int lgbt_leaf_hist(const void* x, const void* lid, const void* w3,
                   const void* leaf, const void* exps, void* acc, void* hist,
                   int F, int N, int B, int bins16, int wide, int zero,
                   void* stream) {
  if (F < 1 || N < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(F) * B * 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (zero && (e = cudaMemsetAsync(acc, 0, 8 * total * (wide ? 2 : 1), s)) !=
                  cudaSuccess)
    return static_cast<int>(e);
  LeafKernel kern;
  size_t smem;
  int blocks = 0;
  if ((e = leaf_config(F, B, bins16 != 0, wide != 0, &kern, &smem,
                       &blocks)) != cudaSuccess)
    return static_cast<int>(e);
  LeafArgs a;
  a.x = x;
  a.w3 = w3;
  a.lid = static_cast<const int*>(lid);
  a.leaf = static_cast<const int*>(leaf);
  a.exps = static_cast<const int*>(exps);
  a.acc = static_cast<unsigned long long*>(acc);
  a.F = F;
  a.N = N;
  a.B = B;
  kern<<<blocks, kThreads, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (hist == nullptr) return 0;
  const int threads = 256;
  const int grid = static_cast<int>(
      min((total + threads - 1) / threads, 4096ll));
  if (wide)
    leaf_finish_kernel<true><<<grid, threads, 0, s>>>(
        a.acc, a.exps, hist, total);
  else
    leaf_finish_kernel<false><<<grid, threads, 0, s>>>(
        a.acc, a.exps, hist, total);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a block, in bytes; the wrapper's plan
// mirrors it.
long long lgbt_leaf_smem(int F, int B, int wide) {
  return static_cast<long long>(leaf_smem(F, B, wide != 0));
}

// The static shared memory of a block: the warps' row queues.
long long lgbt_leaf_static_smem() {
  return static_cast<long long>(sizeof(int) * kWarps * kQueue);
}

}  // extern "C"
