// The wave kernels for Hopper (sm_90a): the fused wave step (B1), the
// histogram-only pass on the transposed (B3) or the row-major (B4) bins,
// and the exact grower's leaf histogram (B5, the row-major pass with one
// slot).  All four build their histograms with one pass over a list of
// rows.
//
// Replaces (JAX package, TPU Pallas):
//   lightgbm_tpu/ops/pallas_wave.py::wave_partition_hist_pallas_ct
//     (kernel _wave_fused_kernel_ct)    -> B1, lgbt_wave_fused
//   lightgbm_tpu/ops/pallas_wave.py::wave_histogram_pallas_t
//     (kernel _wave_hist_kernel_t)      -> B3, lgbt_wave_hist rowmajor=0
//   lightgbm_tpu/ops/pallas_wave.py::wave_histogram_pallas
//     (kernel _wave_hist_kernel)        -> B4, lgbt_wave_hist rowmajor=1
//   lightgbm_tpu/ops/pallas_hist.py::leaf_histogram_pallas
//     (kernel _hist_kernel)             -> B5, lgbt_wave_hist rowmajor=1,
//                                          K = 1, child_id = the leaf
//
// Contract.  X_t (F, N) uint8 bins (B1, B3) or X (N, F) (B4, B5), leaf_id
// (N,) int32, w3 (N, 3) f32 [g*m, h*m, m], child_id (K,) int32 (-1 =
// inactive; for B5 the one-element leaf tensor, which stays on the
// device).
// B1 also takes the compact split table cols (W, 10) f32 and the wave's
// parent ids psrc (W,) int32 (-3 = inactive): a row whose leaf is psrc[w]
// (the first such w) is routed with the split in cols[w]: <= threshold
// numerical, == categorical, default-bin redirect, EFB offset remap when
// BUNDLED; its new leaf id is written to new_lid.  hist[k, f, b, :] sums
// w3 over the rows whose (new, for B1) leaf id equals child_id[k] and
// whose bin in feature f is b; bins >= B are dropped; a child id that
// repeats fills every slot that holds it.  Rows are held in an int and
// bins addressed with size_t offsets, so N < 2^31 is the only limit on
// the shape (F x N may exceed it).
// Packed bins (tpu_bin_pack, ops/pack.py): with `packed`, the matrix holds
// Fd = ceil(F / 2) stored columns of two 4-bit bins each, split-half:
// stored column p holds feature p in its low nibble and feature p + Fd in
// its high one (with odd F the last high nibble is padding, never a
// feature).  B1's route reads the split column's nibble; a histogram
// block reads each stored byte of a listed row once and adds both of its
// features, so the bin bytes read a row halve.  The histograms are those
// of the unpacked bins, bit for bit.
// Single bf16 product (tpu_hist_precision=bf16): with `bf16`, each weight
// is rounded to bf16 as the JAX package's _round_bf16 does
// (fixed_point.cuh round_bf16) before it is quantized; the exponents stay
// those of the unrounded weights, which still bound every sum: rounding
// raises a magnitude by at most 2^-8 of it, so |sum| < 2^62 (1 + 2^-8)
// < 2^63.
// Two-byte bins (max_bin > 255, io/bundle.py: a feature of more than 256
// bins makes the whole matrix uint16): with `bins16`, X holds uint16 bins,
// read as two bytes (the route and the histogram blocks alike; the
// row-major pass reads a group of FS features as 2 FS bytes, in 4-byte
// words where the row and the group are 4-byte aligned).  The packed form
// stays uint8-only (bins < 16).
// Bin tiles: a block holds the bins [b0, b0 + BT) of its features, and a
// row whose bin lies outside adds nothing in that block, so a (slot,
// feature) row of BT bins fits shared memory at any B up to 65,536.  The
// grid's x axis holds (bin tile, feature group) pairs: groups = feature
// groups x tiles, BT = ceil(B / tiles) (ops/wave_kernels.py hist_plan).
// The f64 form (tpu_use_dp, `wide`): w3 is (N, 3) float64, each value is
// quantized to 128-bit fixed point (fixed_point.cuh quantize128, the
// exponents 126 - frexp_exponent(N * max|w_c|)), a shared cell is four
// 32-bit words and a global one two 64-bit words, and the histogram comes
// back as float64.
//
// What bounds them on this card.  The bytes that must move: leaf ids in
// (and out for B1, 8 B a row), and for each row in a child slot its
// weights (12 B) and its F bin bytes; at the flagship shape (N = 2M,
// F = 28, B = 63, K = W = 32, about half the rows in a slot) that is
// ~18 us at 3.35 TB/s, and the root histogram (K = 1, every row) ~26 us.
// The adds (3 a row and feature) are ~2-3 us at the FP32 rate.  So the
// bound is memory, and the design has to keep the accumulation from
// costing more than the loads.  B5's call (one leaf of the exact grower,
// up to 255 a tree, most of them small) is bound by reading all N leaf
// ids (2.4 us at N = 2M); there the fixed costs of a call (four launches:
// the accumulator's memset, the list, the histogram, the conversion) and
// of each histogram block (zeroing and folding its shared histogram) are
// what the design has to keep small.  The earlier design of B3, B4 and
// B5 (one private f32 histogram a warp, lane-ordered adds after
// __match_any_sync, partials summed in row-block order by a second
// kernel) was deterministic but capped a block of 8 warps to one an SM,
// spent a serial match-and-add step on every 32 rows of every feature,
// including rows in no child slot, and wrote an (R, K, F, B, 3) scratch.
//
// Design.
//  1. list_kernel, one thread a row, maps each row's leaf to its child
//     slot through leaf -> slot tables in shared memory built from
//     child_id (a K-long search only for ids outside the table) and
//     appends each row that falls in a child slot to a compact list of
//     (row, slot) pairs: a block-wide prefix over its 1024 rows and one
//     global atomic a tile.  Under ROUTE (B1) it first routes the row with
//     its parent's split (a second table, from psrc) and writes new_lid;
//     otherwise (B3, B4, B5) it selects the rows as their ids stand.
//  2. hist_kernel walks only the list.  A block of 32 warps owns a group
//     of FS features (and a slice of KS slots when one feature's K slots
//     do not fit) and a share of the list; its histogram lives in shared
//     memory as 64-bit fixed point (fixed_point.cuh), each (row, feature)
//     adding its three channels as two native 32-bit shared atomics
//     each.  Integer addition is exact and order-free, so the sums do not
//     depend on scheduling and two launches are bit-identical.  The block
//     then adds its cells into one int64 (K, F, B, 3) buffer with global
//     atomics (again order-free).  The grid holds R shares of the list,
//     planned from N; a short list (a small leaf, a late wave) takes only
//     as many shares as give each at least kMinShareRows rows, read from
//     the list's length on the device, and the other blocks return once
//     they have zeroed their shared memory.  The row-major variant reads
//     a row's group as its contiguous bytes X[row, f0 .. f0 + FS), one or
//     two 4-byte words where the row and the group are 4-byte aligned.
//     Copies: where the histogram leaves shared memory unused (few slots,
//     as in the root's K = 1), the block keeps C = 2, 4, .. 32 copies,
//     interleaved so that cell c of copy j is word c * C + j, and lane l
//     adds into copy l mod C.  A warp's lanes then hit C different banks
//     for any bins, where one copy replays the atomic for every bank
//     that two lanes share (32 rows over one feature's 63 bins share
//     banks several times over).  The copies are added together before
//     the global atomics; integer sums, so the bits do not depend on C.
//     The plan (ops/wave_kernels.py hist_plan) is made from N: B5 takes
//     B4's at K = 1 for every leaf, the root's copies included.
//  2'. Wide rows (the slot-ordered pass).  Where one (slot, feature) row
//     of B bins is so long that the plan above would hold fewer than 4
//     features of all K slots a block (uint16 bins at B = 1023: one
//     feature and 9 of 32 slots), every block of it walks the whole list:
//     a listed row is fetched 112 times at F = 28, K = 32.  There (1 < K
//     <= 1024) the list passes order the list by slot on the device --
//     kCount counts each slot's rows (a block-level count, then K global
//     atomics a block), kScatter writes each row into its slot's segment
//     (the offsets are the counts' prefix, each block computing them; one
//     global atomic a (tile, slot)) -- and hist_ordered_kernel lets a
//     block hold ONE slot of up to kMaxGroup features and one piece of
//     that slot's rows, so a listed row is read once a (feature group,
//     bin tile).  On X_t (B1, B3) the scatter pass also copies each
//     listed row's weights and bins into compact rows in list order,
//     reading X_t's bins of neighbouring rows together, so the
//     histogram pass reads its rows contiguously instead of gathering a
//     sector of X_t for each listed (row, feature); on row-major X (B4) a
//     row's group is one or two sectors already, and the pass reads it
//     through the list.  On an H100 at N = 2M, F = 28, K = 32, 1023 bins
//     of the flagship rows, B3's scatter pass with its copy takes ~220 us
//     and its histogram pass ~210 us, where the slot-sliced plan's
//     histogram pass took ~1.17 ms (wide_hist_ab.py --profile; PERF.md,
//     PR 20).
//  3. finish_kernel converts the int64 sums to f32 once and copies the
//     histogram of a repeated child id into each of its slots.
// Fixed point: channel c is scaled by 2^e[c] with e[c] = 62 -
// frexp_exponent(N * max|w_c|), so no sum of N values can overflow; each
// value is rounded to the nearest multiple of 2^-e[c], which errs by at
// most N_cell * N * max|w_c| / 2^62 in a cell (1e-6 x max|w| at N = 2M),
// well inside the f32 tolerance.  The wrapper computes e once a tree on
// the device (ops/wave_kernels.py fixed_point_exponents), so B1, B3, B4,
// B5 and B6 (csrc/sparse_hist.cu) give bit-identical histograms of the
// same rows.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

using lgbt::add64;
using lgbt::find_first;
using lgbt::kTable;

constexpr int kListThreads = 256;
constexpr int kListRows = 4;         // rows a thread per tile
constexpr int kTileRows = kListThreads * kListRows;
constexpr int kHistThreads = 1024;   // 32 warps: one block fills an SM
constexpr int kMaxGroup = 8;         // features a histogram block holds
constexpr int kMaxCopies = 32;
constexpr int kMinShareRows = 2048;  // the fewest listed rows a share takes
constexpr int kMaxOrderedSlots = 1024;   // the most slots a slot-ordered
                                         // list takes
// a block's piece of one slot's rows goes through shared memory when it
// holds at least BT / kSharedRowsDiv rows (it then touches about 3 FS BT /
// kSharedRowsDiv cells or more, so the flush's scan of all 3 FS BT cells
// costs little beside its adds); a shorter one adds straight into the
// int64 sums with global atomics
constexpr int kSharedRowsDiv = 4;

// The bin forms: byte bins, 4-bit packed byte bins, two-byte bins.
enum Form { kByte = 0, kPacked = 1, kWide16 = 2 };

// The list passes: kAppend writes the (row, slot) pairs in tile order
// (one global atomic a tile); kCount only counts each slot's rows (B1
// still routes and writes new_lid there); kScatter writes each pair into
// its slot's segment of the list, so that the list is ordered by slot.
enum ListPass { kAppend = 0, kCount = 1, kScatter = 2 };

// off[0..K]: the exclusive prefix of the K slot counts cnt (off[K] the
// list's length), in shared memory; K <= kMaxOrderedSlots.  Every thread
// of the block calls it; it ends with a barrier.
__device__ __forceinline__ void slot_offsets(
    const unsigned long long* __restrict__ cnt, int K, int* off) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (K + 31) / 32;
    const int a = min(K, lane * per);
    const int b = min(K, a + per);
    int s = 0;
    for (int i = a; i < b; ++i) s += static_cast<int>(cnt[i]);
    int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - s;
    for (int i = a; i < b; ++i) {
      off[i] = run;
      run += static_cast<int>(cnt[i]);
    }
    if (lane == 31) off[K] = incl;
  }
  __syncthreads();
}

// The compact rows of the slot-ordered pass on X_t: the scatter pass
// copies each listed row's weights and its Fd stored bins (from X_t (Fd,
// N)) into row pos of xc, pos its place in the slot-ordered list: W bytes
// of weights (w3's three values and a zero: four f32, or four f64 when
// wide), then the bins, the row padded to whole 32-byte sectors (S
// bytes), so that one thread writes each sector of it whole.  The scatter pass walks the rows in row order, so a warp reads
// X_t's bins of 32 neighbouring rows at once; the histogram pass then
// reads its rows in list order, contiguous, where it would gather one
// sector of X_t for each listed (row, feature).  xc null: no copy.
struct Compact {
  const void* x;
  const void* w3;
  uint4* xc;
  int S, W, Fd, bins16, wide;
};

// The bytes of a compact row: the weights (16, or 32 when wide) and Fd
// bins of `bytes` bytes, rounded up to 32.
inline int compact_stride(int Fd, int bytes, bool wide) {
  return ((wide ? 32 : 16) + Fd * bytes + 31) / 32 * 32;
}

// Row `row`'s weights and bins into compact row pos; T: the bin type.
// Where the row's bins fit kCompactFast bytes (32 features of uint16
// bins, 64 of bytes), all of them are loaded at once and the row is
// stored back to back, so the halves of each sector reach L2 together;
// a wider row goes 16 bytes at a time, a chunk's loads together.
constexpr int kCompactFast = 64;

template <typename T>
__device__ __forceinline__ void compact_row(const Compact& c, int row,
                                            int pos, int N) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));   // bins a chunk
  constexpr int BW = 4 / static_cast<int>(sizeof(T));     // bins a word
  uint4* out = c.xc + static_cast<size_t>(pos) * (c.S / 16);
  if (c.wide) {
    const double* w = static_cast<const double*>(c.w3) +
                      3 * static_cast<size_t>(row);
    reinterpret_cast<double2*>(out)[0] = make_double2(w[0], w[1]);
    reinterpret_cast<double2*>(out)[1] = make_double2(w[2], 0.0);
  } else {
    const float* w = static_cast<const float*>(c.w3) +
                     3 * static_cast<size_t>(row);
    reinterpret_cast<float4*>(out)[0] = make_float4(w[0], w[1], w[2], 0.f);
  }
  out += c.W / 16;
  const T* x = static_cast<const T*>(c.x) + row;
  const size_t step = static_cast<size_t>(N);
  const int chunks = (c.S - c.W) / 16;
  if (c.Fd * static_cast<int>(sizeof(T)) <= kCompactFast) {
    constexpr int MAXB = kCompactFast / static_cast<int>(sizeof(T));
    constexpr int WORDS = kCompactFast / 4 + 4;   // the row's padding too
    unsigned v[MAXB];
#pragma unroll
    for (int f = 0; f < MAXB; ++f)
      v[f] = f < c.Fd ? static_cast<unsigned>(x[f * step]) : 0u;
    unsigned w[WORDS];
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      w[q] = 0u;
#pragma unroll
      for (int r = 0; r < BW; ++r)
        if (q * BW + r < MAXB)
          w[q] |= v[q * BW + r] << (8 * static_cast<int>(sizeof(T)) * r);
    }
#pragma unroll
    for (int ch = 0; ch < WORDS / 4; ++ch)
      if (ch < chunks)
        out[ch] = make_uint4(w[4 * ch], w[4 * ch + 1], w[4 * ch + 2],
                             w[4 * ch + 3]);
    return;
  }
  for (int ch = 0; ch < chunks; ++ch) {
    unsigned v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = ch * PER + i;
      v[i] = f < c.Fd ? static_cast<unsigned>(x[f * step]) : 0u;
    }
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0u;
#pragma unroll
      for (int r = 0; r < BW; ++r)
        w[q] |= v[q * BW + r] << (8 * static_cast<int>(sizeof(T)) * r);
    }
    out[ch] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// PACKED: xt holds Fd = ceil(F / 2) packed columns; the route reads the
// split column's nibble.  T: the bin type (uint8_t, or uint16_t).  PASS:
// ListPass; kCount and kScatter take slots (the 2K words cnt, then the
// cursors cur, zeroed), and kScatter takes no route (lid: the ids to list,
// B1's new ones) and copies each listed row into its compact rows (cp).
template <bool ROUTE, bool BUNDLED, bool PACKED, typename T, int PASS>
__global__ void __launch_bounds__(kListThreads)
list_kernel(const T* __restrict__ xt, const int* __restrict__ lid,
            const int* __restrict__ cid, const float* __restrict__ cols,
            const int* __restrict__ psrc, int* __restrict__ new_lid,
            int2* __restrict__ list, unsigned long long* __restrict__ count,
            unsigned long long* __restrict__ slots, int F, int Fd, int N,
            int K, int W, Compact cp) {
  static_assert(PASS != kScatter || !ROUTE, "the scatter pass takes no route");
  __shared__ short wave_of[kTable];      // leaf -> first w, or -1
  __shared__ short slot_of[kTable];      // leaf -> first k, or -1
  __shared__ int warp_n[kListRows][kListThreads / 32];
  __shared__ int tmax_s;
  __shared__ unsigned long long base_s;
  extern __shared__ int dyn[];
  int* psrc_s = dyn;                     // W
  int* cid_s = psrc_s + W;               // K
  float* cols_s = reinterpret_cast<float*>(cid_s + K);   // W * 10
  // kCount, kScatter: a tile's rows in each slot, the tile's first
  // position in each slot's segment, and the segments' offsets
  int* tcount = reinterpret_cast<int*>(cols_s + W * 10);   // K
  int* gbase = tcount + K;                                 // K
  int* off_s = gbase + K;                                  // K + 1
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < W; i += blockDim.x) psrc_s[i] = psrc[i];
  for (int i = tid; i < K; i += blockDim.x) cid_s[i] = cid[i];
  for (int i = tid; i < W * 10; i += blockDim.x) cols_s[i] = cols[i];
  if constexpr (PASS != kAppend)
    for (int i = tid; i < K; i += blockDim.x) tcount[i] = 0;
  __syncthreads();
  if (tid == 0) {                        // table length: largest id + 1
    int m = -1;
    for (int i = 0; i < W; ++i) m = max(m, psrc_s[i]);
    for (int i = 0; i < K; ++i) m = max(m, cid_s[i]);
    tmax_s = min(kTable, m + 1);
  }
  __syncthreads();
  const int tmax = tmax_s;
  for (int i = tid; i < tmax; i += blockDim.x) {
    wave_of[i] = -1;
    slot_of[i] = -1;
  }
  __syncthreads();
  if (tid == 0) {                        // descending: the first one wins
    for (int i = W - 1; i >= 0; --i)
      if (psrc_s[i] >= 0 && psrc_s[i] < tmax) wave_of[psrc_s[i]] = i;
    for (int i = K - 1; i >= 0; --i)
      if (cid_s[i] >= 0 && cid_s[i] < tmax) slot_of[cid_s[i]] = i;
  }
  __syncthreads();
  if constexpr (PASS == kScatter) {
    slot_offsets(slots, K, off_s);
    if (blockIdx.x == 0 && tid == 0)
      *count = static_cast<unsigned long long>(off_s[K]);
  }

  const unsigned lt_mask = (1u << lane) - 1u;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kTileRows;
       t0 < N; t0 += static_cast<long long>(gridDim.x) * kTileRows) {
    int row[kListRows], slot[kListRows], before[kListRows];
#pragma unroll
    for (int j = 0; j < kListRows; ++j) {
      const long long r = t0 + j * kListThreads + tid;
      row[j] = static_cast<int>(r);
      slot[j] = -1;
      if (r < N) {
        int nl = lid[r];
        if constexpr (ROUTE) {
          const int w = (nl >= 0 && nl < kTable)
              ? (nl < tmax ? wave_of[nl] : -1)
              : find_first(psrc_s, W, nl);
          if (w >= 0) {
            const float* c = cols_s + w * 10;
            if (c[0] > 0.5f) {
              const int cj = static_cast<int>(c[1]);
              int colv = 0;
              if (cj >= 0 && cj < F) {
                if constexpr (PACKED) {
                  const bool high = cj >= Fd;
                  const int v = static_cast<int>(
                      xt[static_cast<size_t>(high ? cj - Fd : cj) * N + r]);
                  colv = high ? v >> 4 : v & 15;
                } else {
                  colv = static_cast<int>(
                      xt[static_cast<size_t>(cj) * N + r]);
                }
              }
              const int dflt = static_cast<int>(c[4]);
              if (BUNDLED) {
                const int goff = static_cast<int>(c[7]);
                const int span = static_cast<int>(c[9]);
                colv = (colv >= goff && colv < goff + span)
                    ? colv - goff + static_cast<int>(c[8]) : dflt;
              }
              const int thr = static_cast<int>(c[2]);
              bool go_left = (c[3] > 0.5f) ? (colv == thr) : (colv <= thr);
              if (colv == dflt) go_left = c[5] > 0.5f;
              if (!go_left) nl = static_cast<int>(c[6]);
            }
          }
          new_lid[r] = nl;
        }
        slot[j] = lgbt::lookup_slot(slot_of, tmax, cid_s, K, nl);
      }
      if constexpr (PASS == kAppend) {
        const unsigned m = __ballot_sync(0xffffffffu, slot[j] >= 0);
        before[j] = __popc(m & lt_mask);
        if (lane == 0) warp_n[j][warp] = __popc(m);
      } else {
        // the warp's rows of one slot: their leader claims them in the
        // tile's count; before[j] becomes the row's place among the
        // tile's rows of its slot
        const unsigned peers = __match_any_sync(0xffffffffu, slot[j]);
        const int leader = __ffs(peers) - 1;
        int o = 0;
        if (slot[j] >= 0 && lane == leader)
          o = atomicAdd(&tcount[slot[j]], __popc(peers));
        before[j] = __shfl_sync(0xffffffffu, o, leader) +
                    __popc(peers & lt_mask);
      }
    }
    if constexpr (PASS == kAppend) {
      __syncthreads();
      if (tid == 0) {                    // exclusive prefix in row order
        int total = 0;
        for (int j = 0; j < kListRows; ++j)
          for (int v = 0; v < kListThreads / 32; ++v) {
            const int c = warp_n[j][v];
            warp_n[j][v] = total;
            total += c;
          }
        base_s = total ? atomicAdd(count, static_cast<unsigned long long>(
                                              total))
                       : 0ull;
      }
      __syncthreads();
      const unsigned long long base = base_s;
#pragma unroll
      for (int j = 0; j < kListRows; ++j)
        if (slot[j] >= 0)
          list[base + warp_n[j][warp] + before[j]] =
              make_int2(row[j], slot[j]);
      __syncthreads();                   // warp_n and base_s reused
    } else if constexpr (PASS == kScatter) {
      __syncthreads();
      // the tile's place in each slot's segment; the count is cleared for
      // the next tile (its adds come after the next barrier)
      for (int i = tid; i < K; i += blockDim.x) {
        const int c = tcount[i];
        if (c) {
          gbase[i] = off_s[i] + static_cast<int>(atomicAdd(
              slots + K + i, static_cast<unsigned long long>(c)));
          tcount[i] = 0;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kListRows; ++j)
        if (slot[j] >= 0) {
          const int pos = gbase[slot[j]] + before[j];
          list[pos] = make_int2(row[j], slot[j]);
          if (cp.xc) compact_row<T>(cp, row[j], pos, N);
        }
    }
  }
  if constexpr (PASS == kCount) {
    __syncthreads();
    for (int i = tid; i < K; i += blockDim.x)
      if (tcount[i])
        atomicAdd(slots + i, static_cast<unsigned long long>(tcount[i]));
  }
}

// The pieces a histogram block runs on each listed row, shared by both
// histogram passes.  A block owns the stored columns [c0, c0 + nc) (the
// group; packed: nhi of them also hold a high-nibble feature) and the
// bins [b0, b0 + BT) of their features.
template <int FORM>
using BinT = typename std::conditional<FORM == kWide16, uint16_t,
                                       uint8_t>::type;
template <bool WIDE>
using Quant = typename std::conditional<WIDE, lgbt::Q128,
                                        unsigned long long>::type;

// Each of the group's features' bin of `row` within the block's tile
// (BT: none), each stored bin read once.  xg: the group's first column
// (X_t) or X + c0 (row-major, Fd stored columns a row); words4: the
// row-major group read as 4-byte words.
template <bool ROWMAJOR, int FORM>
__device__ __forceinline__ void group_bins(const BinT<FORM>* __restrict__ xg,
                                           int row, int Fd, int N, int nc,
                                           int nhi, int b0, int BT,
                                           bool words4,
                                           int (&bins)[kMaxGroup]) {
  using T = BinT<FORM>;
  constexpr int PER = 4 / static_cast<int>(sizeof(T));   // bins a word
  int bytes[kMaxGroup];
  if constexpr (ROWMAJOR) {
    const T* xr = xg + static_cast<size_t>(row) * Fd;
    if (words4) {
      const unsigned* xw = reinterpret_cast<const unsigned*>(xr);
      unsigned wd[kMaxGroup / PER];
#pragma unroll
      for (int i = 0; i < kMaxGroup / PER; ++i)
        wd[i] = i * PER < nc ? xw[i] : 0u;
#pragma unroll
      for (int f = 0; f < kMaxGroup; ++f)
        bytes[f] = f < nc
            ? static_cast<int>((wd[f / PER] >> (8 * sizeof(T) * (f % PER)))
                               & ((1u << (8 * sizeof(T))) - 1u))
            : 0;
    } else {
#pragma unroll
      for (int f = 0; f < kMaxGroup; ++f)
        bytes[f] = f < nc ? static_cast<int>(xr[f]) : 0;
    }
  } else {
#pragma unroll
    for (int f = 0; f < kMaxGroup; ++f)
      bytes[f] = f < nc
          ? static_cast<int>(xg[static_cast<size_t>(f) * N + row]) : 0;
  }
  if constexpr (FORM == kPacked) {
#pragma unroll
    for (int i = 0; i < kMaxGroup / 2; ++i) {
      bins[2 * i] = i < nc ? (bytes[i] & 15) - b0 : BT;
      bins[2 * i + 1] = i < nhi ? (bytes[i] >> 4) - b0 : BT;
    }
  } else {
#pragma unroll
    for (int f = 0; f < kMaxGroup; ++f) bins[f] = f < nc ? bytes[f] - b0 : BT;
  }
}

// The three channels of `row` in the fixed point: 64-bit values of the
// f32 weights (rounded to bf16 first when bf16, block-uniform), 128-bit
// ones of the float64 weights (WIDE).  COMPACT: wv is a compact row,
// its weights one 16-byte load (two when WIDE) at its start.
template <bool WIDE, bool COMPACT = false>
__device__ __forceinline__ void row_quant(const void* __restrict__ wv,
                                          int row, int bf16, const int* e,
                                          const double* sc,
                                          Quant<WIDE> (&q)[3]) {
  if constexpr (WIDE && COMPACT) {
    const double2 a = static_cast<const double2*>(wv)[0];
    const double2 b = static_cast<const double2*>(wv)[1];
    q[0] = lgbt::quantize128(a.x, e[0]);
    q[1] = lgbt::quantize128(a.y, e[1]);
    q[2] = lgbt::quantize128(b.x, e[2]);
  } else if constexpr (WIDE) {
    const double* wr = static_cast<const double*>(wv) +
                       3 * static_cast<size_t>(row);
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = lgbt::quantize128(wr[c], e[c]);
  } else {
    float w[3];
    if constexpr (COMPACT) {
      const float4 v = static_cast<const float4*>(wv)[0];
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
    } else {
      const float* wr = static_cast<const float*>(wv) +
                        3 * static_cast<size_t>(row);
      w[0] = wr[0];
      w[1] = wr[1];
      w[2] = wr[2];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (bf16) w[c] = lgbt::round_bf16(w[c]);
      q[c] = lgbt::quantize(w[c], sc[c]);
    }
  }
}

// q added to the shared cell whose words are p0[c], p1[c] (and p2[c],
// p3[c] when WIDE).
template <bool WIDE>
__device__ __forceinline__ void add_shared(unsigned* p0, unsigned* p1,
                                           unsigned* p2, unsigned* p3, int c,
                                           const Quant<WIDE>& q) {
  if constexpr (WIDE)
    lgbt::add128(p0 + c, p1 + c, p2 + c, p3 + c, q);
  else
    add64(p0 + c, p1 + c, q);
}

// The sum (lo, hi) added to the int64 sums' cell o (two words when WIDE,
// the low word's carry into the high one), with global atomics.
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

// The feature of a block's histogram feature ff (its stored column c0 +
// ff, or packed that column's nibble ff & 1), or -1 for none.
template <bool PACKED>
__device__ __forceinline__ int cell_feature(int ff, int c0, int nc, int nhi,
                                            int Fd) {
  if constexpr (PACKED) {
    const int ci = ff >> 1;
    if ((ff & 1) ? ci >= nhi : ci >= nc) return -1;
    return (ff & 1) ? Fd + c0 + ci : c0 + ci;
  } else {
    return ff < nc ? c0 + ff : -1;
  }
}

// The block's group and bin tile: the grid's x axis holds (bin tile,
// feature group) pairs, BT = ceil(B / tiles).
struct Group {
  int c0, nc, nhi, b0, BT, bn;
};

template <bool PACKED>
__device__ __forceinline__ Group block_group(int F, int Fd, int B, int FS) {
  const int PS = PACKED ? FS / 2 : FS;   // stored columns a block reads
  const int fgroups = (Fd + PS - 1) / PS;
  const int tiles = gridDim.x / fgroups;
  Group g;
  g.BT = (B + tiles - 1) / tiles;
  g.b0 = (blockIdx.x / fgroups) * g.BT;
  g.bn = min(g.BT, B - g.b0);            // bins this block holds
  g.c0 = (blockIdx.x % fgroups) * PS;
  g.nc = min(PS, Fd - g.c0);
  // packed: stored column c0 + i holds feature Fd + c0 + i in its high
  // nibble while that is below F
  g.nhi = PACKED ? max(0, min(g.nc, F - Fd - g.c0)) : 0;
  return g;
}

// COPIES = false is the one-copy form (B1's wave, K = 32): its strides
// are compile-time constants that fold into the atomics' addresses.
// FORM kPacked: x holds Fd = ceil(F / 2) packed columns and a block owns
// FS / 2 of them; its histogram feature 2i is the low nibble of its stored
// column i, 2i + 1 the high one.  kWide16: x holds uint16 bins.  WIDE: w3
// is float64 and the cells are 128-bit.  bf16: round each weight to bf16
// first (f32 weights only).  The block owns the bins [b0, b0 + BT) of its
// features, BT = ceil(B / tiles), tiles = gridDim.x / feature groups.
template <bool ROWMAJOR, bool COPIES, int FORM, bool WIDE>
__global__ void __launch_bounds__(kHistThreads, 1)
hist_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
            const int2* __restrict__ list,
            const unsigned long long* __restrict__ count,
            const int* __restrict__ exps, unsigned long long* __restrict__ acc,
            int F, int Fd, int N, int B, int K, int KS, int FS, int copies,
            int bf16) {
  using T = BinT<FORM>;
  constexpr bool PACKED = FORM == kPacked;
  // C interleaved copies of (KS, FS, BT, 3) cells, as NW planes of 32-bit
  // words: cell c of copy j is word c * C + j of each plane
  extern __shared__ unsigned planes[];
  const T* __restrict__ x = static_cast<const T*>(xv);
  const int C = COPIES ? copies : 1;
  const Group g = block_group<PACKED>(F, Fd, B, FS);
  const int BT = g.BT, bn = g.bn;
  const int k0 = blockIdx.z * KS;
  const int kn = min(KS, K - k0);
  const int slot_len = FS * BT * 3;
  const int cells = kn * slot_len;
  const int words = KS * slot_len * C;
  unsigned* p0 = planes;
  unsigned* p1 = planes + words;
  unsigned* p2 = planes + 2 * words;     // WIDE only
  unsigned* p3 = planes + 3 * words;
  for (int i = threadIdx.x; i < cells * C; i += blockDim.x) {
    p0[i] = 0u;
    p1[i] = 0u;
    if constexpr (WIDE) {
      p2[i] = 0u;
      p3[i] = 0u;
    }
  }
  const int e[3] = {exps[0], exps[1], exps[2]};
  const double sc[3] = {ldexp(1.0, e[0]), ldexp(1.0, e[1]),
                        ldexp(1.0, e[2])};
  // a short list takes fewer shares: at least kMinShareRows rows each.
  // The other blocks return once zeroed (the grid is one round of
  // resident blocks, so their zeroing costs no time).  The length is read
  // here, after the zeroing: read before it, B3's root ran 5-8% slower
  // on an H100 (before the zeroing and branched on there) and B1's wave
  // 5-9% (branched on after it).
  const long long n = static_cast<long long>(*count);
  const long long shares = max(1ll, min(static_cast<long long>(gridDim.y),
                                        n / kMinShareRows));
  if (blockIdx.y >= shares || bn <= 0) return;   // block-uniform
  const long long per = (n + shares - 1) / shares;
  const long long j0 = blockIdx.y * per;
  const long long j1 = min(n, j0 + per);
  const int copy = threadIdx.x & (C - 1);
  // row-major: the group's bins of a row (Fd stored columns a row) as
  // 4-byte words when aligned
  const bool words4 =
      ROWMAJOR && (Fd * static_cast<int>(sizeof(T))) % 4 == 0 &&
      (g.c0 * static_cast<int>(sizeof(T))) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  const T* xg = ROWMAJOR ? x + g.c0 : x + static_cast<size_t>(g.c0) * N;
  __syncthreads();

  for (long long j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int2 rec = list[j];
    const int s = rec.y - k0;
    if (s < 0 || s >= kn) continue;
    int bins[kMaxGroup];
    group_bins<ROWMAJOR, FORM>(xg, rec.x, Fd, N, g.nc, g.nhi, g.b0, BT,
                               words4, bins);
    Quant<WIDE> q[3];
    row_quant<WIDE>(wv, rec.x, bf16, e, sc, q);
    const int base = s * slot_len;
#pragma unroll
    for (int f = 0; f < kMaxGroup; ++f) {
      if (bins[f] >= 0 && bins[f] < bn) {
        const int c = (base + (f * BT + bins[f]) * 3) * C + copy;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          add_shared<WIDE>(p0, p1, p2, p3, c + ch * C, q[ch]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    unsigned long long lo = 0ull, hi = 0ull;
    for (int j = 0; j < C; ++j) {        // rotated: lanes on other banks
      const int w = i * C + ((i + j) & (C - 1));
      const unsigned long long a =
          (static_cast<unsigned long long>(p1[w]) << 32) | p0[w];
      lo += a;
      if constexpr (WIDE)
        hi += ((static_cast<unsigned long long>(p3[w]) << 32) | p2[w]) +
              (lo < a ? 1ull : 0ull);
    }
    if (lo == 0ull && hi == 0ull) continue;
    const int kk = i / slot_len;
    const int rem = i - kk * slot_len;       // (f, b, c) within the group
    const int ff = rem / (BT * 3);
    const int bc = rem - ff * BT * 3;        // (b - b0, c)
    if (bc >= bn * 3) continue;
    const int gf = cell_feature<PACKED>(ff, g.c0, g.nc, g.nhi, Fd);
    if (gf < 0) continue;
    add_global<WIDE>(acc, (static_cast<size_t>(k0 + kk) * F + gf) * B * 3 +
                              g.b0 * 3 + bc, lo, hi);
  }
}

// The slot-ordered pass (the plan's wide rows: a (slot, feature) row of
// B bins so long that the slot-sliced plan would hold fewer than 4
// features of all K slots a block).  The list passes order the list by
// slot (list_kernel kCount, then kScatter); slot k's rows are [off[k],
// off[k + 1]).  COMPACT (the transposed X_t of B1 and B3): the scatter
// pass copied each listed row's weights and bins into the compact rows
// xc in that order (Compact); otherwise (B4's row-major X, whose row
// group is one or two sectors) a block reads the list's rows from X and
// w3 as hist_kernel does.  A block owns a group of FS features (and a bin
// tile) and ONE piece of one slot's rows, and keeps that slot's (FS, BT,
// 3) cells in shared memory: it adds the piece's rows there and then
// flushes the cells into the int64 sums with global atomics; a piece of
// fewer than BT / kSharedRowsDiv rows adds straight into the sums.  So a
// listed row is read once a (feature group, bin tile), on X_t from
// compact rows that a warp reads contiguously, where the slot-sliced plan
// read the whole list once a (feature group, slot slice, bin tile) and
// gathered a sector of X_t for each listed (row, feature).  Pieces: with the R shares of the plan, per = n /
// shares rows, slot k's rows split into max(1, round(seg_k / per))
// equal pieces, numbered slot by slot (at most R + K in all: the grid's
// y axis), so the blocks hold about per rows each however skewed the
// slots are.  Every sum is an integer sum, order-free, so the
// histograms are bit for bit those of hist_kernel.  slots: the K slot
// counts (the offsets are their prefix, computed here); S: the bytes of
// a compact row.
template <int FORM, bool WIDE, bool COMPACT>
__global__ void __launch_bounds__(kHistThreads, 1)
hist_ordered_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                    const int2* __restrict__ list,
                    const uint4* __restrict__ xc,
                    const unsigned long long* __restrict__ slots,
                    const int* __restrict__ exps,
                    unsigned long long* __restrict__ acc, int F, int Fd,
                    int S, int B, int K, int FS, int bf16) {
  using T = BinT<FORM>;
  constexpr bool PACKED = FORM == kPacked;
  extern __shared__ unsigned planes[];   // (FS, BT, 3) cells, NW planes
  __shared__ int off[kMaxOrderedSlots + 1];
  __shared__ int task[3];                // the block's slot, piece, pieces
  if (threadIdx.x == 0) task[0] = -1;
  slot_offsets(slots, K, off);           // ends with a barrier
  const int n = off[K];
  const int R = gridDim.y - K;           // the plan's shares
  const int shares = max(1, min(R, n / kMinShareRows));
  const int per = (n + shares - 1) / shares;
  if (threadIdx.x < 32 && per > 0) {     // find the block's piece
    const int lane = threadIdx.x;
    const int span = (K + 31) / 32;
    const int s0 = min(K, lane * span);
    const int s1 = min(K, s0 + span);
    auto pieces = [&](int k) {
      const int seg = off[k + 1] - off[k];
      return seg == 0 ? 0 : max(1, (seg + per / 2) / per);
    };
    int mine = 0;
    for (int k = s0; k < s1; ++k) mine += pieces(k);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int y = blockIdx.y;
    if (y >= incl - mine && y < incl) {
      int c = incl - mine;
      for (int k = s0; k < s1; ++k) {
        const int p = pieces(k);
        if (y < c + p) {
          task[0] = k;
          task[1] = y - c;
          task[2] = p;
          break;
        }
        c += p;
      }
    }
  }
  __syncthreads();
  const Group g = block_group<PACKED>(F, Fd, B, FS);
  const int k = task[0];
  if (k < 0 || g.bn <= 0) return;        // block-uniform
  const int BT = g.BT, bn = g.bn;
  const int seg = off[k + 1] - off[k];
  const int a = off[k] + static_cast<int>(
      static_cast<long long>(task[1]) * seg / task[2]);
  const int b = off[k] + static_cast<int>(
      static_cast<long long>(task[1] + 1) * seg / task[2]);
  const bool smem = (b - a) * kSharedRowsDiv >= BT;
  const int cells = FS * BT * 3;
  unsigned* p0 = planes;
  unsigned* p1 = planes + cells;
  unsigned* p2 = planes + 2 * cells;     // WIDE only
  unsigned* p3 = planes + 3 * cells;
  if (smem) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      p0[i] = 0u;
      p1[i] = 0u;
      if constexpr (WIDE) {
        p2[i] = 0u;
        p3[i] = 0u;
      }
    }
    __syncthreads();
  }
  const int e[3] = {exps[0], exps[1], exps[2]};
  const double sc[3] = {ldexp(1.0, e[0]), ldexp(1.0, e[1]),
                        ldexp(1.0, e[2])};
  // compact rows of S bytes: the weights (16 or 32 bytes), the bins; or
  // the row-major X, Fd stored bins a row
  constexpr int W = WIDE ? 32 : 16;
  const T* xg = COMPACT ? reinterpret_cast<const T*>(
                              reinterpret_cast<const char*>(xc) + W) + g.c0
                        : static_cast<const T*>(xv) + g.c0;
  const int stride = COMPACT ? S / static_cast<int>(sizeof(T)) : Fd;
  const bool words4 =
      (g.c0 * static_cast<int>(sizeof(T))) % 4 == 0 &&
      (COMPACT || ((Fd * static_cast<int>(sizeof(T))) % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(xv) & 3) == 0));
  // the slot's first cell in the sums, at the block's tile
  const size_t ko = static_cast<size_t>(k) * F * B * 3 + g.b0 * 3;

  for (int j = a + threadIdx.x; j < b; j += blockDim.x) {
    const int row = COMPACT ? j : list[j].x;
    int bins[kMaxGroup];
    group_bins<true, FORM>(xg, row, stride, 0, g.nc, g.nhi, g.b0, BT,
                           words4, bins);
    Quant<WIDE> q[3];
    if constexpr (COMPACT)
      row_quant<WIDE, true>(xc + static_cast<size_t>(j) * (S / 16), j,
                            bf16, e, sc, q);
    else
      row_quant<WIDE>(wv, row, bf16, e, sc, q);
#pragma unroll
    for (int f = 0; f < kMaxGroup; ++f) {
      if (bins[f] < 0 || bins[f] >= bn) continue;
      if (smem) {
        const int c = (f * BT + bins[f]) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          add_shared<WIDE>(p0, p1, p2, p3, c + ch, q[ch]);
      } else {
        const int gf = cell_feature<PACKED>(f, g.c0, g.nc, g.nhi, Fd);
        const size_t o = ko + static_cast<size_t>(gf) * B * 3 + bins[f] * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          if constexpr (WIDE)
            add_global<true>(acc, o + ch, q[ch].lo, q[ch].hi);
          else
            add_global<false>(acc, o + ch, q[ch], 0ull);
        }
      }
    }
  }
  if (!smem) return;
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long lo =
        (static_cast<unsigned long long>(p1[i]) << 32) | p0[i];
    unsigned long long hi = 0ull;
    if constexpr (WIDE)
      hi = (static_cast<unsigned long long>(p3[i]) << 32) | p2[i];
    if (lo == 0ull && hi == 0ull) continue;
    const int ff = i / (BT * 3);
    const int bc = i - ff * BT * 3;          // (b - b0, c)
    const int gf = cell_feature<PACKED>(ff, g.c0, g.nc, g.nhi, Fd);
    if (bc >= bn * 3 || gf < 0) continue;
    add_global<WIDE>(acc, ko + static_cast<size_t>(gf) * B * 3 + bc, lo, hi);
  }
}

// hist[k] = acc[first slot holding child_id[k]] / 2^e: in f32, or in f64
// from the 128-bit sums (WIDE).
template <bool WIDE>
__global__ void finish_kernel(const unsigned long long* __restrict__ acc,
                              const int* __restrict__ cid,
                              const int* __restrict__ exps,
                              void* __restrict__ hist, int K,
                              long long per_slot) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= per_slot * K) return;
  const int k = static_cast<int>(i / per_slot);
  const long long rem = i - k * per_slot;
  const int kr = find_first(cid, k + 1, cid[k]);
  const int c = static_cast<int>(rem % 3);
  const long long o = kr * per_slot + rem;
  if constexpr (WIDE)
    static_cast<double*>(hist)[i] =
        lgbt::to_f64(acc[2 * o], acc[2 * o + 1], exps[c]);
  else
    static_cast<float*>(hist)[i] = lgbt::to_f32(acc[o], exps[c]);
}

// Shared memory of one histogram block: C copies of KS slots x FS
// features x BT bins x 3 channels of 64 bits (128 bits when wide).
size_t hist_smem(int BT, int KS, int FS, int C, bool wide) {
  return (wide ? 16ull : 8ull) * C * KS * FS * BT * 3;
}

// Stored columns of F features: ceil(F / 2) packed, else F.
int stored_cols(int F, bool packed) { return packed ? (F + 1) / 2 : F; }

// The bins a block holds: B over the grid's tiles, where a grid of
// `groups` blocks on its x axis covers the stored columns in feature
// groups of FS features (FS / 2 packed columns) and each feature group
// in tiles of bins.
int bin_tile(int F, int B, int groups, int FS, bool packed) {
  const int PS = packed ? FS / 2 : FS;
  const int fgroups = (stored_cols(F, packed) + PS - 1) / PS;
  const int tiles = groups / fgroups;
  return tiles < 1 ? 0 : (B + tiles - 1) / tiles;
}

using HistKernel = void (*)(const void*, const void*, const int2*,
                           const unsigned long long*, const int*,
                           unsigned long long*, int, int, int, int, int, int,
                           int, int, int);
using OrderedKernel = void (*)(const void*, const void*, const int2*,
                              const uint4*, const unsigned long long*,
                              const int*,
                              unsigned long long*, int, int, int, int, int,
                              int, int);

template <bool ROWMAJOR, int FORM, bool WIDE>
HistKernel hist_kernel_of(int C) {
  return C > 1 ? &hist_kernel<ROWMAJOR, true, FORM, WIDE>
               : &hist_kernel<ROWMAJOR, false, FORM, WIDE>;
}

template <bool ROWMAJOR, bool WIDE>
HistKernel hist_kernel_form(int form, int C) {
  return form == kPacked ? hist_kernel_of<ROWMAJOR, kPacked, WIDE>(C)
       : form == kWide16 ? hist_kernel_of<ROWMAJOR, kWide16, WIDE>(C)
                         : hist_kernel_of<ROWMAJOR, kByte, WIDE>(C);
}

template <bool WIDE, bool COMPACT>
OrderedKernel ordered_kernel_form(int form) {
  return form == kPacked ? &hist_ordered_kernel<kPacked, WIDE, COMPACT>
       : form == kWide16 ? &hist_ordered_kernel<kWide16, WIDE, COMPACT>
                         : &hist_ordered_kernel<kByte, WIDE, COMPACT>;
}

// The dynamic shared memory each histogram kernel has been granted on
// each device: [rowmajor][form][wide][copies > 1, or 2 for the ordered
// pass].
int hist_granted[2][3][2][3][lgbt::kMaxDevices];

// The histogram kernel of the form (the slot-ordered one when ordered,
// else hist_kernel with C copies), allowed smem bytes of shared memory.
cudaError_t hist_kernel_with(bool rowmajor, int form, bool wide, int C,
                             bool ordered, size_t smem, const void** kern) {
  if (ordered)                           // compact rows unless row-major
    *kern = reinterpret_cast<const void*>(
        rowmajor ? (wide ? ordered_kernel_form<true, false>(form)
                         : ordered_kernel_form<false, false>(form))
                 : (wide ? ordered_kernel_form<true, true>(form)
                         : ordered_kernel_form<false, true>(form)));
  else
    *kern = reinterpret_cast<const void*>(
        rowmajor ? (wide ? hist_kernel_form<true, true>(form, C)
                         : hist_kernel_form<true, false>(form, C))
                 : (wide ? hist_kernel_form<false, true>(form, C)
                         : hist_kernel_form<false, false>(form, C)));
  return lgbt::allow_smem(
      *kern, smem,
      hist_granted[rowmajor][form][wide][ordered ? 2 : (C > 1 ? 1 : 0)]);
}

int form_of(bool packed, bool bins16) {
  return packed ? kPacked : bins16 ? kWide16 : kByte;
}

cudaError_t launch_finish(const unsigned long long* acc64, const void* cid,
                          const void* exps, void* hist, int K,
                          long long per_slot, bool wide, cudaStream_t s);

// 64-bit words of the sums of K slots of F x B x 3 cells (two a cell when
// wide).
long long sum_words(int F, int B, int K, bool wide) {
  return static_cast<long long>(F) * B * 3 * K * (wide ? 2 : 1);
}

// The compact rows of the slot-ordered pass (Compact) in the workspace:
// after acc's sums, the list's length and the 2K slot words, 128-byte
// aligned, N rows of compact_stride bytes.  x: the bins X_t, w3 the
// weights.
Compact compact_of(void* acc, const void* x, const void* w3, int F, int N,
                   int B, int K, bool packed, bool bins16, bool wide) {
  const unsigned long long* end = static_cast<unsigned long long*>(acc) +
                                  sum_words(F, B, K, wide) + 1 + 2ll * K;
  const uintptr_t p =
      (reinterpret_cast<uintptr_t>(end) + 127) & ~static_cast<uintptr_t>(127);
  Compact c;
  c.x = x;
  c.w3 = w3;
  c.Fd = stored_cols(F, packed);
  c.S = compact_stride(c.Fd, bins16 ? 2 : 1, wide);
  c.W = wide ? 32 : 16;
  c.xc = reinterpret_cast<uint4*>(p);
  c.bins16 = bins16;
  c.wide = wide;
  return c;
}

// The histogram pass over the list and the conversion (f32, or f64 when
// wide).  acc holds K * F * B * 3 zeroed sums (64-bit words, two a sum
// when wide) followed by the list's length and (ordered) the K slot
// counts.  packed: x holds ceil(F / 2) packed columns, FS is even and a
// group covers FS / 2 of them; bins16: x holds uint16 bins; bf16: the
// weights are rounded to bf16 first.  groups counts feature groups x bin
// tiles (bin_tile).  ordered: the list is ordered by slot, its rows
// copied into the compact rows cp, and the pass is hist_ordered_kernel's
// (KS and C are 1).  finish = false stops after the
// histogram pass and leaves the fixed-point sums in acc (the
// deferred-finish form: a distributed learner adds the ranks' sums, then
// runs the conversion alone, lgbt_wave_finish).
cudaError_t hist_and_finish(const void* x, const void* w3, const void* list,
                            const void* cid, const void* exps, void* acc,
                            void* hist, int F, int N, int B, int K,
                            int groups, int R, int KS, int FS, int C,
                            bool ordered, const Compact& cp, bool rowmajor,
                            bool packed, bool bf16, bool bins16, bool wide,
                            bool finish, cudaStream_t s) {
  if (FS < 1 || FS > kMaxGroup || KS < 1 || C < 1 || C > kMaxCopies ||
      (C & (C - 1)) != 0 || (packed && (FS & 1) != 0) ||
      (packed && bins16) || (wide && bf16) ||
      (ordered && (K > kMaxOrderedSlots || KS != 1 || C != 1)))
    return cudaErrorInvalidValue;
  const int BT = bin_tile(F, B, groups, FS, packed);
  if (BT < 1) return cudaErrorInvalidValue;
  const long long per_slot = static_cast<long long>(F) * B * 3;
  unsigned long long* acc64 = static_cast<unsigned long long*>(acc);
  const unsigned long long* count = acc64 + sum_words(F, B, K, wide);
  const size_t smem = hist_smem(BT, KS, FS, C, wide);
  const void* kern;
  cudaError_t e = hist_kernel_with(rowmajor, form_of(packed, bins16), wide,
                                   C, ordered, smem, &kern);
  if (e != cudaSuccess) return e;
  const int Fd = stored_cols(F, packed);
  const int2* l = static_cast<const int2*>(list);
  const int* ex = static_cast<const int*>(exps);
  if (ordered)
    reinterpret_cast<OrderedKernel>(kern)<<<dim3(groups, R + K),
                                            kHistThreads, smem, s>>>(
        x, w3, l, cp.xc, count + 1, ex, acc64, F, Fd, cp.S, B, K, FS,
        bf16 ? 1 : 0);
  else
    reinterpret_cast<HistKernel>(kern)<<<dim3(groups, R, (K + KS - 1) / KS),
                                         kHistThreads, smem, s>>>(
        x, w3, l, count, ex, acc64, F, Fd, N, B, K, KS, FS, C,
        bf16 ? 1 : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess || !finish) return e;
  return launch_finish(acc64, cid, exps, hist, K, per_slot, wide, s);
}

// The conversion alone: hist[k] = acc[first slot holding cid[k]] / 2^e
// for K slots of per_slot sums each.
cudaError_t launch_finish(const unsigned long long* acc64, const void* cid,
                          const void* exps, void* hist, int K,
                          long long per_slot, bool wide, cudaStream_t s) {
  const int threads = 256;
  const long long total = per_slot * K;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                threads);
  if (wide)
    finish_kernel<true><<<blocks, threads, 0, s>>>(
        acc64, static_cast<const int*>(cid), static_cast<const int*>(exps),
        hist, K, per_slot);
  else
    finish_kernel<false><<<blocks, threads, 0, s>>>(
        acc64, static_cast<const int*>(cid), static_cast<const int*>(exps),
        hist, K, per_slot);
  return cudaGetLastError();
}

// acc's K * F * B * 3 sums (two words a sum when wide), the list's length
// and the 2K slot words after them (the counts and the cursors of the
// slot-ordered list), zeroed on the stream; *count points at the length.
int zero_acc(void* acc, int F, int B, int K, bool wide, void* stream,
             unsigned long long** count) {
  const long long words = sum_words(F, B, K, wide);
  *count = static_cast<unsigned long long*>(acc) + words;
  return static_cast<int>(cudaMemsetAsync(
      acc, 0, 8 * (words + 1 + 2ll * K), static_cast<cudaStream_t>(stream)));
}

// The list passes on the stream: mode 0 selects the rows by their ids,
// mode 1 routes them first and writes new_lid, mode 2 does so on EFB
// group columns.  Unordered: one kAppend pass, the length in *count.
// Ordered (slots: K counts then K cursors, zeroed): kCount (routing in
// modes 1 and 2), then kScatter over the ids to list (new_lid once
// routed), which also writes the length and copies the listed rows into
// the compact rows cp (none when cp.xc is null).
cudaError_t launch_list(const void* xt, const void* lid, const void* cid,
                        const void* cols, const void* psrc, void* new_lid,
                        void* list, void* count, void* slots, int F, int N,
                        int K, int W, int blocks, int mode, bool packed,
                        bool bins16, bool ordered, const Compact& cp,
                        cudaStream_t s) {
  if (mode == 0) W = 0;
  if ((packed && bins16) || (ordered && (K > kMaxOrderedSlots || !slots)))
    return cudaErrorInvalidValue;
  const size_t smem = 4 * (static_cast<size_t>(W) * 11 + K +
                           (ordered ? 3 * static_cast<size_t>(K) + 1 : 0));
  const int Fd = stored_cols(F, packed);
  const int* l = static_cast<const int*>(lid);
  const int* c = static_cast<const int*>(cid);
  const float* cl = static_cast<const float*>(cols);
  const int* ps = static_cast<const int*>(psrc);
  int* nl = static_cast<int*>(new_lid);
  int2* li = static_cast<int2*>(list);
  unsigned long long* n = static_cast<unsigned long long*>(count);
  unsigned long long* sl = static_cast<unsigned long long*>(slots);
  const bool bundled = mode == 2;
  // the routing forms: [bundled] x byte, packed, two-byte bins
  using ListKernel = void (*)(const uint8_t*, const int*, const int*,
                              const float*, const int*, int*, int2*,
                              unsigned long long*, unsigned long long*, int,
                              int, int, int, int, Compact);
  using ListKernel16 = void (*)(const uint16_t*, const int*, const int*,
                                const float*, const int*, int*, int2*,
                                unsigned long long*, unsigned long long*,
                                int, int, int, int, int, Compact);
  const Compact none{};
  if (mode == 0) {
    static const ListKernel select[2] = {
        &list_kernel<false, false, false, uint8_t, kAppend>,
        &list_kernel<false, false, false, uint8_t, kCount>};
    select[ordered]<<<blocks, kListThreads, smem, s>>>(
        nullptr, l, c, cl, ps, nl, li, n, sl, F, Fd, N, K, W, none);
  } else if (bins16) {
    static const ListKernel16 route16[2][2] = {
        {&list_kernel<true, false, false, uint16_t, kAppend>,
         &list_kernel<true, false, false, uint16_t, kCount>},
        {&list_kernel<true, true, false, uint16_t, kAppend>,
         &list_kernel<true, true, false, uint16_t, kCount>}};
    route16[bundled][ordered]<<<blocks, kListThreads, smem, s>>>(
        static_cast<const uint16_t*>(xt), l, c, cl, ps, nl, li, n, sl, F,
        Fd, N, K, W, none);
  } else {
    static const ListKernel route[2][2][2] = {
        {{&list_kernel<true, false, false, uint8_t, kAppend>,
          &list_kernel<true, false, false, uint8_t, kCount>},
         {&list_kernel<true, false, true, uint8_t, kAppend>,
          &list_kernel<true, false, true, uint8_t, kCount>}},
        {{&list_kernel<true, true, false, uint8_t, kAppend>,
          &list_kernel<true, true, false, uint8_t, kCount>},
         {&list_kernel<true, true, true, uint8_t, kAppend>,
          &list_kernel<true, true, true, uint8_t, kCount>}}};
    route[bundled][packed][ordered]<<<blocks, kListThreads, smem, s>>>(
        static_cast<const uint8_t*>(xt), l, c, cl, ps, nl, li, n, sl, F,
        Fd, N, K, W, none);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !ordered) return e;
  // the ids to list: B1's new ones once routed
  const size_t smem2 = 4 * (static_cast<size_t>(K) * 4 + 1);
  // T: the compact rows' bin type (the select pass reads no bins itself)
  if (cp.bins16)
    list_kernel<false, false, false, uint16_t, kScatter>
        <<<blocks, kListThreads, smem2, s>>>(
            nullptr, mode == 0 ? l : nl, c, nullptr, nullptr, nullptr, li,
            n, sl, F, Fd, N, K, 0, cp);
  else
    list_kernel<false, false, false, uint8_t, kScatter>
        <<<blocks, kListThreads, smem2, s>>>(
            nullptr, mode == 0 ? l : nl, c, nullptr, nullptr, nullptr, li,
            n, sl, F, Fd, N, K, 0, cp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one histogram block: C copies of KS slots x FS
// features x BT bins x 3 channels of 64 bits, or of 128 bits when wide
// (the wrapper's launch plan mirrors it).
long long lgbt_wave_hist_smem_form(int BT, int KS, int FS, int C,
                                   int wide) {
  return static_cast<long long>(hist_smem(BT, KS, FS, C, wide != 0));
}

long long lgbt_wave_hist_smem(int B, int KS, int FS, int C) {
  return lgbt_wave_hist_smem_form(B, KS, FS, C, 0);
}

// The bins a block of the plan holds (bin_tile).
int lgbt_wave_bin_tile(int F, int B, int groups, int FS, int packed) {
  return bin_tile(F, B, groups, FS, packed != 0);
}

// Histogram blocks of the plan resident on one SM, or -1 on an error.
int lgbt_wave_hist_blocks_per_sm_form(int BT, int KS, int FS, int C,
                                      int rowmajor, int packed, int bins16,
                                      int wide) {
  const size_t smem = hist_smem(BT, KS, FS, C, wide != 0);
  const void* kern;
  if (hist_kernel_with(rowmajor != 0, form_of(packed != 0, bins16 != 0),
                       wide != 0, C, false, smem, &kern) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, kHistThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

int lgbt_wave_hist_blocks_per_sm(int B, int KS, int FS, int C,
                                 int rowmajor, int packed) {
  return lgbt_wave_hist_blocks_per_sm_form(B, KS, FS, C, rowmajor, packed,
                                           0, 0);
}

// Blocks of the slot-ordered pass (one slot of FS features x BT bins in
// shared memory; compact rows, so one kernel for both layouts) resident
// on one SM, or -1 on an error.
int lgbt_wave_hist_ordered_blocks_per_sm(int BT, int FS, int packed,
                                         int bins16, int wide) {
  const size_t smem = hist_smem(BT, 1, FS, 1, wide != 0);
  const void* kern;
  if (hist_kernel_with(false, form_of(packed != 0, bins16 != 0), wide != 0,
                       1, true, smem, &kern) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, kHistThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// The list passes alone: the compact list (N, 2) int32 of (row, slot)
// pairs and its length in *count (which must be 0 on entry).  mode 0
// selects the rows by their ids (B3, B4, B5; xt, cols, psrc and new_lid are
// not read and may be null, W = 0); mode 1 routes them first and writes
// new_lid (B1), mode 2 does so on EFB group columns; packed: xt holds
// ceil(F / 2) packed columns (the route reads the split column's nibble);
// bins16: xt holds uint16 bins.  ordered: the list ordered by slot (K <=
// 1024; slots: 2K zeroed words, left holding each slot's count and its
// cursor; slot k's rows lie after the counts of the slots before it; no
// compact rows are written).
int lgbt_wave_list(const void* xt, const void* lid, const void* cid,
                   const void* cols, const void* psrc, void* new_lid,
                   void* list, void* count, void* slots, int F, int N, int K,
                   int W, int blocks, int mode, int packed, int bins16,
                   int ordered, void* stream) {
  return static_cast<int>(launch_list(
      xt, lid, cid, cols, psrc, new_lid, list, count, slots, F, N, K, W,
      blocks, mode, packed != 0, bins16 != 0, ordered != 0, Compact{},
      static_cast<cudaStream_t>(stream)));
}

// B1, the fused wave step: routing, histograms of the listed rows, the
// conversion.  acc holds K * F * B * 3 + 1 + 2K 64-bit words (2 K F B 3
// + 1 + 2K when wide), zeroed here (after the sums: the list's length,
// the slot counts and cursors of the ordered list); list N int2; hist K
// * F * B * 3 floats (doubles when wide).  F counts features (logical
// columns): with packed, xt holds ceil(F / 2) packed columns; bins16:
// uint16 bins; bf16 rounds the weights to bf16 before the sums; wide: w3
// is float64 and the sums 128-bit; ordered: the plan's slot-ordered pass
// (the list ordered by slot, its rows copied into the compact rows after
// acc's words, compact_of; KS = C = 1); finish = 0 stops before the
// conversion, leaving the sums in acc (lgbt_wave_finish converts them).
int lgbt_wave_fused(const void* xt, const void* lid, const void* w3,
                    const void* cid, const void* cols, const void* psrc,
                    const void* exps, void* new_lid, void* list, void* acc,
                    void* hist, int F, int N, int B, int K, int W,
                    int list_blocks, int groups, int R, int KS, int FS,
                    int C, int ordered, int bundled, int packed, int bf16,
                    int bins16, int wide, int finish, void* stream) {
  unsigned long long* count;
  int e = zero_acc(acc, F, B, K, wide != 0, stream, &count);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Compact cp = ordered ? compact_of(acc, xt, w3, F, N, B, K,
                                          packed != 0, bins16 != 0,
                                          wide != 0)
                             : Compact{};
  e = static_cast<int>(launch_list(
      xt, lid, cid, cols, psrc, new_lid, list, count, count + 1, F, N, K, W,
      list_blocks, bundled ? 2 : 1, packed != 0, bins16 != 0, ordered != 0,
      cp, s));
  if (e != 0) return e;
  return static_cast<int>(hist_and_finish(
      xt, w3, list, cid, exps, acc, hist, F, N, B, K, groups, R, KS, FS, C,
      ordered != 0, cp, false, packed != 0, bf16 != 0, bins16 != 0,
      wide != 0, finish != 0, s));
}

// B3 (X_t (F, N)) and B4 (rowmajor: X (N, F)), the histogram-only pass:
// the select pass, histograms of the listed rows, the conversion; acc,
// list and hist, packed, bf16, bins16, wide, ordered and finish as for
// lgbt_wave_fused.
// B5 is this pass with rowmajor = 1, K = 1 and cid the leaf, on a plan of
// its own.
int lgbt_wave_hist(const void* x, const void* lid, const void* w3,
                   const void* cid, const void* exps, void* list, void* acc,
                   void* hist, int F, int N, int B, int K, int list_blocks,
                   int groups, int R, int KS, int FS, int C, int ordered,
                   int rowmajor, int packed, int bf16, int bins16, int wide,
                   int finish, void* stream) {
  unsigned long long* count;
  int e = zero_acc(acc, F, B, K, wide != 0, stream, &count);
  if (e != 0) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // B4's row-major rows are read from X (one or two sectors a group)
  const Compact cp = ordered && !rowmajor
                         ? compact_of(acc, x, w3, F, N, B, K, packed != 0,
                                      bins16 != 0, wide != 0)
                         : Compact{};
  e = static_cast<int>(launch_list(
      nullptr, lid, cid, nullptr, nullptr, nullptr, list, count, count + 1,
      F, N, K, 0, list_blocks, 0, false, false, ordered != 0, cp, s));
  if (e != 0) return e;
  return static_cast<int>(hist_and_finish(
      x, w3, list, cid, exps, acc, hist, F, N, B, K, groups, R, KS, FS, C,
      ordered != 0, cp, rowmajor != 0, packed != 0, bf16 != 0, bins16 != 0,
      wide != 0, finish != 0, s));
}

// The conversion of a deferred-finish launch alone (B1, B3, B4, B5 with
// finish = 0): hist (K, F, B, 3) f32, or f64 when wide, from the K * F *
// B * 3 fixed-point sums in acc (two words a sum when wide) with the
// tree's exponents; slot k reads the first slot holding cid[k].
int lgbt_wave_finish(const void* acc, const void* cid, const void* exps,
                     void* hist, int F, int B, int K, int wide,
                     void* stream) {
  if (F < 1 || B < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_finish(
      static_cast<const unsigned long long*>(acc), cid, exps, hist, K,
      static_cast<long long>(F) * B * 3, wide != 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
