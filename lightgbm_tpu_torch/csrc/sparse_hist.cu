// Sparse child-histogram kernel for Hopper (sm_90a): the (K, F, B, 3)
// histograms of one wave's child slots from the entry-chunk sparse store.
//
// Replaces (JAX package, TPU Pallas):
//   lightgbm_tpu/ops/sparse_mxu.py::sparse_wave_histogram_mxu
//     (kernel _chunk_hist_kernel)
//
// Contract.  The store holds the non-fill entries of F device columns,
// column-major in chunks of E entries: ent_row, ent_bin (NC, E) int32 (pad
// entries: row N, bin -1), and col_cptr (F+1,) int32, the chunk range of
// each column.  leaf_id (N,) int32, w3 (N, 3) f32 [g*m, h*m, m],
// child_id (K,) int32 (-1 = inactive), exps (3,) int32 the tree's
// fixed-point exponents.  hist[k, f, b, :] sums w3 over the entries of
// column f with bin b in [0, B) whose row's leaf is child_id[k] >= 0; a
// child id that repeats fills every slot that holds it.  Every cell of
// the (K, F, B, 3) output is written: the fill-bin slots (never stored)
// and inactive slots are exactly 0.  With bf16 (tpu_hist_precision=bf16)
// each entry's weights are rounded to bf16 (fixed_point.cuh round_bf16,
// the JAX package's _round_bf16) before they are quantized.
//
// What bounds it on this card.  Per entry: 8 bytes of (row, bin) read in
// order, the dependent gathers leaf_id[row] and, for an entry whose row is
// in a child slot, w3[row], and three adds.  At the Bosch shape (N = 1M,
// F = 968, 1% dense: ~9.7M entries, B = 63, K = 32) the bytes that must
// move -- entries, leaf ids, w3 and the 23 MB output -- take ~33 us at
// 3.35 TB/s; the adds are negligible.  The gathered vectors (16 MB at
// N = 1M) stay in the 50 MB L2.  The earlier design (one private f32
// (K, B, 3) histogram a warp, 197 KB a block at K = 32, so one block of 8
// warps an SM; a K-long search for each entry's slot; a serial
// __match_any_sync add in lane order; a slow path for repeated child ids)
// reached 3% of that bound.
//
// Design.  One block owns one device column (and a slice of KS child
// slots where (K, B, 3) does not fit, and a tile of BT = ceil(B / tiles)
// bins where one (slot, B, 3) row does not: more than 9,386 bins) and
// walks that column's chunks, skipping the entries whose bin lies outside
// its tile: no other block touches its cells, so it writes its slice of
// the f32 output itself, with no global buffer, memset or second kernel.
// A long column (the narrow, skewed layout) makes its block slow, never
// wrong.
//  - One shared histogram a block, of (KS, BT, 3) 64-bit fixed-point cells
//    (fixed_point.cuh: each channel quantised with the tree's exponents
//    exactly as csrc/wave_fused.cu's hist_kernel does, and added as two
//    native 32-bit shared atomics).  48 KB at K = 32, B = 63, so four
//    blocks share an SM.  (Lane-interleaved copies of the histogram, as
//    hist_kernel keeps at its root, bought nothing in a sweep on an
//    H100: the gathers, not the adds, set the pace.)
//  - A leaf -> slot table in shared memory, built from the slice's child
//    ids (the first holder of an id in the slice wins), as list_kernel
//    builds one: an entry's slot is one lookup (a search of the slice's
//    ids only for ids >= kTable).  A repeated id adds once, into its first
//    holder; the write-out copies the first holder's cells into the
//    others.  Two slices holding one id sum the same integers apart, so
//    they write the same bits.
//  - Each thread keeps kUnroll entries in flight: the coalesced (row, bin)
//    loads, then the leaf gathers, then the w3 gathers of the entries in
//    a slot, then the adds, so the dependent gathers overlap.
// The same rows with the same exponents give the same integer sums as
// B3's histogram of the dense bins, so B6's non-fill cells equal B3's bit
// for bit, and repeats are bit-identical.
#include <cstdint>
#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

using lgbt::add64;
using lgbt::kTable;

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;       // entries a thread keeps in flight

// Dynamic shared memory of one block: (KS, BT, 3) 64-bit cells as two
// planes of 32-bit words, then the slice's KS child ids and each slot's
// first holder.
size_t smem_bytes(int BT, int KS) { return 8ull * KS * BT * 3 + 8ull * KS; }

// Static shared memory: the leaf -> slot table and its length.
constexpr size_t kStaticSmem = sizeof(short) * kTable + sizeof(int);

__global__ void __launch_bounds__(kMaxThreads)
sparse_hist_kernel(const int* __restrict__ ent_row,
                   const int* __restrict__ ent_bin,
                   const int* __restrict__ col_cptr,
                   const int* __restrict__ lid, const float* __restrict__ w3,
                   const int* __restrict__ cid, const int* __restrict__ exps,
                   float* __restrict__ hist, int F, int N, int B, int K,
                   int E, int KS, int bf16) {
  extern __shared__ unsigned planes[];
  __shared__ short table[kTable];        // leaf -> first local slot, or -1
  __shared__ int tmax_s;
  const int tid = threadIdx.x;
  const int f = blockIdx.x;              // this block's column
  const int k0 = blockIdx.y * KS;
  const int kn = min(KS, K - k0);
  const int BT = (B + gridDim.z - 1) / gridDim.z;   // its bins [b0, b1)
  const int b0 = blockIdx.z * BT;
  const int b1 = min(B, b0 + BT);
  const int slot_len = BT * 3;
  const int cells = kn * slot_len;
  const int words = KS * slot_len;
  unsigned* lo = planes;
  unsigned* hi = planes + words;
  int* cid_s = reinterpret_cast<int*>(hi + words);     // KS
  int* first_s = cid_s + KS;                           // KS

  for (int i = tid; i < cells; i += blockDim.x) {
    lo[i] = 0u;
    hi[i] = 0u;
  }
  for (int i = tid; i < kn; i += blockDim.x) cid_s[i] = cid[k0 + i];
  __syncthreads();
  if (tid == 0) {                        // table length: largest id + 1
    int m = -1;
    for (int i = 0; i < kn; ++i) m = max(m, cid_s[i]);
    tmax_s = min(kTable, m + 1);
  }
  for (int i = tid; i < kn; i += blockDim.x)
    first_s[i] = cid_s[i] < 0 ? -1 : lgbt::find_first(cid_s, i + 1,
                                                      cid_s[i]);
  __syncthreads();
  const int tmax = tmax_s;
  for (int i = tid; i < tmax; i += blockDim.x) table[i] = -1;
  __syncthreads();
  // every holder of an id writes the same value: its first holder
  for (int i = tid; i < kn; i += blockDim.x)
    if (cid_s[i] >= 0 && cid_s[i] < tmax)
      table[cid_s[i]] = static_cast<short>(first_s[i]);
  __syncthreads();

  const double s0 = ldexp(1.0, exps[0]);
  const double s1 = ldexp(1.0, exps[1]);
  const double s2 = ldexp(1.0, exps[2]);
  const long long e0 = static_cast<long long>(col_cptr[f]) * E;
  const long long e1 = static_cast<long long>(col_cptr[f + 1]) * E;
  const long long step = blockDim.x;
  for (long long base = e0 + tid; base < e1; base += step * kUnroll) {
    int row[kUnroll], bin[kUnroll], slot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + u * step;
      row[u] = N;
      bin[u] = -1;
      if (e < e1) {
        row[u] = ent_row[e];
        bin[u] = ent_bin[e];
      }
    }
    // pads (row N, bin -1) and bins outside the tile (or past B) are
    // dropped before the gather: leaf_id[N] is out of bounds
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      slot[u] = (row[u] >= 0 && row[u] < N && bin[u] >= b0 && bin[u] < b1)
          ? lid[row[u]] : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      slot[u] = slot[u] < 0
          ? -1 : lgbt::lookup_slot(table, tmax, cid_s, kn, slot[u]);
    float w[kUnroll][3] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (slot[u] >= 0) {
        const float* wr = w3 + 3 * static_cast<size_t>(row[u]);
        w[u][0] = wr[0];
        w[u][1] = wr[1];
        w[u][2] = wr[2];
        if (bf16) {                      // block-uniform
          w[u][0] = lgbt::round_bf16(w[u][0]);
          w[u][1] = lgbt::round_bf16(w[u][1]);
          w[u][2] = lgbt::round_bf16(w[u][2]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (slot[u] >= 0) {
        const int c = slot[u] * slot_len + (bin[u] - b0) * 3;
        add64(lo + c, hi + c, lgbt::quantize(w[u][0], s0));
        add64(lo + c + 1, hi + c + 1, lgbt::quantize(w[u][1], s1));
        add64(lo + c + 2, hi + c + 2, lgbt::quantize(w[u][2], s2));
      }
    }
  }
  __syncthreads();

  // the block's slice of the output: slot k0 + kk, column f, its tile's
  // (b1 - b0) x 3 cells, from its first holder's cells (0 for an
  // inactive slot)
  const int x0 = exps[0], x1 = exps[1], x2 = exps[2];
  for (int i = tid; i < cells; i += blockDim.x) {
    const int kk = i / slot_len;
    const int rem = i - kk * slot_len;
    if (rem >= (b1 - b0) * 3) continue;  // the last tile's spare cells
    const int src = first_s[kk];
    float v = 0.f;
    if (src >= 0) {
      const int c = src * slot_len + rem;
      const int ch = rem % 3;
      v = lgbt::to_f32((static_cast<unsigned long long>(hi[c]) << 32) | lo[c],
                       ch == 0 ? x0 : ch == 1 ? x1 : x2);
    }
    hist[(static_cast<size_t>(k0 + kk) * F + f) * B * 3 + b0 * 3 + rem] = v;
  }
}

int sparse_granted[lgbt::kMaxDevices];

}  // namespace

extern "C" {

// Shared memory of one block, dynamic and static, at BT bins a block
// (the wrapper's plan, ops/sparse_mxu.py _smem_bytes, mirrors it).
long long lgbt_sparse_hist_smem(int BT, int KS) {
  return static_cast<long long>(smem_bytes(BT, KS) + kStaticSmem);
}

// B6 on the stream `stream`: hist holds K * F * B * 3 floats, every one
// written.  A block of `threads` threads (a multiple of 32, at most 1024)
// covers one column, KS child slots and one of `tiles` tiles of
// ceil(B / tiles) bins; bf16 rounds the weights to bf16 first.  Returns
// cudaGetLastError() after the launch.
int lgbt_sparse_hist(const void* ent_row, const void* ent_bin,
                     const void* col_cptr, const void* lid, const void* w3,
                     const void* cid, const void* exps, void* hist, int F,
                     int N, int B, int K, int E, int KS, int threads,
                     int tiles, int bf16, void* stream) {
  if (KS < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      tiles < 1 || tiles > B)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes((B + tiles - 1) / tiles, KS);
  cudaError_t e = lgbt::allow_smem(
      reinterpret_cast<const void*>(&sparse_hist_kernel), smem,
      sparse_granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(F, (K + KS - 1) / KS, tiles);
  sparse_hist_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ent_row), static_cast<const int*>(ent_bin),
      static_cast<const int*>(col_cptr), static_cast<const int*>(lid),
      static_cast<const float*>(w3), static_cast<const int*>(cid),
      static_cast<const int*>(exps), static_cast<float*>(hist), F, N, B, K,
      E, KS, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
