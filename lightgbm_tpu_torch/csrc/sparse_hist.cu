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
// child_id (K,) int32 (-1 = inactive).  hist[k, f, b, :] sums w3 over the
// entries of column f with bin b in [0, B) whose row's leaf is
// child_id[k] >= 0.  Every cell of the (K, F, B, 3) output is written: the
// fill-bin slots (never stored) and inactive slots are exactly 0.
//
// What bounds it on this card.  Per entry: 8 bytes of (row, bin) read in
// order, two gathers (leaf_id[row], w3[row]) and three f32 adds.  At the
// Bosch shape (N = 1M, F = 968, 1% dense: ~9.7M entries, B = 63, K = 32)
// the bytes that must move -- entries, leaf ids, w3 and the 23 MB output --
// take ~35 us at 3.35 TB/s; the adds are negligible.  The gathered
// vectors (16 MB at N = 1M) stay in the 50 MB L2.  What limits a simple
// design is determinism: float atomics sum in an order that changes from
// run to run, and the reference's runs are bit-identical.
//
// Design.  One block per device column (and per slice of KS child slots
// when K * B is large) walks that column's chunks; no other block touches
// the column, so no partials and no second pass are needed.  Each warp
// keeps a private (KS, B, 3) histogram in shared memory and takes the
// column's 32-entry steps w, w + nwarps, ... in order, kUnroll steps in
// flight at a time so the dependent gathers overlap.  Lanes whose entries
// fall into the same (slot, bin) cell are grouped with __match_any_sync and
// the group's lowest lane adds the group's values in lane order.  At the
// end the block adds the warps' histograms in warp order and writes the
// column's slice of the output.  Every sum runs in a fixed order, so
// repeats are bit-identical.  A column with many chunks (the narrow,
// skewed layout) makes its block slow, never wrong.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;   // 32-entry steps a warp keeps in flight

__device__ __forceinline__ void warp_accumulate(int key, int lane, float a,
                                                float b, float c,
                                                float* vals, float* hist) {
  vals[lane * 3 + 0] = a;
  vals[lane * 3 + 1] = b;
  vals[lane * 3 + 2] = c;
  __syncwarp();
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    float sa = 0.f, sb = 0.f, sc = 0.f;
    unsigned p = peers;
    while (p) {                        // ascending lane order: fixed
      const int src = __ffs(p) - 1;
      sa += vals[src * 3 + 0];
      sb += vals[src * 3 + 1];
      sc += vals[src * 3 + 2];
      p &= p - 1;
    }
    float* cell = hist + key * 3;
    cell[0] += sa;
    cell[1] += sb;
    cell[2] += sc;
  }
  __syncwarp();
}

__global__ void sparse_hist_kernel(const int* __restrict__ ent_row,
                                   const int* __restrict__ ent_bin,
                                   const int* __restrict__ col_cptr,
                                   const int* __restrict__ lid,
                                   const float* __restrict__ w3,
                                   const int* __restrict__ cid,
                                   float* __restrict__ hist, int F, int N,
                                   int B, int K, int E, int KS) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x;                           // this block's column
  const int k0 = blockIdx.y * KS;
  const int kn = min(K, k0 + KS) - k0;
  const int hist_len = KS * B * 3;

  float* whist = smem;                                // nwarps * hist_len
  float* vals = whist + nwarps * hist_len;            // nwarps * 32 * 3
  int* cid_s = reinterpret_cast<int*>(vals + nwarps * 96);   // KS
  __shared__ int dup;

  for (int i = threadIdx.x; i < nwarps * hist_len; i += blockDim.x)
    whist[i] = 0.f;
  for (int i = threadIdx.x; i < kn; i += blockDim.x) cid_s[i] = cid[k0 + i];
  __syncthreads();
  if (threadIdx.x == 0) {
    // two active slots with one leaf: each gets the leaf's histogram
    int d = 0;
    for (int i = 0; i < kn && !d; ++i)
      for (int j = i + 1; j < kn; ++j)
        if (cid_s[i] >= 0 && cid_s[i] == cid_s[j]) { d = 1; break; }
    dup = d;
  }
  __syncthreads();

  const long long e0 = static_cast<long long>(col_cptr[f]) * E;
  const long long e1 = static_cast<long long>(col_cptr[f + 1]) * E;
  const long long step = static_cast<long long>(nwarps) * 32;
  float* my_hist = whist + warp * hist_len;
  float* my_vals = vals + warp * 96;

  for (long long base = e0 + warp * 32LL; base < e1;
       base += step * kUnroll) {       // warp-uniform trip count
    int row[kUnroll], bin[kUnroll], leaf[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + u * step + lane;
      row[u] = N;
      bin[u] = -1;
      if (e < e1) {
        row[u] = ent_row[e];
        bin[u] = ent_bin[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // pads (row N, bin -1) are dropped before the gather: leaf_id[N]
      // is out of bounds
      ok[u] = row[u] >= 0 && row[u] < N && bin[u] >= 0 && bin[u] < B;
      leaf[u] = ok[u] ? lid[row[u]] : 0;
    }
    int slot[kUnroll];
    float a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int s = -1;
      if (ok[u]) {
        for (int k = 0; k < kn; ++k) {
          if (cid_s[k] >= 0 && cid_s[k] == leaf[u]) { s = k; break; }
        }
      }
      slot[u] = s;
      a[u] = b[u] = c[u] = 0.f;
      if (s >= 0) {
        const size_t o = 3 * static_cast<size_t>(row[u]);
        a[u] = w3[o + 0];
        b[u] = w3[o + 1];
        c[u] = w3[o + 2];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!dup) {
        const int key = slot[u] >= 0 ? slot[u] * B + bin[u] : -1;
        warp_accumulate(key, lane, a[u], b[u], c[u], my_vals, my_hist);
      } else {
        // the row's weights were loaded for its first slot; every slot
        // with the same leaf adds them
        for (int k = 0; k < kn; ++k) {
          const bool m = slot[u] >= 0 && cid_s[k] == leaf[u];
          if (!__any_sync(0xffffffffu, m)) continue;
          warp_accumulate(m ? k * B + bin[u] : -1, lane, a[u], b[u], c[u],
                          my_vals, my_hist);
        }
      }
    }
  }
  __syncthreads();
  // warps merge in warp order; the block writes its column's slice
  const int cells = kn * B * 3;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += whist[w * hist_len + idx];
    const int kk = idx / (B * 3);
    const int rem = idx - kk * (B * 3);
    hist[(static_cast<size_t>(k0 + kk) * F + f) * static_cast<size_t>(B) *
             3 + rem] = s;
  }
}

// Dynamic shared memory bytes of one block, as laid out at the top of
// sparse_hist_kernel (the wrapper's _smem_bytes mirrors it to plan KS and
// warps).
size_t smem_bytes(int B, int KS, int warps) {
  return 4 * (static_cast<size_t>(warps) * KS * B * 3 + warps * 96 + KS);
}

}  // namespace

extern "C" {

// B6 on the stream `stream`: hist holds K * F * B * 3 floats, every one
// written.  KS child slots and `warps` warps a block.  Returns
// cudaGetLastError() after the launch.
int lgbt_sparse_hist(const void* ent_row, const void* ent_bin,
                     const void* col_cptr, const void* lid, const void* w3,
                     const void* cid, void* hist, int F, int N, int B, int K,
                     int E, int KS, int warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(B, KS, warps);
  cudaError_t e = cudaFuncSetAttribute(
      sparse_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(F, (K + KS - 1) / KS);
  sparse_hist_kernel<<<grid, warps * 32, smem, s>>>(
      static_cast<const int*>(ent_row), static_cast<const int*>(ent_bin),
      static_cast<const int*>(col_cptr), static_cast<const int*>(lid),
      static_cast<const float*>(w3), static_cast<const int*>(cid),
      static_cast<float*>(hist), F, N, B, K, E, KS);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
