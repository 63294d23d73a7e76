// Leaf histogram kernel for Hopper (sm_90a): the (F, B, 3) histogram of
// one leaf, for exact (leaf-wise) growth.
//
// Replaces (JAX package, TPU Pallas):
//   lightgbm_tpu/ops/pallas_hist.py::leaf_histogram_pallas
//     (_hist_pallas, kernel _hist_kernel)
//
// Contract.  X (N, F) uint8 bins, row-major; grad, hess (N,) f32;
// row_mult (N,) f32, or null for all ones; leaf_id (N,) int32; leaf: one
// int32 in device memory, so the grower never reads it back to the host.
// hist[f, b, :] sums [g * m, h * m, m], m = row_mult, over the rows with
// leaf_id == leaf and X[row, f] == b; bins >= B are dropped.  A row of
// another leaf contributes exactly nothing.
//
// What bounds it on this card.  Every call reads leaf_id (4 bytes a row)
// to find the leaf's rows; only those rows' F bin bytes and 12 bytes of
// weights are needed, and the (F, B, 3) output is written once.  At the
// flagship shape (N = 2M, F = 28, B = 63) that is 8 MB for a small leaf
// and 88 MB for the root: 2.4 to 26 us at 3.35 TB/s, against 3 f32 adds a
// (row, feature) pair (under 3 us at the FP32 rate), so the bound is
// memory.  The exact grower calls this once for the root and once a
// split (up to 255 times a tree), so the launches and the partials pass
// cost as much as the bytes for small leaves.
//
// Design.  Grid (R row blocks, G feature groups).  A block keeps one
// private (Fg, B, 3) histogram of its feature group in shared memory (21
// KB at F = 28, B = 63, so all features fit one block); wider F or B
// takes more groups.  Rows go a tile of 256 at a time, one thread a row:
// each thread reads its leaf id, the rows of the leaf are compacted in row
// order with warp ballots, and only their weights and their Fg bin bytes
// are staged in shared memory (the bytes of other leaves' rows are never
// read).  Each warp owns the features fl = warp, warp + 8, ... of the
// group and walks the compacted rows 32 at a time; lanes that fall into
// the same bin are grouped with __match_any_sync and the group's lowest
// lane adds the group's weights in lane order.  No two warps share a
// cell and every sum runs in a fixed order.  Each block writes its
// histogram to a scratch of partials (R, F, B, 3) and a second kernel
// adds the R partials in row-block order (skipped when R = 1), so the
// result does not depend on scheduling: repeats are bit-identical.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;             // rows a tile = threads a block
constexpr int kWarps = kTile / 32;

__global__ void leaf_hist_kernel(const uint8_t* __restrict__ x,
                                 const float* __restrict__ grad,
                                 const float* __restrict__ hess,
                                 const float* __restrict__ rmult,
                                 const int* __restrict__ lid,
                                 const int* __restrict__ leaf_ptr,
                                 float* __restrict__ out, int F, int N,
                                 int B, int Fg, int rows_per_block) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * Fg;
  const int fn = min(Fg, F - f0);                    // this group's features
  const int hist_len = fn * B * 3;

  float* hist = smem;                                // Fg * B * 3
  float* w_s = hist + Fg * B * 3;                    // kTile * 3
  int* cnt_s = reinterpret_cast<int*>(w_s + kTile * 3);    // kWarps
  int* row_s = cnt_s + kWarps;                       // kTile
  uint8_t* xs = reinterpret_cast<uint8_t*>(row_s + kTile);  // kTile * Fg

  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) hist[i] = 0.f;
  const int leaf = *leaf_ptr;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);

  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    __syncthreads();                 // previous tile consumed
    const int row = t0 + threadIdx.x;
    const bool act = row < row_end && lid[row] == leaf;
    const unsigned bal = __ballot_sync(0xffffffffu, act);
    if (lane == 0) cnt_s[warp] = __popc(bal);
    __syncthreads();
    int off = 0, cnt = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt_s[w];
      if (w < warp) off += c;
      cnt += c;
    }
    if (cnt == 0) continue;          // block-uniform: no row of the leaf
    if (act) {                       // compacted in row order
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
      const float m = rmult != nullptr ? rmult[row] : 1.f;
      row_s[pos] = row;
      w_s[3 * pos + 0] = grad[row] * m;
      w_s[3 * pos + 1] = hess[row] * m;
      w_s[3 * pos + 2] = m;
    }
    __syncthreads();
    // the group's bin bytes of the compacted rows; neighbouring threads
    // read neighbouring bytes of a row
    for (int idx = threadIdx.x; idx < cnt * fn; idx += blockDim.x) {
      const int i = idx / fn;
      const int j = idx - i * fn;
      xs[i * Fg + j] =
          x[static_cast<size_t>(row_s[i]) * F + f0 + j];
    }
    __syncthreads();
    for (int fl = warp; fl < fn; fl += kWarps) {
      float* fh = hist + fl * B * 3;
      for (int base = 0; base < cnt; base += 32) {     // warp-uniform
        const int i = base + lane;
        int key = -1;
        if (i < cnt) {
          const int b = xs[i * Fg + fl];
          key = b < B ? b : -1;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && lane == __ffs(peers) - 1) {
          float sa = 0.f, sb = 0.f, sc = 0.f;
          unsigned p = peers;
          while (p) {                  // ascending lane order: fixed
            const float* w = w_s + 3 * (base + __ffs(p) - 1);
            sa += w[0];
            sb += w[1];
            sc += w[2];
            p &= p - 1;
          }
          float* cell = fh + key * 3;
          cell[0] += sa;
          cell[1] += sb;
          cell[2] += sc;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  float* dst = out + (static_cast<size_t>(blockIdx.x) * F + f0) * B * 3;
  for (int i = threadIdx.x; i < hist_len; i += blockDim.x) dst[i] = hist[i];
}

// out[i] = sum_r partial[r * S + i], r ascending.
__global__ void leaf_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int R,
                                   long long S) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= S) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += partial[r * S + i];
  out[i] = acc;
}

}  // namespace

extern "C" {

// Dynamic shared memory bytes of one block, as laid out at the top of
// leaf_hist_kernel (the wrapper's _smem_bytes mirrors it).
long long lgbt_leaf_hist_smem(int B, int Fg) {
  return 4LL * (static_cast<long long>(Fg) * B * 3 + kTile * 3 + kWarps +
                kTile) +
         static_cast<long long>(kTile) * Fg;
}

// Leaf histogram: R row blocks of rows_per_block rows, feature groups of
// Fg features.  partial holds R * F * B * 3 floats (unused when R = 1),
// hist F * B * 3.  row_mult may be null.  Returns cudaGetLastError()
// after the launches.
int lgbt_leaf_hist(const void* x, const void* grad, const void* hess,
                   const void* row_mult, const void* lid, const void* leaf,
                   void* partial, void* hist, int F, int N, int B, int R,
                   int rows_per_block, int Fg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(lgbt_leaf_hist_smem(B, Fg));
  cudaError_t e = cudaFuncSetAttribute(
      leaf_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  float* dst = static_cast<float*>(R == 1 ? hist : partial);
  const dim3 grid(R, (F + Fg - 1) / Fg);
  leaf_hist_kernel<<<grid, kTile, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const float*>(row_mult),
      static_cast<const int*>(lid), static_cast<const int*>(leaf), dst, F,
      N, B, Fg, rows_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess || R == 1) return static_cast<int>(e);
  const long long S = static_cast<long long>(F) * B * 3;
  const int threads = 256;
  const long long blocks = (S + threads - 1) / threads;
  leaf_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(hist), R, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
