// Wave histogram kernels for Hopper (sm_90a): the histogram-only pass
// on the transposed or the row-major bin matrix.  (The fused partition +
// histogram pass of a wave is csrc/wave_fused.cu.)
//
// Replaces (JAX package, TPU Pallas):
//   lightgbm_tpu/ops/pallas_wave.py::wave_histogram_pallas_t
//     (kernel _wave_hist_kernel_t)     -> ROWMAJOR = false
//   lightgbm_tpu/ops/pallas_wave.py::wave_histogram_pallas
//     (kernel _wave_hist_kernel)       -> ROWMAJOR = true
//
// Contract.  X_t (F, N) uint8 bins, leaf_id (N,) int32, w3 (N, 3) f32
// [g*m, h*m, m], child_id (K,) int32 (-1 = inactive).  hist[k, f, b, :]
// sums w3 over the rows whose leaf id equals child_id[k] and whose bin in
// feature f is b; bins >= B are dropped.
//
// What bounds it on this card.  Per (row, feature) the work is one byte of
// X_t in and three f32 adds into a (K, F, B, 3) block: at the flagship
// shape (N = 2M, F = 28, B = 63, K = 32) the bytes that must move (X_t,
// leaf ids in and out, w3) take ~29 us at 3.35 TB/s and the adds ~3 us at
// the FP32 rate, so the bound is memory.  What limits a simple design is
// elsewhere: (a) the (K, F, B, 3) f32 block is 688 KB, three times what
// one block can hold in shared memory, and (b) determinism: float
// atomics, in global or shared memory, sum in an order that changes from
// run to run.
//
// Design.  A block owns a range of rows, a group of features (one feature
// per warp) and, when K * B is large, a slice of the child slots.  Each
// warp keeps a private (KS, B, 3) histogram of its feature in shared
// memory.  Rows are staged a tile at a time: one thread per row finds
// the row's child slot and stages its weights, while each warp's loads of
// its feature's bins for the tile are already in flight.  A warp then walks the tile 32 rows at a time; lanes
// whose rows fall into the same (slot, bin) cell are grouped with
// __match_any_sync and the group's lowest lane adds the group's values in
// lane order.  No two warps share a histogram and every sum runs in a
// fixed order, so the result does not depend on scheduling.  Each block
// writes its private histograms to a scratch buffer of partials
// (R, K, F, B, 3); a second kernel adds the R partials in row-block order.
// The wrapper picks R so the partials stay a fraction of the bytes of X_t.
//
// Row-major variant (ROWMAJOR, X (N, F)).  A warp reading one feature
// across 32 consecutive rows would read bytes F apart.  Instead the block
// stages, for each tile, the tile's rows' bytes of its feature group (up
// to 8 contiguous bytes a row, neighbouring threads on neighbouring
// bytes) in shared memory while it stages the rows' slots and weights,
// and each warp takes its feature's bins from there.  Everything else is
// the histogram-only pass above.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;           // rows staged per tile
constexpr int kSteps = kTile / 32;   // 32-row steps per tile

__device__ __forceinline__ void warp_accumulate(int key, int lane,
                                                const float* vals,
                                                float* hist) {
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

template <bool ROWMAJOR>
__global__ void wave_hist_kernel(const uint8_t* __restrict__ xt,
                                 const int* __restrict__ lid,
                                 const float* __restrict__ w3,
                                 const int* __restrict__ cid,
                                 float* __restrict__ partial,
                                 int F, int N, int B, int K,
                                 int rows_per_block, int KS) {
  extern __shared__ float smem[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.z * KS;
  const int k1 = min(K, k0 + KS);
  const int kn = k1 - k0;
  const int f = blockIdx.x * nwarps + warp;          // this warp's feature
  const int hist_len = KS * B * 3;

  float* hist = smem;                                // nwarps * hist_len
  float* vals = hist + nwarps * hist_len;            // nwarps * 32 * 3
  float* w_s = vals + nwarps * 96;                   // kTile * 3
  int* slot_s = reinterpret_cast<int*>(w_s + kTile * 3);   // kTile
  int* nl_s = slot_s + kTile;                        // kTile
  int* cid_s = nl_s + kTile;                         // K
  int* flag = cid_s + K;                             // 1
  uint8_t* xs = reinterpret_cast<uint8_t*>(flag + 1);      // kTile * nwarps
  const int fbase = blockIdx.x * nwarps;             // ROWMAJOR: group
  const int nf = min(nwarps, F - fbase);

  for (int i = threadIdx.x; i < nwarps * hist_len; i += blockDim.x)
    hist[i] = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) cid_s[i] = cid[i];

  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(N, row_begin + rows_per_block);
  float* my_hist = hist + warp * hist_len;
  float* my_vals = vals + warp * 96;
  const uint8_t* xrow =
      ROWMAJOR ? xt : xt + static_cast<size_t>(f < F ? f : 0) * N;

  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    __syncthreads();                 // previous tile fully consumed
    if (threadIdx.x == 0) *flag = 0;
    const int tile_n = min(kTile, row_end - t0);
    // this warp's bins for the tile, loaded ahead of the staging below
    int bins[kSteps];
    if constexpr (!ROWMAJOR) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int i = j * 32 + lane;
        int b = (f < F && i < tile_n) ? static_cast<int>(xrow[t0 + i]) : -1;
        bins[j] = b < B ? b : -1;
      }
    }
    __syncthreads();
    if constexpr (ROWMAJOR) {
      // the group's bytes of the tile's rows, row by row
      for (int idx = threadIdx.x; idx < tile_n * nf; idx += blockDim.x) {
        const int i = idx / nf;
        const int j = idx - i * nf;
        xs[i * nwarps + j] =
            xrow[static_cast<size_t>(t0 + i) * F + fbase + j];
      }
    }
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const int row = t0 + i;
      int s1 = -1, nl = -1;
      float a = 0.f, b = 0.f, c = 0.f;
      if (i < tile_n) {
        nl = lid[row];
        int cnt = 0;
        for (int k = k0; k < k1; ++k) {
          if (cid_s[k] == nl) {
            if (cnt == 0) s1 = k;
            ++cnt;
          }
        }
        if (cnt > 1) atomicOr(flag, 1);   // duplicate child ids: slow path
        if (cnt > 0) {
          a = w3[3 * static_cast<size_t>(row) + 0];
          b = w3[3 * static_cast<size_t>(row) + 1];
          c = w3[3 * static_cast<size_t>(row) + 2];
        }
      }
      slot_s[i] = s1;
      nl_s[i] = nl;
      w_s[3 * i + 0] = a;
      w_s[3 * i + 1] = b;
      w_s[3 * i + 2] = c;
    }
    __syncthreads();
    const bool multi = *flag != 0;
    if constexpr (ROWMAJOR) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int i = j * 32 + lane;
        const int b = (f < F && i < tile_n)
            ? static_cast<int>(xs[i * nwarps + warp]) : -1;
        bins[j] = b < B ? b : -1;
      }
    }
    if (f < F) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (j * 32 >= tile_n) break;   // warp-uniform
        const int i = j * 32 + lane;
        const bool in = i < tile_n;
        const int bin = bins[j];
        my_vals[lane * 3 + 0] = in ? w_s[3 * i + 0] : 0.f;
        my_vals[lane * 3 + 1] = in ? w_s[3 * i + 1] : 0.f;
        my_vals[lane * 3 + 2] = in ? w_s[3 * i + 2] : 0.f;
        __syncwarp();
        if (!multi) {
          const int s = in ? slot_s[i] : -1;
          const int key = (s >= 0 && bin >= 0) ? (s - k0) * B + bin : -1;
          warp_accumulate(key, lane, my_vals, my_hist);
        } else {
          for (int k = k0; k < k1; ++k) {
            const bool m = in && bin >= 0 && nl_s[i] == cid_s[k];
            if (!__any_sync(0xffffffffu, m)) continue;
            warp_accumulate(m ? (k - k0) * B + bin : -1, lane, my_vals,
                            my_hist);
          }
        }
      }
    }
  }
  __syncwarp();
  if (f < F) {
    const int cells = kn * B * 3;
    for (int idx = lane; idx < cells; idx += 32) {
      const int kk = idx / (B * 3);
      const int rem = idx - kk * (B * 3);
      const size_t o =
          ((static_cast<size_t>(blockIdx.y) * K + k0 + kk) * F + f) *
              static_cast<size_t>(B) * 3 + rem;
      partial[o] = my_hist[idx];
    }
  }
}

// out[i] = sum_r partial[r * S + i], r ascending: the fixed-order
// reduction of the per-row-block partials.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int R,
                                       long long S) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= S) return;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) acc += partial[r * S + i];
  out[i] = acc;
}

template <bool ROWMAJOR>
cudaError_t launch(const void* xt, const void* lid, const void* w3,
                   const void* cid, void* partial, int F, int N, int B,
                   int K, int R, int rows_per_block, int KS, int warps,
                   size_t smem, cudaStream_t s) {
  auto kern = wave_hist_kernel<ROWMAJOR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((F + warps - 1) / warps, R, (K + KS - 1) / KS);
  kern<<<grid, warps * 32, smem, s>>>(
      static_cast<const uint8_t*>(xt), static_cast<const int*>(lid),
      static_cast<const float*>(w3), static_cast<const int*>(cid),
      static_cast<float*>(partial), F, N, B, K, rows_per_block, KS);
  return cudaGetLastError();
}

// Dynamic shared memory bytes of one block, as laid out at the top of
// wave_hist_kernel (the wrapper's _smem_bytes mirrors it to plan KS and
// warps); the row-major variant adds its tile of bin bytes.
size_t smem_bytes(int B, int K, int KS, int warps, bool rowmajor) {
  return 4 * (static_cast<size_t>(warps) * KS * B * 3 + warps * 96 +
              kTile * 5 + K + 1) +
         (rowmajor ? 4 * ((kTile * warps + 3) / 4) : 0);
}

}  // namespace

extern "C" {

// Histogram-only wave pass on X_t (F, N) or on row-major X (N, F)
// (rowmajor=1).  partial holds R * K * F * B * 3 floats, hist
// K * F * B * 3.  Returns cudaGetLastError() after both launches.
int lgbt_wave_hist(const void* xt, const void* lid, const void* w3,
                   const void* cid, void* partial, void* hist, int F, int N,
                   int B, int K, int R, int rows_per_block, int KS,
                   int warps, int rowmajor, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(B, K, KS, warps, rowmajor != 0);
  cudaError_t e =
      rowmajor ? launch<true>(xt, lid, w3, cid, partial, F, N, B, K, R,
                              rows_per_block, KS, warps, smem, s)
               : launch<false>(xt, lid, w3, cid, partial, F, N, B, K, R,
                               rows_per_block, KS, warps, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long S = static_cast<long long>(K) * F * B * 3;
  const int threads = 256;
  const long long blocks = (S + threads - 1) / threads;
  reduce_partials_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(hist), R, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
