// Partition-side training score update for Hopper (sm_90a).
//
// Replaces (JAX package, TPU Pallas):
//   lightgbm_tpu/ops/predict.py::_update_score_pallas
//     (kernel _score_update_kernel)
//
// Contract: out[i] = score[i] + v[clamp(leaf_id[i], 0, L - 1)] with
// v[l] = clip(scale * leaf_value[l], +-max_output) in f32: one multiply,
// then the clip (Tree::Shrinkage's clamp, ops/partition.py
// clipped_leaf_values), then one add.  Each is rounded once, exactly as
// the gather form rounds them, so the result is bit-equal to it.  out may
// be score itself: every element is read and written by one thread, so
// the update runs in place (the port's training loop updates its score
// that way).
//
// What bounds it on this card: 12 bytes a row (score and leaf id in,
// score out) against one add, so memory: ~7.2 us at N = 2M and
// 3.35 TB/s.  The TPU kernel's compare-select loop over an SMEM table and
// its L <= 512 gate worked around slow gathers there.  Here the kernel
// forms the clipped table once a block in shared memory (no separate
// launches for the multiply and the clip, and no host-to-device copy of
// the scale, which travels as a kernel argument), then each thread moves
// 4 rows at a time with 16-byte loads and stores on a grid of a few
// blocks a SM; a ragged tail, or pointers that are not 16-byte aligned,
// take the scalar loop.  Tables above kStagedMax leaves are read from
// global memory instead (L1-cached) and clipped per row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kStagedMax = 12288;      // 48 KB of f32 leaf values

__device__ __forceinline__ float clipped(float scale, float v, float m) {
  const float x = __fmul_rn(scale, v);
  return x < -m ? -m : (x > m ? m : x);  // NaN passes, as torch.clamp
}

template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
score_update_kernel(const float* score, const int* __restrict__ lid,
                    const float* __restrict__ leaf_value, float* out,
                    long long n, int L, float scale, float max_output) {
  extern __shared__ float table[];
  if (STAGED) {
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      table[i] = clipped(scale, leaf_value[i], max_output);
    __syncthreads();
  }
  auto val = [&](int l) {
    l = l < 0 ? 0 : (l > L - 1 ? L - 1 : l);
    return STAGED ? table[l] : clipped(scale, leaf_value[l], max_output);
  };
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(score) | reinterpret_cast<uintptr_t>(lid)
        | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  long long done = 0;
  if (aligned) {
    const long long n4 = n / 4;
    const float4* s4 = reinterpret_cast<const float4*>(score);
    const int4* l4 = reinterpret_cast<const int4*>(lid);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long q = tid; q < n4; q += stride) {
      float4 s = s4[q];
      const int4 l = l4[q];
      s.x = __fadd_rn(s.x, val(l.x));
      s.y = __fadd_rn(s.y, val(l.y));
      s.z = __fadd_rn(s.z, val(l.z));
      s.w = __fadd_rn(s.w, val(l.w));
      o4[q] = s;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    out[i] = __fadd_rn(score[i], val(lid[i]));
}

}  // namespace

extern "C" int lgbt_score_update(const void* score, const void* lid,
                                 const void* leaf_value, void* out,
                                 long long n, int L, float scale,
                                 float max_output, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want < sms * kBlocksPerSm ? want : sms * kBlocksPerSm));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(score);
  const int* li = static_cast<const int*>(lid);
  const float* lv = static_cast<const float*>(leaf_value);
  float* o = static_cast<float*>(out);
  if (L <= kStagedMax)
    score_update_kernel<true><<<blocks, kThreads, L * sizeof(float), s>>>(
        sc, li, lv, o, n, L, scale, max_output);
  else
    score_update_kernel<false><<<blocks, kThreads, 0, s>>>(
        sc, li, lv, o, n, L, scale, max_output);
  return static_cast<int>(cudaGetLastError());
}
