// The 64-bit fixed point that every histogram kernel of the port sums in
// (csrc/wave_fused.cu: B1, B3, B4, B5; csrc/sparse_hist.cu: B6), and the
// leaf -> slot lookup they share.
//
// Channel c of an f32 weight row w3[row] is scaled by 2^e[c], with e[c] = 62 -
// frexp_exponent(N * max|w_c|) computed once a tree on the device
// (ops/wave_kernels.py fixed_point_exponents), and rounded to the nearest
// integer.  A histogram cell sums those integers exactly, in any order,
// and is rounded to f32 once: so every kernel that sums the same rows with
// the same exponents gives the same bits, whatever its layout, its launch
// plan or the order its threads run in.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {

// leaf ids below kTable map to a child slot through a 16-bit table in
// shared memory; larger ids take a search of the child ids
constexpr int kTable = 4096;

// First index i of ids[0..n) with ids[i] == v, or -1.
__device__ __forceinline__ int find_first(const int* ids, int n, int v) {
  for (int i = 0; i < n; ++i)
    if (ids[i] == v) return i;
  return -1;
}

// The slot of leaf id v: table[v] for ids below tmax, a search of the n
// child ids for ids at or above kTable, else -1.
__device__ __forceinline__ int lookup_slot(const short* table, int tmax,
                                       const int* ids, int n, int v) {
  if (v >= 0 && v < kTable) return v < tmax ? table[v] : -1;
  return find_first(ids, n, v);
}

// w rounded to the nearest multiple of 1 / scale, as an integer in two's
// complement (scale = 2^e[c]).
__device__ __forceinline__ unsigned long long quantize(float w,
                                                       double scale) {
  return static_cast<unsigned long long>(
      __double2ll_rn(static_cast<double>(w) * scale));
}

// w rounded to bf16 precision, as the JAX package's _round_bf16 does
// (lightgbm_tpu/ops/pallas_wave.py): 0x8000 added to the bits, the low 16
// bits cleared -- round to nearest, ties away from zero on the magnitude
// (not to even).  The single-bf16-product histograms
// (tpu_hist_precision=bf16) sum these values.
__device__ __forceinline__ float round_bf16(float w) {
  return __uint_as_float((__float_as_uint(w) + 0x8000u) & 0xFFFF0000u);
}

// The f32 value of a cell's sum v (two's complement) at exponent e.
__device__ __forceinline__ float to_f32(unsigned long long v, int e) {
  return static_cast<float>(
      ldexp(static_cast<double>(static_cast<long long>(v)), -e));
}

// The f64 form (tpu_use_dp) sums in 128-bit fixed point: channel c of a
// float64 weight row is scaled by 2^e[c] with e[c] = 126 -
// frexp_exponent(N * max|w_c|) and rounded to the nearest integer, held
// as two 64-bit words (lo, hi) in two's complement; no sum of N values
// reaches 2^126.  A value errs by at most N * max|w_c| / 2^126, 2^-105 of
// max|w_c| at N = 2^21 (a cell of N_cell rows by N_cell times that), far
// below a float64's own rounding of the weights near the largest.  The
// 64-bit form's N * max|w_c| / 2^62 a value (2^-41 of max|w_c| at N =
// 2^21) is not double-grade, hence the second word.
struct Q128 {
  unsigned long long lo, hi;
};

// ldexp(w, e) rounded to the nearest integer (ties to even), |w| 2^e <
// 2^126.  The magnitude is split exactly at 2^64 (its 53 significant bits
// lie on one side or straddle the split, and both parts are exact
// doubles), then negated in 128-bit two's complement.
__device__ __forceinline__ Q128 quantize128(double w, int e) {
  const double a = rint(fabs(ldexp(w, e)));
  const unsigned long long hi = __double2ull_rz(a * 0x1p-64);
  const unsigned long long lo =
      __double2ull_rz(a - static_cast<double>(hi) * 0x1p64);
  Q128 q{lo, hi};
  if (w < 0.0) {
    q.lo = ~lo + 1ull;
    q.hi = ~hi + (q.lo == 0ull ? 1ull : 0ull);
  }
  return q;
}

// The f64 value of a 128-bit sum (lo, hi) at exponent e: the magnitude
// as hi * 2^64 + lo in double (deterministic, within an ulp or two of
// the exact value), then the sign and 2^-e.
__device__ __forceinline__ double to_f64(unsigned long long lo,
                                         unsigned long long hi, int e) {
  const bool neg = static_cast<long long>(hi) < 0;
  if (neg) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
  const double m = static_cast<double>(hi) * 0x1p64 +
                   static_cast<double>(lo);
  return ldexp(neg ? -m : m, -e);
}

// q added to the 128-bit cell whose 32-bit words, low to high, are *p0 ..
// *p3, with native 32-bit shared atomics: each word's old value gives the
// carry into the next, so the cell sums exactly and in any order.  A word
// that adds zero (no part of q, no carry) is skipped.
__device__ __forceinline__ void add128(unsigned* p0, unsigned* p1,
                                       unsigned* p2, unsigned* p3, Q128 q) {
  const unsigned part[4] = {
      static_cast<unsigned>(q.lo), static_cast<unsigned>(q.lo >> 32),
      static_cast<unsigned>(q.hi), static_cast<unsigned>(q.hi >> 32)};
  unsigned* word[4] = {p0, p1, p2, p3};
  unsigned carry = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned t = part[i] + carry;
    unsigned next = t < carry ? 1u : 0u;   // part 0xffffffff plus a carry
    if (t != 0u) {
      const unsigned old = atomicAdd(word[i], t);
      next += static_cast<unsigned>(old + t) < old ? 1u : 0u;
    }
    carry = next;
  }
}

// q added to the 64-bit cell whose low and high words are *lo and *hi,
// with native 32-bit shared atomics: the low word's old value gives the
// carry into the high word, so the pair sums exactly and in any order.
// (sm_90 has no 64-bit shared atomic add: atomicAdd on an unsigned long
// long in shared memory compiles to a compare-and-swap loop.)
__device__ __forceinline__ void add64(unsigned* lo, unsigned* hi,
                                      unsigned long long q) {
  const unsigned ql = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(lo, ql);
  const unsigned h = static_cast<unsigned>(q >> 32) +
                     (static_cast<unsigned>(old + ql) < old ? 1u : 0u);
  if (h != 0u) atomicAdd(hi, h);
}

// Raise kern's dynamic shared memory limit to at least smem bytes on the
// current device.  The limit only grows, and is set once for each size a
// kernel has not yet been granted, so a launch does not pay for
// cudaFuncSetAttribute every time.  `granted` is the kernel's own record
// (one entry a device).
constexpr int kMaxDevices = 64;

inline cudaError_t allow_smem(const void* kern, size_t smem,
                              int (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && granted[dev] >= static_cast<int>(smem))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && dev < kMaxDevices)
    granted[dev] = static_cast<int>(smem);
  return e;
}

}  // namespace lgbt
