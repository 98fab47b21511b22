// Device code shared by the fused attention forward and backward kernels:
// loads and stores in the operand type, warp reductions, and the RSA
// relation chain of one score.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mmnas {

constexpr int kMaxRr = 8;          // raw relation channels held in registers
constexpr float kClamp = 1e-6f;    // log(max(pre, kClamp))
constexpr float kMaskAdd = -1e9f;  // added to a padded key's score

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}
// x rounded to the operand type T and widened back
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The relation chain of one (b, i, j), in fp32:
//   t[r] = relu(b1[r] + sum_c raw[c] W1[r, c])          (relation_feature)
//   pre  = sum_r t[r] Wr[h, r] + br[h]                   (relation_pre)
// The attention kernels and the bias probes (probes.cu) all compute it
// through these functions, so they round alike.

// the Rr raw channels at `rp`, widened to fp32 (zeros past Rr)
template <typename T>
__device__ __forceinline__ void load_raw(const T* rp, int Rr, float (&x)[kMaxRr]) {
#pragma unroll
  for (int c = 0; c < kMaxRr; ++c) x[c] = c < Rr ? load_f32(rp, c) : 0.f;
}

// t[r] for the raw channels x; w1r is row r of W1 ([Rr]), b1r = b1[r]
__device__ __forceinline__ float relation_feature(const float (&x)[kMaxRr], int Rr,
                                                  const float* w1r, float b1r) {
  float u = b1r;
#pragma unroll
  for (int c = 0; c < kMaxRr; ++c)
    if (c < Rr) u = fmaf(x[c], w1r[c], u);
  return fmaxf(u, 0.f);
}

// pre of head h for the Rr raw channels at `rp`; w1s [R][Rr], b1s [R] and
// wrs [R] (row h of Wr) in shared memory
template <typename T>
__device__ __forceinline__ float relation_pre(const T* rp, int Rr, int R, const float* w1s,
                                              const float* b1s, const float* wrs, float br) {
  float x[kMaxRr];
  load_raw(rp, Rr, x);
  float pre = 0.f;
  for (int rr = 0; rr < R; ++rr)
    pre = fmaf(relation_feature(x, Rr, w1s + rr * Rr, b1s[rr]), wrs[rr], pre);
  return pre + br;
}

}  // namespace mmnas
