// Fused SA / GA / RSA attention forward for Hopper (sm_90a).
//
// Replaces `_fwd_kernel` (with `_scores`, `_softmax`, `_rel_t_into` and
// `_rel_pre_into`) in mmnas_tpu/ops/pallas_attention.py, with and without
// attention dropout. One block handles kRows query rows of one (batch b,
// head h):
//
//   s   = q k^T * scale  (+ bias[b,h])  (+ log(max(pre, 1e-6)))  (- 1e9 where mask[b])
//   pre = sum_r relu(b1[r] + sum_c raw[b,i,j,c] * W1[r,c]) * Wr[h,r]  + br[h]
//   a   = softmax(s) in fp32
//   a   = a * keep / (1 - r)  with dropout, keep written to keep[b,h,i,j]
//   o   = a v, with a rounded to the operand type (a.astype(v.dtype)),
//         accumulated in fp32, stored in the operand type
//
// Dropout draws its keep mask counter-based: the first word of
// Philox4x32-10 keyed by a 64-bit seed at counter (j, i, b*H + h, 0), kept
// when below (1 - r) 2^32 as at pallas_attention.py:205-207. The mask thus
// depends on the seed and the element only, not on the launch layout. It is
// written out as a uint8 residual for the backward kernel (the TPU kernel
// emits its mask as bf16 for the same reason, :36-48).
//
// Operands are fp32 or bf16 (T); the pad mask arrives as the caller's bool
// [B, Lk] row (true = pad) and adds -1e9 to a padded key's score, as the
// TPU kernel's additive mask row does. raw is read in its natural
// [B, Lq, Lk, Rr] layout (the TPU kernel split it into planes only for its
// tiling), W1 is [R, Rr] and Wr is [H, R] (torch Linear layout).
//
// What bounds it on this card: neither device memory nor the FMA units. At
// the shapes of the searched VQA net (L <= 100, D = 64) a head's K and V fit
// in shared memory whole, so q, k, v are read from device memory once (K/V
// once more per extra row block, from L2) and o is written once; the
// [Lq, Lk] scores and the [Lq, Lk, R] relation features never leave the SM.
// Both products and the relation chain run as scalar fp32 FMAs on the CUDA
// cores, and every FMA of the two products reads both its operands from
// shared memory (one a broadcast), so the kernel is bound by shared-memory
// load issue: at one warp-wide load per SM per cycle, the loads of a
// (100, 100) call at B 64, H 8 take about 0.17 ms of the 0.25 ms it was
// measured at (H100 80GB HBM3, 700 W power limit), about 5 TFLOP/s of the
// card's 67. The relation chain adds the most: each of its R steps reads
// Rr + 2 weights from shared memory for Rr + 1 FMAs, 2.5x the FMAs of the
// two products per score at Rr = 4, R = 64, D = 64. Holding several scores
// per thread in registers per loaded operand is the first remedy.
//
// Design: no state passes between blocks (the TPU kernel carried the
// relation features across the head programs of a batch row in VMEM; here
// each (b, h, row block) recomputes them, which keeps blocks independent).
// The chain stays fp32 even for bf16 operands: pre sits at the 1e-6 clamp
// and the log turns small errors into large bias errors. Lengths 14 and 100
// are not multiples of anything: every loop is bounded by the true row and
// key counts. Shared memory is dynamic (about 64 KB at Lk = 100, D = 64,
// above the 48 KB static limit) and opted in per launch.

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kRows = 16;      // query rows per block
constexpr int kThreads = 256;  // 8 warps; the softmax gives each warp 2 rows

// Philox4x32-10 (Salmon et al., SC'11): the first output word for
// counter (c0, c1, c2, 0) and key `seed`.
__device__ __forceinline__ unsigned int philox_first(unsigned long long seed, unsigned int c0,
                                                     unsigned int c1, unsigned int c2) {
  unsigned int x0 = c0, x1 = c1, x2 = c2, x3 = 0u;
  unsigned int k0 = static_cast<unsigned int>(seed);
  unsigned int k1 = static_cast<unsigned int>(seed >> 32);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned int hi0 = __umulhi(0xD2511F53u, x0), lo0 = 0xD2511F53u * x0;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, x2), lo1 = 0xCD9E8D57u * x2;
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return x0;
}

template <typename T>
struct Args {
  const T* q;              // [B, H, Lq, D]
  const T* k;              // [B, H, Lk, D]
  const T* v;              // [B, H, Lk, D]
  const T* bias;           // [B, H, Lq, Lk] or null
  const unsigned char* mask;  // [B, Lk] bool, true = pad; or null
  const T* raw;            // [B, Lq, Lk, Rr] or null (no relation chain)
  const T* w1;             // [R, Rr]
  const T* b1;             // [R]
  const T* wr;             // [H, R]
  const T* br;             // [H]
  T* out;                  // [B, H, Lq, D]
  unsigned char* keep;     // [B, H, Lq, Lk] keep mask out, or null (no dropout)
  int H, Lq, Lk, D, Rr, R;
  float scale;
  unsigned long long seed;  // dropout: Philox key
  unsigned int keep_thr;    // dropout: keep when bits < keep_thr
  float keep_p;             // dropout: 1 - r
};

size_t smem_floats(int Lk, int D, int Rr, int R, bool has_rel) {
  size_t n = (size_t)Lk * (D + 1) + (size_t)Lk * D + (size_t)kRows * D + (size_t)kRows * Lk;
  if (has_rel) n += (size_t)R * Rr + 2 * (size_t)R;
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_attention_fwd_kernel(const Args<T> a) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, R = a.R, Rr = a.Rr;
  const int rows = min(kRows, Lq - row0);
  const bool has_rel = a.raw != nullptr;

  const int ldk = D + 1;          // padded K rows: a warp walking j hits 32 banks
  float* ks = smem;               // [Lk][D + 1]
  float* vs = ks + Lk * ldk;      // [Lk][D]
  float* qs = vs + Lk * D;        // [kRows][D]
  float* ss = qs + kRows * D;     // [kRows][Lk] scores, then probabilities
  float* w1s = ss + kRows * Lk;   // [R][Rr]
  float* b1s = w1s + R * Rr;      // [R]
  float* wrs = b1s + R;           // [R], row h of Wr

  const long bh = (long)b * a.H + h;
  const T* kp = a.k + bh * Lk * D;
  const T* vp = a.v + bh * Lk * D;
  const T* qp = a.q + (bh * Lq + row0) * D;
  for (int i = threadIdx.x; i < Lk * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    ks[j * ldk + d] = load_f32(kp, i);
    vs[i] = load_f32(vp, i);
  }
  for (int i = threadIdx.x; i < rows * D; i += kThreads) qs[i] = load_f32(qp, i);
  if (has_rel) {
    for (int i = threadIdx.x; i < R * Rr; i += kThreads) w1s[i] = load_f32(a.w1, i);
    for (int i = threadIdx.x; i < R; i += kThreads) {
      b1s[i] = load_f32(a.b1, i);
      wrs[i] = load_f32(a.wr, (long)h * R + i);
    }
  }
  __syncthreads();

  // scores, one (row, key) pair per thread per step
  const float br = has_rel ? load_f32(a.br, h) : 0.f;
  for (int i = threadIdx.x; i < rows * Lk; i += kThreads) {
    const int r = i / Lk, j = i - r * Lk;
    const float* qr = qs + r * D;
    const float* kj = ks + j * ldk;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
    float s = dot * a.scale;
    const long ij = (long)(row0 + r) * Lk + j;
    if (a.bias != nullptr) s += load_f32(a.bias, bh * Lq * Lk + ij);
    if (has_rel) {
      const T* rp = a.raw + ((long)b * Lq * Lk + ij) * Rr;
      s += logf(fmaxf(relation_pre(rp, Rr, R, w1s, b1s, wrs, br), kClamp));
    }
    if (a.mask != nullptr && a.mask[(long)b * Lk + j]) s += kMaskAdd;
    ss[r * Lk + j] = s;
  }
  __syncthreads();

  // fp32 softmax over each row, one warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* sr = ss + r * Lk;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const int i = row0 + r;
    for (int j = lane; j < Lk; j += 32) {
      float p = sr[j] / sum;
      if (a.keep != nullptr) {
        const bool kept = philox_first(a.seed, j, i, static_cast<unsigned int>(bh)) < a.keep_thr;
        a.keep[(bh * Lq + i) * Lk + j] = kept;
        p = (p * (kept ? 1.f : 0.f)) / a.keep_p;
      }
      sr[j] = round_to(p, a.q);
    }
  }
  __syncthreads();

  // o = a v, one (row, feature) pair per thread per step
  T* op = a.out + (bh * Lq + row0) * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float* sr = ss + r * Lk;
    float acc = 0.f;
    for (int j = 0; j < Lk; ++j) acc = fmaf(sr[j], vs[j * D + d], acc);
    store_f32(op, i, acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, const void* raw, const void* w1, const void* b1,
                   const void* wr, const void* br, void* out, void* keep, int B, int H,
                   int Lq, int Lk, int D, int Rr, int R, float scale, unsigned long long seed,
                   unsigned int keep_thr, float keep_p, cudaStream_t stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1) return cudaErrorInvalidValue;
  if (raw != nullptr && (Rr < 1 || Rr > kMaxRr || R < 1)) return cudaErrorInvalidValue;
  if (keep != nullptr && !(keep_p > 0.f && keep_p <= 1.f)) return cudaErrorInvalidValue;
  Args<T> a{static_cast<const T*>(q),  static_cast<const T*>(k),
            static_cast<const T*>(v),  static_cast<const T*>(bias),
            static_cast<const unsigned char*>(mask),
            static_cast<const T*>(raw), static_cast<const T*>(w1),
            static_cast<const T*>(b1), static_cast<const T*>(wr),
            static_cast<const T*>(br), static_cast<T*>(out),
            static_cast<unsigned char*>(keep),
            H, Lq, Lk, D, Rr, R, scale, seed, keep_thr, keep_p};
  const size_t bytes = smem_floats(Lk, D, Rr, R, raw != nullptr) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kRows - 1) / kRows, H, B);
  fused_attention_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers may be null for absent operands
// (bias, mask, raw together with w1/b1/wr/br, and keep: no dropout). With
// keep, the kernel draws the mask for `seed`, keeps an element when its bits
// are below keep_thr, scales kept probabilities by 1 / keep_p and writes the
// mask to keep. Returns the CUDA error code of the launch (0 = launched); the
// kernel runs on `stream`.
extern "C" int mmnas_fused_attention_fwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* bias,
                                         const void* mask, const void* raw,
                                         const void* w1, const void* b1, const void* wr,
                                         const void* br, void* out, void* keep, int B, int H,
                                         int Lq, int Lk, int D, int Rr, int R, float scale,
                                         unsigned long long seed, unsigned int keep_thr,
                                         float keep_p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, mask, raw, w1, b1, wr, br, out, keep, B, H, Lq, Lk,
                         D, Rr, R, scale, seed, keep_thr, keep_p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, mask, raw, w1, b1, wr, br, out, keep, B, H,
                                 Lq, Lk, D, Rr, R, scale, seed, keep_thr, keep_p, s);
  return cudaErrorInvalidValue;
}
