// Fused SA / GA / RSA attention backward for Hopper (sm_90a).
//
// Replaces `_bwd_kernel` in mmnas_tpu/ops/pallas_attention.py (called by
// `_bwd_call`), as two kernels:
//
// 1. fused_attention_bwd_kernel, one block per (batch b, head h). It walks
//    the query rows in chunks of kRows and, per chunk, recomputes the
//    scores s (with the bias, the RSA chain and the pad row, as the forward
//    kernel does) and a = softmax(s) in fp32, then (pallas_attention.py:368-392)
//
//      da   = (do v^T) * keep / (1 - r)        (keep = 1 without dropout)
//      ds   = a * (da - rowsum(da * a))        (a before dropout)
//      dv  += (a * keep / (1 - r))^T do
//      dk  += ds^T q * scale
//      dq   = ds k * scale
//      dbias = ds                              (with an additive bias)
//      dpre = ds * [pre > 1e-6] / pre          (with the RSA chain, when the
//                                               caller passes dpre: it needs
//                                               the relation gradients)
//
//    Under bf16 operands the dropped-out a and ds are rounded to bf16 before
//    the products, as the TPU kernel casts them (:376-382). dk and dv stay
//    in shared memory across the row chunks and are written once: the block
//    owns its (b, h), so nothing is accumulated across blocks.
//
// 2. fused_attention_bwd_rel_kernel, the relation pass, one block per
//    (batch b, chunk of `rows` query rows, chosen by the wrapper). It
//    recomputes the relation features t = relu(raw W1^T + b1) once for all
//    heads and reduces
//
//      du[i,j,r]   = sum_h dpre[h,i,j] * Wr[h,r] * [t[i,j,r] > 0]
//      dW1[r,c]   += sum_ij du[i,j,r] * raw[i,j,c]     db1[r] += sum_ij du[i,j,r]
//      dWr[h,r]   += sum_ij t[i,j,r] * dpre[h,i,j]     dbr[h] += sum_ij dpre[h,i,j]
//      draw[i,j,c] = sum_r du[i,j,r] * W1[r,c]          (only when asked for)
//
//    into per-(b, chunk) partials that the caller sums with torch.sum. The
//    TPU kernel carried du across the head programs of a batch row in VMEM
//    (du_scr, :341-343, :426-432); blocks on this card run in no order, so
//    the head sum moved into this second pass, which gets dpre from device
//    memory ([B, H, Lq, Lk] fp32, written by kernel 1) and needs neither
//    atomics nor an order between blocks. The sums are deterministic.
//
// The relation chain is fp32 under bf16 operands, as in the forward kernel.
//
// What bounds them on this card: like the forward kernel, kernel 1 runs its
// products and the relation chain as scalar fp32 FMAs on the CUDA cores,
// each FMA reading its operands from shared memory, so it is bound by
// shared-memory load issue, not by device memory: per (b, h) it reads q, k,
// v, do once and writes dq, dk, dv once. It does about 2.5x the forward's
// product FMAs (scores, da, dv, dk, dq) and recomputes the relation chain
// once per head. Kernel 2 moves dpre (20 MB at B 64, 8 heads, 100 x 100)
// through device memory and does about (2 Rr + 2 H + 1) FMAs per (i, j, r);
// it is small next to kernel 1. Tensor cores (wgmma) for the products and a
// relation pass shared with the forward are the remedies, for later.
//
// Shared memory is dynamic, about 129 KB for kernel 1 at Lk 100, D 64
// (K, V padded against bank conflicts, dK, dV, and the chunk's rows), opted
// in per launch.

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kRows = 16;      // query rows per chunk of kernel 1
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxH = 16;      // heads held in registers by kernel 2

// ---------------------------------------------------------------------------
// kernel 1: dq, dk, dv, dbias, dpre
// ---------------------------------------------------------------------------

template <typename T>
struct BwdArgs {
  const T* q;                 // [B, H, Lq, D]
  const T* k;                 // [B, H, Lk, D]
  const T* v;                 // [B, H, Lk, D]
  const T* bias;              // [B, H, Lq, Lk] or null
  const unsigned char* mask;  // [B, Lk] bool, true = pad; or null
  const T* raw;               // [B, Lq, Lk, Rr] or null (no relation chain)
  const T* w1;                // [R, Rr]
  const T* b1;                // [R]
  const T* wr;                // [H, R]
  const T* br;                // [H]
  const unsigned char* keep;  // [B, H, Lq, Lk] dropout keep mask, or null
  const T* dout;              // [B, H, Lq, D]
  T* dq;                      // [B, H, Lq, D]
  T* dk;                      // [B, H, Lk, D]
  T* dv;                      // [B, H, Lk, D]
  T* dbias;                   // [B, H, Lq, Lk], null without bias
  float* dpre;                // [B, H, Lq, Lk] fp32, or null (no relation gradients)
  int H, Lq, Lk, D, Rr, R;
  float scale, keep_p;
};

size_t bwd_smem_floats(int Lk, int D, int Rr, int R, bool has_rel) {
  size_t n = 2 * (size_t)Lk * (D + 1)      // K, V
             + 2 * (size_t)Lk * D          // dK, dV accumulators
             + 2 * (size_t)kRows * D       // q, do rows of the chunk
             + 3 * (size_t)kRows * Lk;     // a, dropped-out a, da / ds
  if (has_rel) n += (size_t)kRows * Lk + (size_t)R * Rr + 2 * (size_t)R;  // pre, W1, b1, Wr[h]
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_attention_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, R = a.R, Rr = a.Rr;
  const bool has_rel = a.raw != nullptr;
  const bool has_drop = a.keep != nullptr;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int ldk = D + 1;            // padded rows: a warp walking j hits 32 banks
  float* ks = smem;                 // [Lk][D + 1]
  float* vs = ks + Lk * ldk;        // [Lk][D + 1]
  float* dks = vs + Lk * ldk;       // [Lk][D]
  float* dvs = dks + Lk * D;        // [Lk][D]
  float* qs = dvs + Lk * D;         // [kRows][D]
  float* dos = qs + kRows * D;      // [kRows][D]
  float* as = dos + kRows * D;      // [kRows][Lk] scores, then a
  float* ads = as + kRows * Lk;     // [kRows][Lk] dropped-out a, in the operand type
  float* dss = ads + kRows * Lk;    // [kRows][Lk] da, then ds in the operand type
  float* pres = dss + kRows * Lk;   // [kRows][Lk] pre (relation chain)
  float* w1s = pres + kRows * Lk;   // [R][Rr]
  float* b1s = w1s + R * Rr;        // [R]
  float* wrs = b1s + R;             // [R], row h of Wr

  const long bh = (long)b * a.H + h;
  const T* kp = a.k + bh * Lk * D;
  const T* vp = a.v + bh * Lk * D;
  for (int i = tid; i < Lk * D; i += kThreads) {
    const int j = i / D, d = i - j * D;
    ks[j * ldk + d] = load_f32(kp, i);
    vs[j * ldk + d] = load_f32(vp, i);
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }
  if (has_rel) {
    for (int i = tid; i < R * Rr; i += kThreads) w1s[i] = load_f32(a.w1, i);
    for (int i = tid; i < R; i += kThreads) {
      b1s[i] = load_f32(a.b1, i);
      wrs[i] = load_f32(a.wr, (long)h * R + i);
    }
  }
  const float br = has_rel ? load_f32(a.br, h) : 0.f;

  for (int row0 = 0; row0 < Lq; row0 += kRows) {
    const int rows = min(kRows, Lq - row0);
    __syncthreads();  // the loads above, or the previous chunk's readers, are done
    const T* qp = a.q + (bh * Lq + row0) * D;
    const T* dop = a.dout + (bh * Lq + row0) * D;
    for (int i = tid; i < rows * D; i += kThreads) {
      qs[i] = load_f32(qp, i);
      dos[i] = load_f32(dop, i);
    }
    __syncthreads();

    // scores, as in the forward kernel
    for (int i = tid; i < rows * Lk; i += kThreads) {
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
        const float pre = relation_pre(rp, Rr, R, w1s, b1s, wrs, br);
        pres[i] = pre;
        s += logf(fmaxf(pre, kClamp));
      }
      if (a.mask != nullptr && a.mask[(long)b * Lk + j]) s += kMaskAdd;
      as[i] = s;
    }
    __syncthreads();

    // a = softmax(s) in fp32, one warp per row
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* sr = as + r * Lk;
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
      for (int j = lane; j < Lk; j += 32) sr[j] = sr[j] / sum;
    }
    __syncthreads();

    // da = (do v^T) * keep / (1 - r); the dropped-out a for dv
    for (int i = tid; i < rows * Lk; i += kThreads) {
      const int r = i / Lk, j = i - r * Lk;
      const float* dor = dos + r * D;
      const float* vj = vs + j * ldk;
      float da = 0.f;
      for (int d = 0; d < D; ++d) da = fmaf(dor[d], vj[d], da);
      float ad = as[i];
      if (has_drop) {
        const float kf = a.keep[(bh * Lq + row0 + r) * Lk + j] ? 1.f : 0.f;
        da = (da * kf) / a.keep_p;
        ad = (ad * kf) / a.keep_p;
      }
      dss[i] = da;
      ads[i] = round_to(ad, a.q);
    }
    __syncthreads();

    // ds = a (da - rowsum(da a)), one warp per row; dbias and dpre leave here
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float* ar = as + r * Lk;
      float* dr = dss + r * Lk;
      float dot = 0.f;
      for (int j = lane; j < Lk; j += 32) dot = fmaf(dr[j], ar[j], dot);
      dot = warp_sum(dot);
      const long g0 = (bh * Lq + row0 + r) * Lk;
      for (int j = lane; j < Lk; j += 32) {
        const float ds = ar[j] * (dr[j] - dot);
        if (a.dbias != nullptr) store_f32(a.dbias, g0 + j, ds);
        if (a.dpre != nullptr) {
          const float pre = pres[r * Lk + j];
          a.dpre[g0 + j] = pre > kClamp ? ds / pre : 0.f;
        }
        dr[j] = round_to(ds, a.q);
      }
    }
    __syncthreads();

    // dv += ad^T do, dk += ds^T q (scaled at the end), one (j, d) per thread
    for (int i = tid; i < Lk * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      float accv = dvs[i], acck = dks[i];
      for (int r = 0; r < rows; ++r) {
        accv = fmaf(ads[r * Lk + j], dos[r * D + d], accv);
        acck = fmaf(dss[r * Lk + j], qs[r * D + d], acck);
      }
      dvs[i] = accv;
      dks[i] = acck;
    }
    // dq = ds k * scale, one (row, d) per thread
    T* dqp = a.dq + (bh * Lq + row0) * D;
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* dr = dss + r * Lk;
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(dr[j], ks[j * ldk + d], acc);
      store_f32(dqp, i, acc * a.scale);
    }
  }
  __syncthreads();

  T* dkp = a.dk + bh * Lk * D;
  T* dvp = a.dv + bh * Lk * D;
  for (int i = tid; i < Lk * D; i += kThreads) {
    store_f32(dkp, i, dks[i] * a.scale);
    store_f32(dvp, i, dvs[i]);
  }
}

// ---------------------------------------------------------------------------
// kernel 2: the relation pass
// ---------------------------------------------------------------------------

template <typename T>
struct RelArgs {
  const T* raw;        // [B, Lq, Lk, Rr]
  const T* w1;         // [R, Rr]
  const T* b1;         // [R]
  const T* wr;         // [H, R]
  const float* dpre;   // [B, H, Lq, Lk]
  float* dw1;          // [B, chunks, R, Rr] partials
  float* db1;          // [B, chunks, R]
  float* dwr;          // [B, chunks, H, R]
  float* dbr;          // [B, chunks, H]
  float* draw;         // [B, Lq, Lk, Rr] or null
  int H, Lq, Lk, Rr, R;
  int rows;            // query rows per block
};

size_t rel_smem_floats(int rows, int Lk, int H, int Rr, int R) {
  const size_t E = (size_t)rows * Lk;
  return E * (Rr + H) + (size_t)R * Rr + R + (size_t)H * R;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_attention_bwd_rel_kernel(const RelArgs<T> a) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, chunks = gridDim.x;
  const int H = a.H, Lq = a.Lq, Lk = a.Lk, Rr = a.Rr, R = a.R;
  const int row0 = chunk * a.rows;
  const int E = min(a.rows, Lq - row0) * Lk;  // (i, j) elements of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int ldE = a.rows * Lk;
  float* raws = smem;               // [Rr][ldE]
  float* dps = raws + Rr * ldE;     // [H][ldE]
  float* w1s = dps + H * ldE;       // [R][Rr]
  float* b1s = w1s + R * Rr;        // [R]
  float* wrs = b1s + R;             // [H][R]

  const long e0 = (long)b * Lq * Lk + (long)row0 * Lk;  // first element, [B, Lq, Lk] order
  for (int i = tid; i < E * Rr; i += kThreads) {
    const int e = i / Rr, c = i - e * Rr;
    raws[c * ldE + e] = load_f32(a.raw, e0 * Rr + i);
  }
  for (int i = tid; i < H * E; i += kThreads) {
    const int hh = i / E, e = i - hh * E;
    dps[hh * ldE + e] = a.dpre[((long)b * H + hh) * Lq * Lk + (long)row0 * Lk + e];
  }
  for (int i = tid; i < R * Rr; i += kThreads) w1s[i] = load_f32(a.w1, i);
  for (int i = tid; i < R; i += kThreads) b1s[i] = load_f32(a.b1, i);
  for (int i = tid; i < H * R; i += kThreads) wrs[i] = load_f32(a.wr, i);
  __syncthreads();

  const long part = (long)b * chunks + chunk;
  // one feature r per warp at a time; lanes walk the elements
  for (int r = warp; r < R; r += kThreads / 32) {
    float w1r[kMaxRr], wrr[kMaxH];
#pragma unroll
    for (int c = 0; c < kMaxRr; ++c) w1r[c] = c < Rr ? w1s[r * Rr + c] : 0.f;
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) wrr[hh] = hh < H ? wrs[hh * R + r] : 0.f;
    const float b1r = b1s[r];
    float acc_db1 = 0.f, acc_dw1[kMaxRr], acc_dwr[kMaxH];
#pragma unroll
    for (int c = 0; c < kMaxRr; ++c) acc_dw1[c] = 0.f;
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh) acc_dwr[hh] = 0.f;
    for (int e = lane; e < E; e += 32) {
      float u = b1r;
#pragma unroll
      for (int c = 0; c < kMaxRr; ++c)
        if (c < Rr) u = fmaf(raws[c * ldE + e], w1r[c], u);
      if (u > 0.f) {  // t = relu(u) > 0
        float du = 0.f;
#pragma unroll
        for (int hh = 0; hh < kMaxH; ++hh)
          if (hh < H) {
            const float dp = dps[hh * ldE + e];
            du = fmaf(dp, wrr[hh], du);
            acc_dwr[hh] = fmaf(u, dp, acc_dwr[hh]);
          }
        acc_db1 += du;
#pragma unroll
        for (int c = 0; c < kMaxRr; ++c)
          if (c < Rr) acc_dw1[c] = fmaf(du, raws[c * ldE + e], acc_dw1[c]);
      }
    }
    acc_db1 = warp_sum(acc_db1);
#pragma unroll
    for (int c = 0; c < kMaxRr; ++c)
      if (c < Rr) acc_dw1[c] = warp_sum(acc_dw1[c]);
#pragma unroll
    for (int hh = 0; hh < kMaxH; ++hh)
      if (hh < H) acc_dwr[hh] = warp_sum(acc_dwr[hh]);
    if (lane == 0) {
      a.db1[part * R + r] = acc_db1;
#pragma unroll
      for (int c = 0; c < kMaxRr; ++c)
        if (c < Rr) a.dw1[(part * R + r) * Rr + c] = acc_dw1[c];
#pragma unroll
      for (int hh = 0; hh < kMaxH; ++hh)
        if (hh < H) a.dwr[(part * H + hh) * R + r] = acc_dwr[hh];
    }
  }
  // dbr: one head per warp at a time
  for (int hh = warp; hh < H; hh += kThreads / 32) {
    float acc = 0.f;
    for (int e = lane; e < E; e += 32) acc += dps[hh * ldE + e];
    acc = warp_sum(acc);
    if (lane == 0) a.dbr[part * H + hh] = acc;
  }
  // draw = du W1, one element per thread (du recomputed feature by feature)
  if (a.draw != nullptr) {
    for (int e = tid; e < E; e += kThreads) {
      float x[kMaxRr], acc[kMaxRr];
#pragma unroll
      for (int c = 0; c < kMaxRr; ++c) {
        x[c] = c < Rr ? raws[c * ldE + e] : 0.f;
        acc[c] = 0.f;
      }
      for (int r = 0; r < R; ++r) {
        float u = b1s[r];
#pragma unroll
        for (int c = 0; c < kMaxRr; ++c)
          if (c < Rr) u = fmaf(x[c], w1s[r * Rr + c], u);
        if (u > 0.f) {
          float du = 0.f;
          for (int hh = 0; hh < H; ++hh) du = fmaf(dps[hh * ldE + e], wrs[hh * R + r], du);
#pragma unroll
          for (int c = 0; c < kMaxRr; ++c)
            if (c < Rr) acc[c] = fmaf(du, w1s[r * Rr + c], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxRr; ++c)
        if (c < Rr) a.draw[(e0 + e) * Rr + c] = acc[c];
    }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, const void* raw, const void* w1, const void* b1,
                       const void* wr, const void* br, const void* keep, const void* dout,
                       void* dq, void* dk, void* dv, void* dbias, void* dpre, int B, int H,
                       int Lq, int Lk, int D, int Rr, int R, float scale, float keep_p,
                       cudaStream_t stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1) return cudaErrorInvalidValue;
  if (raw != nullptr && (Rr < 1 || Rr > kMaxRr || R < 1)) return cudaErrorInvalidValue;
  if (raw == nullptr && dpre != nullptr) return cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr)) return cudaErrorInvalidValue;
  if (keep != nullptr && !(keep_p > 0.f && keep_p <= 1.f)) return cudaErrorInvalidValue;
  BwdArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
               static_cast<const T*>(bias), static_cast<const unsigned char*>(mask),
               static_cast<const T*>(raw), static_cast<const T*>(w1),
               static_cast<const T*>(b1), static_cast<const T*>(wr),
               static_cast<const T*>(br), static_cast<const unsigned char*>(keep),
               static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
               static_cast<T*>(dv), static_cast<T*>(dbias), static_cast<float*>(dpre),
               H, Lq, Lk, D, Rr, R, scale, keep_p};
  const size_t bytes = bwd_smem_floats(Lk, D, Rr, R, raw != nullptr) * sizeof(float);
  cudaError_t err = opt_in(fused_attention_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  fused_attention_bwd_kernel<T><<<dim3(H, B), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rel(const void* raw, const void* w1, const void* b1, const void* wr,
                       const void* dpre, void* dw1, void* db1, void* dwr, void* dbr,
                       void* draw, int B, int H, int Lq, int Lk, int Rr, int R, int rows,
                       cudaStream_t stream) {
  if (B < 1 || H < 1 || H > kMaxH || Lq < 1 || Lk < 1 || Rr < 1 || Rr > kMaxRr || R < 1 ||
      rows < 1)
    return cudaErrorInvalidValue;
  RelArgs<T> a{static_cast<const T*>(raw), static_cast<const T*>(w1),
               static_cast<const T*>(b1), static_cast<const T*>(wr),
               static_cast<const float*>(dpre), static_cast<float*>(dw1),
               static_cast<float*>(db1), static_cast<float*>(dwr), static_cast<float*>(dbr),
               static_cast<float*>(draw), H, Lq, Lk, Rr, R, rows};
  const size_t bytes = rel_smem_floats(rows, Lk, H, Rr, R) * sizeof(float);
  cudaError_t err = opt_in(fused_attention_bwd_rel_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + rows - 1) / rows, B);
  fused_attention_bwd_rel_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Null pointers mark absent operands:
// bias with dbias, mask, raw with w1/b1/wr/br, keep (no dropout; else
// keep_p = 1 - r), and dpre (with raw: null when no relation gradient is
// needed, and the store is skipped). Returns the CUDA error code of the launch (0 = launched);
// the kernel runs on `stream`.
extern "C" int mmnas_fused_attention_bwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* bias, const void* mask,
                                         const void* raw, const void* w1, const void* b1,
                                         const void* wr, const void* br, const void* keep,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* dbias, void* dpre, int B, int H, int Lq,
                                         int Lk, int D, int Rr, int R, float scale,
                                         float keep_p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, bias, mask, raw, w1, b1, wr, br, keep, dout, dq, dk,
                             dv, dbias, dpre, B, H, Lq, Lk, D, Rr, R, scale, keep_p, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, bias, mask, raw, w1, b1, wr, br, keep, dout,
                                     dq, dk, dv, dbias, dpre, B, H, Lq, Lk, D, Rr, R, scale,
                                     keep_p, s);
  return cudaErrorInvalidValue;
}

// The relation pass: raw/w1/b1/wr in the operand type (dtype as above),
// dpre and every output fp32; one block per (batch, `rows` query rows), so
// the partials are [B, ceil(Lq / rows), ...]; draw may be null.
extern "C" int mmnas_fused_attention_bwd_rel(int dtype, const void* raw, const void* w1,
                                             const void* b1, const void* wr,
                                             const void* dpre, void* dw1, void* db1,
                                             void* dwr, void* dbr, void* draw, int B, int H,
                                             int Lq, int Lk, int Rr, int R, int rows,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rel<float>(raw, w1, b1, wr, dpre, dw1, db1, dwr, dbr, draw, B, H, Lq, Lk,
                             Rr, R, rows, s);
  if (dtype == 1)
    return launch_rel<__nv_bfloat16>(raw, w1, b1, wr, dpre, dw1, db1, dwr, dbr, draw, B, H,
                                     Lq, Lk, Rr, R, rows, s);
  return cudaErrorInvalidValue;
}
