// Fused SA / GA / RSA attention backward for Hopper (sm_90a).
//
// Replaces `_bwd_kernel` in mmnas_tpu/ops/pallas_attention.py (called by
// `_bwd_call`), as two kernels:
//
// 1. fused_attention_bwd_kernel, one block per (batch b, head h), 8 warps.
//    It stages q, k, v, do of the head in shared memory (16-byte cp.async,
//    lengths padded to multiples of 16 with zeros) and runs two phases
//    (pallas_attention.py:368-392):
//
//    A, over query tiles, a warp per 16 rows: it recomputes the scores s
//      (with the bias, the relation chain's pre read from the forward's
//      residual, the pad row) and a = softmax(s) in registers, exactly as
//      the forward kernel does, then
//        da    = (do v^T) * keep / (1 - r)      (keep = 1 without dropout)
//        ds    = a * (da - rowsum(da * a))      (a before dropout)
//        dq    = ds k * scale
//        dbias = ds                              (with an additive bias)
//        dpre  = ds * [pre > 1e-6] / pre          (with the relation chain,
//                                                 when the caller passes
//                                                 dpre: it needs the
//                                                 relation gradients)
//      dq, dbias and dpre leave from registers; the dropped-out a * keep /
//      (1 - r) and ds, rounded to the operand type as the TPU kernel casts
//      them (:376-382), go to shared memory.
//    B, over key tiles, a warp per 16 keys:
//        dv = (a * keep / (1 - r))^T do         dk = ds^T q * scale
//      each written once. No block shares a (b, h), so nothing is
//      accumulated across blocks: no atomics, the same bits every run.
//
//    bf16: all five products on tensor cores (mma.m16n8k16 from ldmatrix
//    fragments, the transposed operands of dq, dv and dk by ldmatrix.trans,
//    ds re-packed in registers for dq); fp32: register-tiled FMAs on the
//    CUDA cores (TF32 stays off), as in the forward kernel. The softmax's
//    sum and rowsum(da * a) run in the order of PyTorch's softmax kernels
//    (lane_order_sums), so ds rounds as the plain version's does.
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
// The relation chain is fp32 under bf16 operands. Kernel 1 does not rebuild
// it: the forward kernel computed pre once per (b, i, j) for all heads and
// wrote it out for the backward.
//
// What bounds them on this card. Kernel 1 reads q, k, v, do (and the keep
// mask, the bias, pre) once and writes dq, dk, dv (dbias, dpre) once; at
// (100, 100), B 64, H 8 its bytes take 14 us in bf16 and its five products
// 3.3 GFLOP (3.3 us on the tensor cores), so bf16 is bound by bytes and by
// latency: one block per (b, h) and one block per SM (its shared memory),
// 7 busy warps of 8 at Lq = Lk = 100, and the serial phases A and B. fp32
// is bound by its FMAs (49 us at 67 TFLOP/s) and the same occupancy. Kernel 2 moves dpre (20 MB at B 64, 8 heads, 100 x 100)
// through device memory and does about (2 Rr + 2 H + 1) FMAs per (i, j, r).
//
// Shared memory is dynamic: at Lq = Lk = 100, D 64 about 118 KB in bf16
// (q, k, v, do, and the two probability tiles) and 225 KB in fp32, opted in
// per launch. Limits (cudaErrorInvalidValue past them): D a multiple of 16
// up to 128, Lk up to 128, shared memory within 227 KB.

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemCap = 232448;  // 227 KB, a block's most dynamic shared memory

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
  const float* pre;           // [B, H, Lq, Lk] relation chain (forward residual), or null
  const unsigned char* keep;  // [B, H, Lq, Lk] dropout keep mask, or null
  const T* dout;              // [B, H, Lq, D]
  T* dq;                      // [B, H, Lq, D]
  T* dk;                      // [B, H, Lk, D]
  T* dv;                      // [B, H, Lk, D]
  T* dbias;                   // [B, H, Lq, Lk], null without bias
  float* dpre;                // [B, H, Lq, Lk] fp32, or null (no relation gradients)
  int H, Lq, Lk, D;
  float scale, keep_p;
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// phase A for rows [row0, row0 + 16) of (b, h)
template <typename T, int DM, int KTM>
__device__ __forceinline__ void grad_rows(const BwdArgs<T>& a, int b, int h, int row0,
                                          const T* qs, const T* ks, const T* vs, const T* dos,
                                          int ld, T* pds, T* dss, int ldp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int Lq = a.Lq, Lk = a.Lk, KT = (Lk + 15) / 16;
  const long bh = (long)b * a.H + h;
  const long rows_at = (bh * Lq + row0) * Lk;  // element (row0, 0) of [Lq, Lk] planes
  float p[2 * KTM][4], da[2 * KTM][4];
  tile_abt<KTM>(p, qs + row0 * ld, StagedChunks<T>{ks, ld}, ld, a.D, KT);
  ScoreTerms<T> st{a.bias == nullptr ? nullptr : a.bias + rows_at,
                   a.pre == nullptr ? nullptr : a.pre + rows_at, Lk,
                   a.mask == nullptr ? nullptr : a.mask + (long)b * Lk,
                   Lq - row0, Lk, a.scale};
  tile_scores_epilogue<T, KTM>(p, st, KT);
  tile_softmax<KTM>(p, KT);
  tile_abt<KTM>(da, dos + row0 * ld, StagedChunks<T>{vs, ld}, ld, a.D, KT);

#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
      float ad[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        const bool valid = row0 + r < Lq && j < Lk;
        if (!valid) p[n][e] = 0.f;  // pad rows add nothing to phase B's sums
        ad[e] = p[n][e];
        if (a.keep != nullptr) {
          const float kf = valid && a.keep[bh * Lq * Lk + (long)(row0 + r) * Lk + j] ? 1.f : 0.f;
          da[n][e] = (da[n][e] * kf) / a.keep_p;
          ad[e] = (ad[e] * kf) / a.keep_p;
        }
      }
      store_pair(pds + (row0 + g) * ldp + 8 * n + 2 * t, ad[0], ad[1]);
      store_pair(pds + (row0 + g + 8) * ldp + 8 * n + 2 * t, ad[2], ad[3]);
    }
  float dot[2];
  lane_order_sums<KTM, true>(da, p, KT, dot[0], dot[1]);  // rowsum(da * a)
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        const float ds = p[n][e] * (da[n][e] - dot[e >> 1]);
        da[n][e] = ds;
        if (row0 + r < Lq && j < Lk) {
          const long ij = rows_at + (long)r * Lk + j;
          if (a.dbias != nullptr) store_f32(a.dbias, ij, ds);
          if (a.dpre != nullptr) {
            const float pre = a.pre[ij];
            a.dpre[ij] = pre > kClamp ? ds / pre : 0.f;
          }
        }
      }
      store_pair(dss + (row0 + g) * ldp + 8 * n + 2 * t, da[n][0], da[n][1]);
      store_pair(dss + (row0 + g + 8) * ldp + 8 * n + 2 * t, da[n][2], da[n][3]);
    }
  float o[DM / 2];
  tile_px<DM, KTM>(o, da, StagedChunks<T>{ks, ld}, ld, a.D, KT);
  store_tile<DM>(o, a.dq + bh * Lq * a.D, row0, Lq, a.D, a.scale);
}

template <typename T, int DM, int KTM>
__global__ void __launch_bounds__(kThreads) fused_attention_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x / 32;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, ld = D + Pad<T>::value;
  const int LqP = (Lq + 15) / 16 * 16, LkP = (Lk + 15) / 16 * 16, ldp = LkP + Pad<T>::value;
  T* ks = reinterpret_cast<T*>(smem);   // [LkP][ld]
  T* vs = ks + LkP * ld;               // [LkP][ld]
  T* qs = vs + LkP * ld;               // [LqP][ld]
  T* dos = qs + LqP * ld;              // [LqP][ld]
  T* pds = dos + LqP * ld;             // [LqP][ldp] dropped-out a, operand type
  T* dss = pds + LqP * ldp;            // [LqP][ldp] ds, operand type

  const long bh = (long)b * a.H + h;
  stage_rows(ks, ld, a.k + bh * Lk * D, Lk, LkP, D);
  stage_rows(vs, ld, a.v + bh * Lk * D, Lk, LkP, D);
  stage_rows(qs, ld, a.q + bh * Lq * D, Lq, LqP, D);
  stage_rows(dos, ld, a.dout + bh * Lq * D, Lq, LqP, D);
  cp_async_wait_all();
  __syncthreads();

  for (int rt = warp; rt < LqP / 16; rt += kWarps)
    grad_rows<T, DM, KTM>(a, b, h, 16 * rt, qs, ks, vs, dos, ld, pds, dss, ldp);
  __syncthreads();

  for (int kt = warp; kt < LkP / 16; kt += kWarps) {
    float o[DM / 2];
    tile_ptx<DM>(o, pds, ldp, 16 * kt, dos, ld, D, LqP / 16);
    store_tile<DM>(o, a.dv + bh * Lk * D, 16 * kt, Lk, D, 1.f);
    tile_ptx<DM>(o, dss, ldp, 16 * kt, qs, ld, D, LqP / 16);
    store_tile<DM>(o, a.dk + bh * Lk * D, 16 * kt, Lk, D, a.scale);
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
  extern __shared__ __align__(16) float smem[];
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

template <typename T, int DM, int KTM>
cudaError_t launch_bwd_shape(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  const int ld = a.D + Pad<T>::value;
  const int LqP = (a.Lq + 15) / 16 * 16, LkP = (a.Lk + 15) / 16 * 16;
  const size_t bytes =
      ((size_t)(2 * LkP + 2 * LqP) * ld + 2 * (size_t)LqP * (LkP + Pad<T>::value)) * sizeof(T);
  if (bytes > (size_t)kSmemCap) return cudaErrorInvalidValue;
  cudaError_t err = opt_in(fused_attention_bwd_kernel<T, DM, KTM>, bytes);
  if (err != cudaSuccess) return err;
  fused_attention_bwd_kernel<T, DM, KTM><<<dim3(a.H, B), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t launch_bwd_d(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  const int KT = (a.Lk + 15) / 16;
  if (KT <= 1) return launch_bwd_shape<T, DM, 1>(a, B, stream);
  if (KT <= 8) return launch_bwd_shape<T, DM, 8>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, const void* pre, const void* keep, const void* dout,
                       void* dq, void* dk, void* dv, void* dbias, void* dpre, int B, int H,
                       int Lq, int Lk, int D, float scale, float keep_p,
                       cudaStream_t stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 16 || D > 128 || D % 16 != 0)
    return cudaErrorInvalidValue;
  if (pre == nullptr && dpre != nullptr) return cudaErrorInvalidValue;
  if ((bias == nullptr) != (dbias == nullptr)) return cudaErrorInvalidValue;
  if (keep != nullptr && !(keep_p > 0.f && keep_p <= 1.f)) return cudaErrorInvalidValue;
  const BwdArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(bias),
                     static_cast<const unsigned char*>(mask), static_cast<const float*>(pre),
                     static_cast<const unsigned char*>(keep), static_cast<const T*>(dout),
                     static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                     static_cast<T*>(dbias), static_cast<float*>(dpre),
                     H, Lq, Lk, D, scale, keep_p};
  return D <= 64 ? launch_bwd_d<T, 64>(a, B, stream) : launch_bwd_d<T, 128>(a, B, stream);
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
// bias with dbias, mask, pre (the forward's relation-chain residual; null
// without the chain), keep (no dropout; else keep_p = 1 - r), and dpre
// (with pre: null when no relation gradient is needed, and the store is
// skipped). Returns the CUDA error code of the launch (0 = launched;
// cudaErrorInvalidValue for a shape outside the limits above); the kernel
// runs on `stream`.
extern "C" int mmnas_fused_attention_bwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* bias, const void* mask,
                                         const void* pre, const void* keep, const void* dout,
                                         void* dq, void* dk, void* dv, void* dbias,
                                         void* dpre, int B, int H, int Lq, int Lk, int D,
                                         float scale, float keep_p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, bias, mask, pre, keep, dout, dq, dk, dv, dbias, dpre, B,
                             H, Lq, Lk, D, scale, keep_p, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, bias, mask, pre, keep, dout, dq, dk, dv, dbias,
                                     dpre, B, H, Lq, Lk, D, scale, keep_p, s);
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
