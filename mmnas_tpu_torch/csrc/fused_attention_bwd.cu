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
//    Where those tiles do not fit in 227 KB (D 256; D 128 in fp32 at Lq =
//    Lk = 100; 114 keys at D 64 in fp32), fused_attention_bwd_sliced_kernel
//    runs the same phases with the head's D columns in windows of 64, 32 or
//    16: phase A sums q k^T and do v^T window by window in registers (a
//    warp per row tile, so Lq up to 128), then dq, dv and dk are computed
//    and stored window by window.
//
//    bf16: all five products on tensor cores (mma.m16n8k16 from ldmatrix
//    fragments, the transposed operands of dq, dv and dk by ldmatrix.trans,
//    ds re-packed in registers for dq); fp32: register-tiled FMAs on the
//    CUDA cores (TF32 stays off), as in the forward kernel. The softmax's
//    sum and rowsum(da * a) run in the order of PyTorch's softmax kernels
//    (lane_order_sums), so ds rounds as the plain version's does.
//
// 2. fused_attention_bwd_rel_kernel, the relation pass. For the cotangent
//    dpre of pre = relu(raw W1^T + b1) Wr^T + br it computes, per element
//    e = (b, i, j),
//
//      t[e,r]   = relu(raw[e,:] . W1[r,:] + b1[r])
//      du[e,r]  = [t[e,r] > 0] * sum_h dpre[h,e] Wr[h,r]
//      dW1[r,c] = sum_e du[e,r] raw[e,c]      db1[r] = sum_e du[e,r]
//      dWr[h,r] = sum_e t[e,r] dpre[h,e]      dbr[h] = sum_e dpre[h,e]
//
//    A block owns 64 features (a third grid axis walks R in 64s) and one
//    run of the Lq * Lk elements of a batch row: the wrapper picks the
//    runs per row so that the grid fills the card once
//    (mmnas_fused_attention_bwd_rel_chunks), so a run is thousands of
//    elements and no length is refused. More than 16 heads run as groups of
//    16, a block per group (kGrouped), each writing its own partial rows.
//    A thread owns F features (F 4, or
//    2 at 16 heads) with their W1 rows, b1 and Wr columns in registers, and
//    per element loads raw[e, :Rr] and dpre[:H, e] from shared memory once
//    for all F: Rr + H + 1 shared loads for F (2 Rr + 2 H + 2) FMAs and
//    selects. The live mask [t > 0] is a select, not a branch. Its
//    accumulators (dW1, dWr in fp32; db1, dbr in fp32 over a 256-element
//    tile, then in fp64, as these sums cancel) stay in registers for the
//    whole run; raw and dpre tiles arrive by 16-byte cp.async into two
//    buffers, the next tile in flight while the block computes this one.
//    The block then reduces once (shuffles, shared memory, warps in order)
//    to one partial row, and fused_attention_bwd_rel_reduce_kernel sums the
//    rows in a fixed order into dW1, db1, dWr, dbr in the operand type: no
//    atomics, the same bits every run. draw (asked for by no VQA path: raw
//    is data) is fused_attention_bwd_rel_draw_kernel, a thread per element.
//    The TPU kernel carried du across the head programs of a batch row in
//    VMEM (du_scr, :341-343, :426-432); blocks on this card run in no order,
//    so the head sum is this second pass, which gets dpre from device memory
//    ([B, H, Lq, Lk] fp32, written by kernel 1).
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
// is bound by its FMAs (49 us at 67 TFLOP/s) and the same occupancy. Kernel 2
// must read raw and dpre once (at B 64, H 8, (100, 100): 20.5 MB of dpre
// and 10 MB of raw in fp32, 9.2 us) and do R Rr FMAs per element plus
// (2 H + Rr) R FMAs and R adds on the live features (about half): 1.2 GFLOP at 67
// TFLOP/s, 17 us, so it is bound by operations; branch-free it does the
// dead features' work too (2.0 GFLOP, 31 us), which costs less than a
// divergent branch per lane. Its threads hold 157 to 255 registers (214 at
// Rr 4, H 8 in fp32; none spilled), one block of 8 warps an SM, so its
// FMAs rely on the ILP of F independent features and, at 8 or more heads,
// two elements at a time.
//
// Shared memory is dynamic: at Lq = Lk = 100, D 64 about 118 KB in bf16
// (q, k, v, do, and the two probability tiles) and 225 KB in fp32, opted in
// per launch. Limits (cudaErrorInvalidValue past them): D a multiple of 16
// up to 256, Lk up to 128, Lq up to 128 where the sliced kernel runs,
// shared memory within 227 KB; the relation pass takes up to 32 heads.

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemCap = 232448;  // 227 KB, a block's most dynamic shared memory
constexpr int kMaxD = 256;        // the widest head

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

// the scores of rows [row0, row0 + 16) of (b, h) from q k^T in p, and their
// softmax, in place, as the forward kernel computes them
template <typename T, int KTM>
__device__ __forceinline__ void grad_softmax(const BwdArgs<T>& a, int b, int h, int row0,
                                             float (&p)[2 * KTM][4]) {
  const int Lq = a.Lq, Lk = a.Lk, KT = (Lk + 15) / 16;
  const long rows_at = (((long)b * a.H + h) * Lq + row0) * Lk;
  ScoreTerms<T> st{a.bias == nullptr ? nullptr : a.bias + rows_at,
                   a.pre == nullptr ? nullptr : a.pre + rows_at, Lk,
                   a.mask == nullptr ? nullptr : a.mask + (long)b * Lk,
                   Lq - row0, Lk, a.scale};
  tile_scores_epilogue<T, KTM>(p, st, KT);
  tile_softmax<KTM>(p, KT);
}

// the rest of phase A for rows [row0, row0 + 16) of (b, h), from the
// probabilities p and da = do v^T: the dropped-out a and ds to shared
// memory (pds, dss), dbias and dpre out; da ends as ds
template <typename T, int KTM>
__device__ __forceinline__ void grad_ds(const BwdArgs<T>& a, int b, int h, int row0,
                                        float (&p)[2 * KTM][4], float (&da)[2 * KTM][4],
                                        T* pds, T* dss, int ldp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int Lq = a.Lq, Lk = a.Lk, KT = (Lk + 15) / 16;
  const long bh = (long)b * a.H + h;
  const long rows_at = (bh * Lq + row0) * Lk;  // element (row0, 0) of [Lq, Lk] planes
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
}

// phase A for rows [row0, row0 + 16) of (b, h)
template <typename T, int DM, int KTM>
__device__ __forceinline__ void grad_rows(const BwdArgs<T>& a, int b, int h, int row0,
                                          const T* qs, const T* ks, const T* vs, const T* dos,
                                          int ld, T* pds, T* dss, int ldp) {
  const int KT = (a.Lk + 15) / 16;
  const long bh = (long)b * a.H + h;
  float p[2 * KTM][4], da[2 * KTM][4];
  tile_abt<KTM>(p, qs + row0 * ld, StagedChunks<T>{ks, ld}, ld, a.D, KT);
  grad_softmax<T, KTM>(a, b, h, row0, p);
  tile_abt<KTM>(da, dos + row0 * ld, StagedChunks<T>{vs, ld}, ld, a.D, KT);
  grad_ds<T, KTM>(a, b, h, row0, p, da, pds, dss, ldp);
  float o[DM / 2];
  tile_px<DM, KTM>(o, da, StagedChunks<T>{ks, ld}, ld, a.D, KT);
  store_tile<DM>(o, a.dq + bh * a.Lq * a.D, row0, a.Lq, a.D, a.scale);
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

// Kernel 1 where q, k, v, do and the two probability tiles do not fit in
// shared memory together (D 128 in fp32 at Lq = Lk = 100, D 256, or 114
// keys at D 64 in fp32): the head's D columns are walked in windows of DS
// (64, 32 or 16, the widest that fits). A block per (b, h), a warp per
// 16-row tile (Lq up to 128). Phase A accumulates q k^T and do v^T window by
// window into the warp's registers, then runs grad_softmax and grad_ds as
// the staged kernel does; then, per window, dq from ds and that window of K,
// and phase B's dv and dk for that window of their columns.
template <typename T, int KTM>
__global__ void __launch_bounds__(kThreads) fused_attention_bwd_sliced_kernel(const BwdArgs<T> a,
                                                                              int DS) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x / 32;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D;
  const int LqP = (Lq + 15) / 16 * 16, LkP = (Lk + 15) / 16 * 16, KT = LkP / 16;
  const int ldp = LkP + Pad<T>::value, lds = DS + Pad<T>::value;
  T* pds = reinterpret_cast<T*>(smem);  // [LqP][ldp] dropped-out a, operand type
  T* dss = pds + LqP * ldp;             // [LqP][ldp] ds, operand type
  T* ks = dss + LqP * ldp;              // [LkP][lds], a window of K's columns
  T* vs = ks + LkP * lds;               // [LkP][lds]
  T* qs = vs + LkP * lds;               // [LqP][lds]
  T* dos = qs + LqP * lds;              // [LqP][lds]
  const long bh = (long)b * a.H + h;
  const T* kb = a.k + bh * Lk * D;
  const T* vb = a.v + bh * Lk * D;
  const T* qb = a.q + bh * Lq * D;
  const T* dob = a.dout + bh * Lq * D;
  const int row0 = 16 * warp;
  const bool live = row0 < LqP;

  float p[2 * KTM][4], da[2 * KTM][4];
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[n][e] = da[n][e] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += DS) {
    __syncthreads();  // every warp is done with the last window
    stage_cols(ks, lds, kb + c0, D, Lk, LkP, DS);
    stage_cols(vs, lds, vb + c0, D, Lk, LkP, DS);
    stage_cols(qs, lds, qb + c0, D, Lq, LqP, DS);
    stage_cols(dos, lds, dob + c0, D, Lq, LqP, DS);
    cp_async_wait_all();
    __syncthreads();
    if (live) {
      tile_abt<KTM, true>(p, qs + row0 * lds, StagedChunks<T>{ks, lds}, lds, DS, KT);
      tile_abt<KTM, true>(da, dos + row0 * lds, StagedChunks<T>{vs, lds}, lds, DS, KT);
    }
  }
  if (live) {
    grad_softmax<T, KTM>(a, b, h, row0, p);
    grad_ds<T, KTM>(a, b, h, row0, p, da, pds, dss, ldp);
  }

#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += DS) {
    __syncthreads();  // pds, dss written; every warp is done with the last window
    stage_cols(ks, lds, kb + c0, D, Lk, LkP, DS);
    stage_cols(qs, lds, qb + c0, D, Lq, LqP, DS);
    stage_cols(dos, lds, dob + c0, D, Lq, LqP, DS);
    cp_async_wait_all();
    __syncthreads();
    float o[32];
    if (live) {
      tile_px<64, KTM>(o, da, StagedChunks<T>{ks, lds}, lds, DS, KT);
      store_tile_cols<64>(o, a.dq + bh * Lq * D + c0, row0, Lq, DS, D, a.scale);
    }
    for (int kt = warp; kt < LkP / 16; kt += kWarps) {
      tile_ptx<64>(o, pds, ldp, 16 * kt, dos, lds, DS, LqP / 16);
      store_tile_cols<64>(o, a.dv + bh * Lk * D + c0, 16 * kt, Lk, DS, D, 1.f);
      tile_ptx<64>(o, dss, ldp, 16 * kt, qs, lds, DS, LqP / 16);
      store_tile_cols<64>(o, a.dk + bh * Lk * D + c0, 16 * kt, Lk, DS, D, a.scale);
    }
  }
}


// ---------------------------------------------------------------------------
// kernel 2: the relation pass
// ---------------------------------------------------------------------------

constexpr int kRelFeatures = 64;  // features a block owns
constexpr int kRelTile = 256;     // elements per staged tile
constexpr int kRelMinRun = 1024;  // fewest elements of a batch row a block takes, when it can

template <typename T>
struct RelArgs {
  const T* raw;       // [B, Lq, Lk, Rr]
  const T* w1;        // [R, Rr]
  const T* b1;        // [R]
  const T* wr;        // [H, R]
  const float* dpre;  // [B, H, Lq, Lk]
  float* pw;          // [B * chunks * groups][R * Rr + H * R] partials: dW1, then dWr
  double* pd;         // [B * chunks * groups][R + H] partials: db1, then dbr
  int H, N, Rr, R;    // N = Lq * Lk elements per batch row
  int chunks, run;    // runs per batch row, elements per run (a multiple of 16)
  int vec;            // dpre's head rows start on 16-byte boundaries
  int groups;         // head groups of kMaxH heads; a partial row per (b, run, group)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// A stage buffer: the raw window (rel_raw_bytes), then dpre [H][kRelTile] fp32.
__host__ __device__ __forceinline__ int rel_raw_bytes(int Rr, int elem) {
  return (kRelTile * Rr * elem + 32 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int rel_stage_bytes(int Rr, int H, int elem) {
  return rel_raw_bytes(Rr, elem) + H * kRelTile * 4;
}

// The first byte of raw element e0 of batch row b, as the window stages it.
template <typename T>
__device__ __forceinline__ const char* rel_raw_at(const RelArgs<T>& a, int b, int e0) {
  return reinterpret_cast<const char*>(a.raw + ((long)b * a.N + e0) * a.Rr);
}

// Start the copies of elements [e0, e0 + n) of batch row b into `buf`, by
// the block's threads. raw: the 16-byte-aligned window around its n Rr
// channels, so any Rr and any alignment copy by 16 bytes; the element
// lands at byte (address % 16) of the buffer. The window's ends read at
// most 15 bytes before or past the tensor, inside a 16-byte-aligned chunk
// that holds one of its bytes (so never on another page), and nothing
// uses them.
// dpre: the n values of each head h0 .. h0 + Hg - 1, by 16 bytes when its
// rows are aligned (N % 4 == 0, e0 % 16 == 0), else by 4.
template <typename T>
__device__ __forceinline__ void rel_stage(const RelArgs<T>& a, int b, int h0, int Hg, int e0,
                                          int n, char* buf) {
  const uintptr_t src = reinterpret_cast<uintptr_t>(rel_raw_at(a, b, e0));
  const uintptr_t lo = src & ~(uintptr_t)15;
  const uintptr_t hi = (src + (uintptr_t)n * a.Rr * sizeof(T) + 15) & ~(uintptr_t)15;
  const int chunks = (int)((hi - lo) / 16);
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(buf + 16 * c, reinterpret_cast<const void*>(lo + 16 * c));
  float* dps = reinterpret_cast<float*>(buf + rel_raw_bytes(a.Rr, sizeof(T)));
  const float* d0 = a.dpre + ((long)b * a.H + h0) * a.N + e0;
  if (a.vec) {
    constexpr int per = kRelTile / 4;
    const int m = (n + 3) / 4;
    for (int c = threadIdx.x; c < Hg * per; c += kThreads) {
      const int h = c / per, k = c % per;  // per is a power of two
      if (k < m) cp_async16(dps + h * kRelTile + 4 * k, d0 + (long)h * a.N + 4 * k);
    }
  } else {
    for (int c = threadIdx.x; c < Hg * kRelTile; c += kThreads) {
      const int h = c / kRelTile, k = c % kRelTile;
      if (k < n) cp_async4(dps + h * kRelTile + k, d0 + (long)h * a.N + k);
    }
  }
}

template <int RM, int HM, int F>
struct RelShape {
  static constexpr int G = kRelFeatures / F;  // feature groups, one per lane of a group
  static constexpr int S = 32 / G;            // element slots of a warp
  static constexpr int EL = kWarps * S;       // elements the block takes at a time
  static constexpr int NF = F * (RM + HM);    // fp32 accumulators a thread holds
  static constexpr int ND = F + 1;            // fp64 accumulators a thread holds
  // the block's reduction in shared memory: [kWarps][G][ND] fp64, [kWarps][G][NF] fp32
  static constexpr int reduce_bytes = kWarps * G * (ND * 8 + NF * 4);
};

// kGrouped: more than kMaxH heads, in groups of kMaxH (the third grid axis
// walks feature blocks, then groups); without it the block takes every head.
template <typename T, int RM, int HM, int F, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_rel_kernel(const RelArgs<T> a) {
  using S = RelShape<RM, HM, F>;
  // elements a thread takes at a time: two at 8 or more heads, for
  // independent FMA chains; one at 4, whose chains are short (measured)
  constexpr int kRelElems = HM >= 8 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int P = (a.R + kRelFeatures - 1) / kRelFeatures;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int fblk = kGrouped ? blockIdx.z % P : blockIdx.z, hg = kGrouped ? blockIdx.z / P : 0;
  const int h0 = hg * kMaxH, H = kGrouped ? min(kMaxH, a.H - h0) : a.H;  // the block's heads
  const int Rr = a.Rr, R = a.R;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int fg = lane % S::G, slot = warp * S::S + lane / S::G;
  const int e_begin = chunk * a.run, n_run = max(0, min(a.N - e_begin, a.run));
  const int r0 = kRelFeatures * fblk + F * fg;  // the thread's features r0 .. r0 + F - 1

  // the F features' weights; features past R get zeros, so t = 0 and du = 0
  float w1r[F][RM], wrr[F][HM], b1r[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const bool ok = r0 + f < R;
#pragma unroll
    for (int c = 0; c < RM; ++c)
      w1r[f][c] = ok && c < Rr ? load_f32(a.w1, (long)(r0 + f) * Rr + c) : 0.f;
#pragma unroll
    for (int h = 0; h < HM; ++h)
      wrr[f][h] = ok && h < H ? load_f32(a.wr, (long)(h0 + h) * R + r0 + f) : 0.f;
    b1r[f] = ok ? load_f32(a.b1, r0 + f) : 0.f;
  }
  float dw1[F][RM], dwr[F][HM], db1_tile[F], dbr_tile = 0.f;
  double db1[F], dbr = 0.0;
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int c = 0; c < RM; ++c) dw1[f][c] = 0.f;
#pragma unroll
    for (int h = 0; h < HM; ++h) dwr[f][h] = 0.f;
    db1_tile[f] = 0.f;
    db1[f] = 0.0;
  }
  const int hb = min(fg, H - 1);  // the head whose dbr this lane sums (kept when fg < H)

  char* bufs = reinterpret_cast<char*>(smem);
  const int stage = rel_stage_bytes(Rr, H, sizeof(T));
  const int raw_bytes = rel_raw_bytes(Rr, sizeof(T));
  const int tiles = (n_run + kRelTile - 1) / kRelTile;
  if (tiles > 0) rel_stage(a, b, h0, H, e_begin, min(kRelTile, n_run), bufs);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int e0 = e_begin + t * kRelTile, n = min(kRelTile, e_begin + n_run - e0);
    if (t + 1 < tiles)  // the next tile's copies run while this one computes
      rel_stage(a, b, h0, H, e0 + kRelTile, min(kRelTile, e_begin + n_run - e0 - kRelTile),
                bufs + ((t + 1) & 1) * stage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const char* buf = bufs + (t & 1) * stage;
    const T* rw = reinterpret_cast<const T*>(
        buf + (reinterpret_cast<uintptr_t>(rel_raw_at(a, b, e0)) & 15));
    const float* dps = reinterpret_cast<const float*>(buf + raw_bytes);
    // kRelElems elements an iteration; one past the tile's end enters as
    // zeros, which add nothing
    for (int e = slot; e < n; e += kRelElems * S::EL) {
      float x[kRelElems][RM], dp[kRelElems][HM];
#pragma unroll
      for (int k = 0; k < kRelElems; ++k) {
        const int ek = e + k * S::EL;
        const bool in = k == 0 || ek < n;
#pragma unroll
        for (int c = 0; c < RM; ++c) x[k][c] = in && c < Rr ? load_f32(rw, ek * Rr + c) : 0.f;
#pragma unroll
        for (int h = 0; h < HM; ++h) dp[k][h] = in && h < H ? dps[h * kRelTile + ek] : 0.f;
        dbr_tile += in ? dps[hb * kRelTile + ek] : 0.f;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
#pragma unroll
        for (int k = 0; k < kRelElems; ++k) {
          float u = b1r[f];
#pragma unroll
          for (int c = 0; c < RM; ++c) u = fmaf(x[k][c], w1r[f][c], u);
          const float tf = fmaxf(u, 0.f);
          float du = 0.f;
#pragma unroll
          for (int h = 0; h < HM; ++h) {
            du = fmaf(dp[k][h], wrr[f][h], du);
            dwr[f][h] = fmaf(tf, dp[k][h], dwr[f][h]);
          }
          du = u > 0.f ? du : 0.f;  // the live mask, a select
          db1_tile[f] += du;
#pragma unroll
          for (int c = 0; c < RM; ++c) dw1[f][c] = fmaf(du, x[k][c], dw1[f][c]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      db1[f] += (double)db1_tile[f];
      db1_tile[f] = 0.f;
    }
    dbr += (double)dbr_tile;
    dbr_tile = 0.f;
    __syncthreads();  // every thread is done with this buffer before tile t + 2 lands in it
  }
  cp_async_wait<0>();

  // the block's reduction: the warp's slots by shuffles, then the warps in
  // order through shared memory (the stage buffers are free now)
#pragma unroll
  for (int o = S::G; o < 32; o <<= 1) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int c = 0; c < RM; ++c) dw1[f][c] += __shfl_xor_sync(0xffffffffu, dw1[f][c], o);
#pragma unroll
      for (int h = 0; h < HM; ++h) dwr[f][h] += __shfl_xor_sync(0xffffffffu, dwr[f][h], o);
      db1[f] += __shfl_xor_sync(0xffffffffu, db1[f], o);
    }
    dbr += __shfl_xor_sync(0xffffffffu, dbr, o);
  }
  double* red_d = reinterpret_cast<double*>(smem);
  float* red_f = reinterpret_cast<float*>(red_d + kWarps * S::G * S::ND);
  if (lane < S::G) {
    double* d = red_d + (warp * S::G + fg) * S::ND;
    float* p = red_f + (warp * S::G + fg) * S::NF;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      d[f] = db1[f];
#pragma unroll
      for (int c = 0; c < RM; ++c) p[f * RM + c] = dw1[f][c];
#pragma unroll
      for (int h = 0; h < HM; ++h) p[F * RM + f * HM + h] = dwr[f][h];
    }
    d[F] = dbr;
  }
  __syncthreads();
  const long row = kGrouped ? ((long)b * a.chunks + chunk) * a.groups + hg
                            : (long)b * a.chunks + chunk;
  float* pw = a.pw + row * (R * Rr + a.H * R);
  double* pd = a.pd + row * (R + a.H);
  for (int i = threadIdx.x; i < S::G * S::NF; i += kThreads) {
    const int g = i / S::NF, k = i - g * S::NF;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_f[(w * S::G + g) * S::NF + k];
    const int base = kRelFeatures * fblk + F * g;
    if (k < F * RM) {
      const int r = base + k / RM, c = k % RM;
      if (r < R && c < Rr) pw[r * Rr + c] = s;
    } else {
      const int r = base + (k - F * RM) / HM, h = (k - F * RM) % HM;
      if (r < R && h < H) pw[R * Rr + (h0 + h) * R + r] = s;
    }
  }
  for (int i = threadIdx.x; i < S::G * S::ND; i += kThreads) {
    const int g = i / S::ND, k = i - g * S::ND;
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_d[(w * S::G + g) * S::ND + k];
    const int r = kRelFeatures * fblk + F * g + k;
    if (k < F) {
      if (r < R) pd[r] = s;
    } else if (fblk == 0 && g < H) {
      pd[R + h0 + g] = s;
    }
  }
}

// The partial rows summed in a fixed order, in fp64, into the operand type:
// a warp per output value, lane l summing rows l, l + 32, ... in order, then
// the lanes by a butterfly.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_rel_reduce_kernel(const float* pw, const double* pd, int rows, int R,
                                          int Rr, int H, T* dw1, T* db1, T* dwr, T* dbr) {
  const int nw = R * Rr + H * R, nd = R + H;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (i >= nw + nd) return;
  double s = 0.0;
  if (i < nw)
    for (int r = lane; r < rows; r += 32) s += pw[(long)r * nw + i];
  else
    for (int r = lane; r < rows; r += 32) s += pd[(long)r * nd + i - nw];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane != 0) return;
  if (i < R * Rr)
    store_f32(dw1, i, (float)s);
  else if (i < nw)
    store_f32(dwr, i - R * Rr, (float)s);
  else if (i < nw + R)
    store_f32(db1, i - nw, (float)s);
  else
    store_f32(dbr, i - nw - R, (float)s);
}

// draw[e, c] = sum_r du[e, r] W1[r, c], a thread per element of batch row
// blockIdx.y; the weights in shared memory: W1 [R][kMaxRr], Wr^T
// [R][kMaxHeads], b1 [R].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_rel_draw_kernel(const RelArgs<T> a, T* draw) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, Rr = a.Rr, R = a.R, b = blockIdx.y;
  float* w1s = smem;
  float* wrt = w1s + R * kMaxRr;
  float* b1s = wrt + R * kMaxHeads;
  for (int r = threadIdx.x; r < R; r += kThreads) {
#pragma unroll
    for (int c = 0; c < kMaxRr; ++c) w1s[r * kMaxRr + c] = c < Rr ? load_f32(a.w1, (long)r * Rr + c) : 0.f;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      wrt[r * kMaxHeads + h] = h < H ? load_f32(a.wr, (long)h * R + r) : 0.f;
    b1s[r] = load_f32(a.b1, r);
  }
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= a.N) return;
  const long at = (long)b * a.N + e;
  float x[kMaxRr], dp[kMaxHeads], acc[kMaxRr];
#pragma unroll
  for (int c = 0; c < kMaxRr; ++c) {
    x[c] = c < Rr ? load_f32(a.raw, at * Rr + c) : 0.f;
    acc[c] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) dp[h] = h < H ? a.dpre[((long)b * H + h) * a.N + e] : 0.f;
  for (int r = 0; r < R; ++r) {
    float u = b1s[r];
#pragma unroll
    for (int c = 0; c < kMaxRr; ++c) u = fmaf(x[c], w1s[r * kMaxRr + c], u);
    float du = 0.f;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) du = fmaf(dp[h], wrt[r * kMaxHeads + h], du);
    du = u > 0.f ? du : 0.f;
#pragma unroll
    for (int c = 0; c < kMaxRr; ++c) acc[c] = fmaf(du, w1s[r * kMaxRr + c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kMaxRr; ++c)
    if (c < Rr) store_f32(draw, at * Rr + c, acc[c]);
}


template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Shared memory of the sliced kernel for windows of DS columns.
template <typename T>
size_t sliced_bytes(int Lq, int Lk, int DS) {
  const size_t LqP = (Lq + 15) / 16 * 16, LkP = (Lk + 15) / 16 * 16;
  return (2 * LqP * (LkP + Pad<T>::value) + (2 * LkP + 2 * LqP) * (DS + Pad<T>::value)) *
         sizeof(T);
}

template <typename T, int KTM>
cudaError_t launch_bwd_sliced(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  if ((a.Lq + 15) / 16 > kWarps) return cudaErrorInvalidValue;  // a warp per row tile
  int DS = 0;
  for (int w = 64; w >= 16 && DS == 0; w /= 2)
    if (a.D % w == 0 && sliced_bytes<T>(a.Lq, a.Lk, w) <= (size_t)kSmemCap) DS = w;
  if (DS == 0) return cudaErrorInvalidValue;
  const size_t bytes = sliced_bytes<T>(a.Lq, a.Lk, DS);
  cudaError_t err = opt_in(fused_attention_bwd_sliced_kernel<T, KTM>, bytes);
  if (err != cudaSuccess) return err;
  fused_attention_bwd_sliced_kernel<T, KTM><<<dim3(a.H, B), kThreads, bytes, stream>>>(a, DS);
  return cudaGetLastError();
}

// The staged kernel where q, k, v, do and the probability tiles fit in
// shared memory (and D <= 128), else the sliced one.
template <typename T, int DM, int KTM>
cudaError_t launch_bwd_shape(const BwdArgs<T>& a, int B, cudaStream_t stream) {
  const int ld = a.D + Pad<T>::value;
  const int LqP = (a.Lq + 15) / 16 * 16, LkP = (a.Lk + 15) / 16 * 16;
  const size_t bytes =
      ((size_t)(2 * LkP + 2 * LqP) * ld + 2 * (size_t)LqP * (LkP + Pad<T>::value)) * sizeof(T);
  if (a.D > DM || bytes > (size_t)kSmemCap) return launch_bwd_sliced<T, KTM>(a, B, stream);
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
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 16 || D > kMaxD || D % 16 != 0)
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

template <typename T, int RM, int HM, int F>
size_t rel_smem(int Rr, int H) {
  return std::max<size_t>(2 * (size_t)rel_stage_bytes(Rr, H, sizeof(T)),
                          RelShape<RM, HM, F>::reduce_bytes);
}

// One instantiation per register shape: RM raw channels (4 or 8), HM heads
// (4, 8 or 16: a head group; more heads run as groups of 16) and F
// features a thread, fewer at 16 heads so they fit.
template <typename T, typename Fn>
cudaError_t rel_dispatch(int Rr, int H, Fn fn) {
  if (H > kMaxH) {  // groups of 16 heads
    if (Rr <= 4)
      return fn(fused_attention_bwd_rel_kernel<T, 4, 16, 2, true>, rel_smem<T, 4, 16, 2>(Rr, kMaxH));
    return fn(fused_attention_bwd_rel_kernel<T, 8, 16, 2, true>, rel_smem<T, 8, 16, 2>(Rr, kMaxH));
  }
  if (Rr <= 4) {
    if (H <= 4) return fn(fused_attention_bwd_rel_kernel<T, 4, 4, 4, false>, rel_smem<T, 4, 4, 4>(Rr, H));
    if (H <= 8) return fn(fused_attention_bwd_rel_kernel<T, 4, 8, 4, false>, rel_smem<T, 4, 8, 4>(Rr, H));
    return fn(fused_attention_bwd_rel_kernel<T, 4, 16, 2, false>, rel_smem<T, 4, 16, 2>(Rr, H));
  }
  if (H <= 4) return fn(fused_attention_bwd_rel_kernel<T, 8, 4, 4, false>, rel_smem<T, 8, 4, 4>(Rr, H));
  if (H <= 8) return fn(fused_attention_bwd_rel_kernel<T, 8, 8, 4, false>, rel_smem<T, 8, 8, 4>(Rr, H));
  return fn(fused_attention_bwd_rel_kernel<T, 8, 16, 2, false>, rel_smem<T, 8, 16, 2>(Rr, H));
}

bool rel_shape_ok(int B, int H, int Lq, int Lk, int Rr, int R) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= kMaxHeads && Lq >= 1 && Lk >= 1 && Rr >= 1 &&
         Rr <= kMaxRr && R >= 1 && (long)Lq * Lk <= (1L << 30) &&
         (R + kRelFeatures - 1) / kRelFeatures * ((H + kMaxH - 1) / kMaxH) <= 65535;
}

// Runs per batch row: enough blocks to fill every SM once at the kernel's
// occupancy, but no run under kRelMinRun elements unless the row is.
template <typename T>
int rel_chunks(int B, int H, int Lq, int Lk, int Rr, int R) {
  if (!rel_shape_ok(B, H, Lq, Lk, Rr, R)) return -(int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = rel_dispatch<T>(Rr, H, [&](auto kernel, size_t bytes) {
      cudaError_t e = opt_in(kernel, bytes);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    });
  if (err != cudaSuccess) return -(int)err;
  const long N = (long)Lq * Lk;
  const long P = (R + kRelFeatures - 1) / kRelFeatures * ((H + kMaxH - 1) / kMaxH);
  const long fill = std::max<long>(1, (long)sms * std::max(per_sm, 1) / (B * P));
  return (int)std::max<long>(1, std::min<long>(fill, (N + kRelMinRun - 1) / kRelMinRun));
}

template <typename T>
cudaError_t launch_rel(const void* raw, const void* w1, const void* b1, const void* wr,
                       const void* dpre, void* dw1, void* db1, void* dwr, void* dbr,
                       void* draw, void* work, int B, int H, int Lq, int Lk, int Rr, int R,
                       int chunks, cudaStream_t stream) {
  if (!rel_shape_ok(B, H, Lq, Lk, Rr, R) || chunks < 1) return cudaErrorInvalidValue;
  const int N = Lq * Lk;
  const int run = ((N + chunks - 1) / chunks + 15) / 16 * 16;
  const int groups = (H + kMaxH - 1) / kMaxH;
  const long rows = (long)B * chunks * groups;
  double* pd = static_cast<double*>(work);
  float* pw = reinterpret_cast<float*>(pd + rows * (R + H));
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(dpre) % 16 == 0;
  const RelArgs<T> a{static_cast<const T*>(raw), static_cast<const T*>(w1),
                     static_cast<const T*>(b1), static_cast<const T*>(wr),
                     static_cast<const float*>(dpre), pw, pd, H, N, Rr, R, chunks, run, vec,
                     groups};
  const dim3 grid(chunks, B, (R + kRelFeatures - 1) / kRelFeatures * groups);
  cudaError_t err = rel_dispatch<T>(Rr, H, [&](auto kernel, size_t bytes) {
    cudaError_t e = opt_in(kernel, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, bytes, stream>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const int outputs = R * Rr + H * R + R + H;
  fused_attention_bwd_rel_reduce_kernel<T><<<(outputs + kWarps - 1) / kWarps, kThreads, 0,
                                             stream>>>(
      pw, pd, (int)rows, R, Rr, H, static_cast<T*>(dw1), static_cast<T*>(db1),
      static_cast<T*>(dwr), static_cast<T*>(dbr));
  err = cudaGetLastError();
  if (err != cudaSuccess || draw == nullptr) return err;
  const size_t bytes = (size_t)R * (kMaxRr + kMaxHeads + 1) * sizeof(float);
  if (bytes > (size_t)kSmemCap) return cudaErrorInvalidValue;
  err = opt_in(fused_attention_bwd_rel_draw_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  fused_attention_bwd_rel_draw_kernel<T><<<dim3((N + kThreads - 1) / kThreads, B), kThreads,
                                           bytes, stream>>>(a, static_cast<T*>(draw));
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

// The relation pass: raw/w1/b1/wr and the outputs dw1, db1, dwr, dbr in
// the operand type (dtype as above), dpre fp32; draw (operand type) may be
// null. `work` holds the partial rows: B * chunks * ((R + H) * 8 + (R * Rr
// + H * R) * 4) bytes, from a 16-byte boundary; chunks as
// mmnas_fused_attention_bwd_rel_chunks returns it for the shape. Launches
// the pass, the fixed-order reduction and, with draw, its kernel.
extern "C" int mmnas_fused_attention_bwd_rel(int dtype, const void* raw, const void* w1,
                                             const void* b1, const void* wr,
                                             const void* dpre, void* dw1, void* db1,
                                             void* dwr, void* dbr, void* draw, void* work,
                                             int B, int H, int Lq, int Lk, int Rr, int R,
                                             int chunks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rel<float>(raw, w1, b1, wr, dpre, dw1, db1, dwr, dbr, draw, work, B, H, Lq,
                             Lk, Rr, R, chunks, s);
  if (dtype == 1)
    return launch_rel<__nv_bfloat16>(raw, w1, b1, wr, dpre, dw1, db1, dwr, dbr, draw, work, B,
                                     H, Lq, Lk, Rr, R, chunks, s);
  return cudaErrorInvalidValue;
}

// Runs per batch row that the relation pass takes for this shape on the
// current device (> 0), or minus a CUDA error code.
extern "C" int mmnas_fused_attention_bwd_rel_chunks(int dtype, int B, int H, int Lq, int Lk,
                                                    int Rr, int R) {
  if (dtype == 0) return rel_chunks<float>(B, H, Lq, Lk, Rr, R);
  if (dtype == 1) return rel_chunks<__nv_bfloat16>(B, H, Lq, Lk, Rr, R);
  return -(int)cudaErrorInvalidValue;
}
