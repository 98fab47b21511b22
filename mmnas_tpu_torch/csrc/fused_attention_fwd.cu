// Fused SA / GA / RSA attention forward for Hopper (sm_90a).
//
// Replaces `_fwd_kernel` (with `_scores`, `_softmax`, `_rel_t_into` and
// `_rel_pre_into`) in mmnas_tpu/ops/pallas_attention.py, with and without
// attention dropout. Per (batch b, head h):
//
//   s   = q k^T * scale  (+ bias[b,h])  (+ log(max(pre, 1e-6)))  (- 1e9 where mask[b])
//   pre = sum_r relu(b1[r] + sum_c raw[b,i,j,c] * W1[r,c]) * Wr[h,r]  + br[h]
//   a   = softmax(s) in fp32
//   a   = a * keep / (1 - r)  with dropout, keep written to keep[b,h,i,j]
//   o   = a v, with a rounded to the operand type (a.astype(v.dtype)),
//         accumulated in fp32, stored in the operand type
//
// Design. A warp owns 16 query rows of one head (the m16 of
// mma.m16n8k16) and keeps their scores, probabilities and output in
// registers (attention_common.cuh): the [Lq, Lk] scores never touch
// shared or device memory. Keys are padded to a multiple of 16 with zeros
// (a padded key's score is -inf, its probability exactly 0) and walked in
// chunks of 16.
// - Without the relation chain (fused_attention_fwd_kernel) a block is one
//   (b, h) and up to 8 row tiles (all of Lq <= 128): K, V and q are staged
//   in shared memory once per (b, h) by 16-byte cp.async copies.
// - With it (fused_attention_fwd_rel_kernel) a block is one batch row b and
//   16 * (8 / H) query rows, for a group of up to 16 heads (32 heads run as
//   two groups, a grid axis each; the features are computed once per (b,
//   i, j) and group): it first computes pre for every head of the group
//   into shared memory (relation_pre_heads, each weight read serving four
//   elements), writing pre [B, H, Lq, Lk] fp32 out too when the backward
//   will need it; then a warp per (16 rows, head) streams that head's K and
//   V through its own kStages 16-key buffers (cp.async, kStages - 1 chunks
//   in flight while one is used), since the heads' K and V do not fit
//   beside pre.
// - Heads wider than 128 (up to 256): o would take D / 2 registers a
//   thread, so the output is computed and stored 128 columns at a time.
//   Without the chain (fused_attention_fwd_wide_kernel) a block of 4 warps
//   stages K and its q rows, keeps the probabilities in registers, then
//   stages V where K was; with it, the relation kernel walks V's chunks once
//   per 128-column window.
// - bf16: both products on tensor cores (ldmatrix fragments, fp32
//   accumulation, the probabilities re-packed from the C to the A layout in
//   registers). fp32: TF32 stays off, so the products are fp32 FMAs,
//   register-tiled: a thread holds 2 rows x 4 keys of each chunk and each
//   16-byte shared load serves 8 FMAs.
// - The softmax's sum runs in the order of PyTorch's softmax kernel (lanes
//   over keys j mod 32, then a butterfly), so the probabilities round as
//   the plain version's do.
// - Dropout: one Philox4x32-10 call, keyed by a 64-bit seed at counter
//   (j / 4, i, b*heads_total + head0 + h, 0), gives the bits of four keys
//   (word j mod 4). A tensor-parallel rank that runs heads [head0, head0 +
//   H) of heads_total draws the unsplit call's bits for its heads; head0 0
//   and heads_total H are the whole call's counter b*H + h. Each key is
//   kept when below keep_thr, as at pallas_attention.py:205-207. The two
//   threads that hold a row pair's keys j..j+3 each draw one row's call and
//   swap the halves by a shuffle. The mask is written as a uint8 residual.
//   The key is read from device memory (`seed` points at it), once per row
//   tile, so the caller draws it on the card from its generator and a CUDA
//   graph that captured the launch draws a new mask in each replay.
//
// What bounds it on this card. Per (b, h) it reads q, k, v once and writes
// o once; at (100, 100), B 64, H 8 that is 7.8 us of bytes in bf16 and the
// products 1.3 GFLOP (1.3 us on the tensor cores), so bf16 is bound by
// bytes and latency: the staging, the expf per score and the dropout's
// Philox rounds, with 7 warps per block and two blocks per SM. fp32 is
// bound by its FMAs (20 us at 67 TFLOP/s) and the shared loads that feed
// them. With the relation chain the chain's fp32 FMAs dominate (R (Rr + H)
// per (b, i, j): 768 at Rr 4, R 64, H 8), then the K and V reads, once per
// 16 rows and head from L2.
//
// Operands are fp32 or bf16 (T); the pad mask arrives as the caller's bool
// [B, Lk] row (true = pad) and adds -1e9 to a padded key's score, as the
// TPU kernel's additive mask row does, so a fully padded row stays uniform
// over its Lk keys. raw is read in its natural [B, Lq, Lk, Rr] layout, W1 is
// [R, Rr] and Wr is [H, R] (torch Linear layout). The chain stays fp32 even
// for bf16 operands: pre sits at the 1e-6 clamp and the log turns small
// errors into large bias errors. Limits (the launcher returns
// cudaErrorInvalidValue past them): D a multiple of 16 up to 256, Lk up to
// 208 (128 with the chain or past D 128), H up to 32 with the chain,
// shared memory within 227 KB.

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemCap = 232448;  // 227 KB, a block's most dynamic shared memory
constexpr int kChainE = 4;        // relation-chain elements per thread and pass
constexpr int kStages = 2;        // 16-key buffers a warp streams K and V through
constexpr int kWideWarps = 4;     // row tiles a block of the wide kernel takes
constexpr int kMaxD = 256;        // the widest head

template <typename T>
struct Args {
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
  T* out;                     // [B, H, Lq, D]
  unsigned char* keep;        // [B, H, Lq, Lk] keep mask out, or null (no dropout)
  float* pre;                 // [B, H, Lq, Lk] relation chain out, or null
  int H, Lq, Lk, D, Rr, R;
  int head0, heads_total;     // dropout: these H heads are [head0, head0 + H) of heads_total
  int tiles;                  // with the chain: 16-row tiles per block
  float scale;
  const unsigned long long* seed;  // dropout: the Philox key, in device memory
  unsigned int keep_thr;      // dropout: keep when bits < keep_thr
  float keep_p;               // dropout: 1 - r
};

// Philox4x32-10 (Salmon et al., SC'11): the four output words for counter
// (c0, c1, c2, 0) and key `seed`.
__device__ __forceinline__ uint4 philox(unsigned long long seed, unsigned int c0,
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
  return make_uint4(x0, x1, x2, x3);
}

// a *= keep / (1 - r) on the tile's probabilities, the keep mask drawn and
// written for rows < rows, keys < Lk
template <typename T, int KTM>
__device__ __forceinline__ void tile_dropout(float (&p)[2 * KTM][4], const Args<T>& a, long bh,
                                             int row0, int KT) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int Lq = a.Lq, Lk = a.Lk;
  const unsigned int mine = static_cast<unsigned int>(row0 + g + 8 * (t & 1));
  // the Philox counter's (b, h) word: head h of this call is head head0 + h
  // of heads_total
  const unsigned int ctr =
      static_cast<unsigned int>((bh / a.H) * a.heads_total + a.head0 + bh % a.H);
  const unsigned long long key = __ldg(a.seed);
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
      // keys 8n + 4 (t / 2) .. + 3 share one call; lane t & 1 draws row g + 8 (t & 1)
      const uint4 w = philox(key, static_cast<unsigned int>(2 * n + t / 2), mine, ctr);
      const unsigned int give0 = (t & 1) ? w.x : w.z, give1 = (t & 1) ? w.y : w.w;
      const unsigned int got0 = __shfl_xor_sync(0xffffffffu, give0, 1);
      const unsigned int got1 = __shfl_xor_sync(0xffffffffu, give1, 1);
      // bits of (row g, key 8n + 2t + c) and (row g + 8, key 8n + 2t + c)
      const unsigned int bits[4] = {(t & 1) ? got0 : w.x, (t & 1) ? got1 : w.y,
                                    (t & 1) ? w.z : got0, (t & 1) ? w.w : got1};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        const bool kept = bits[e] < a.keep_thr;
        if (i < Lq && j < Lk) a.keep[(bh * Lq + i) * Lk + j] = kept;
        p[n][e] = (p[n][e] * (kept ? 1.f : 0.f)) / a.keep_p;
      }
    }
}

// one warp: the attention of rows [row0, row0 + 16) of head h from its
// staged rows of q at qs (rows of ld) and the chunks of k and v; pre (rows
// of ldpre) with the relation chain. With kWide (D > DM) the output is
// computed and stored DM columns at a time, v's chunks walked once per
// window.
template <typename T, int DM, int KTM, bool kWide = false, typename Chunks>
__device__ __forceinline__ void attend_tile(const Args<T>& a, int b, int h, int row0,
                                            const T* qs, const Chunks& kc, const Chunks& vc,
                                            int ld, const float* pre, int ldpre) {
  const int KT = (a.Lk + 15) / 16;
  const long bh = (long)b * a.H + h;
  float s[2 * KTM][4];
  tile_abt<KTM>(s, qs, kc, ld, a.D, KT);
  ScoreTerms<T> st{a.bias == nullptr ? nullptr : a.bias + (bh * a.Lq + row0) * a.Lk,
                   pre, ldpre,
                   a.mask == nullptr ? nullptr : a.mask + (long)b * a.Lk,
                   a.Lq - row0, a.Lk, a.scale};
  tile_scores_epilogue<T, KTM>(s, st, KT);
  tile_softmax<KTM>(s, KT);
  if (a.keep != nullptr) tile_dropout<T, KTM>(s, a, bh, row0, KT);
  float o[DM / 2];
  if constexpr (kWide) {
#pragma unroll 1
    for (int c0 = 0; c0 < a.D; c0 += DM) {
      const int w = min(DM, a.D - c0);
      tile_px<DM, KTM>(o, s, ColumnShift<Chunks>{vc, c0}, ld, w, KT);
      store_tile_cols<DM>(o, a.out + bh * a.Lq * a.D + c0, row0, a.Lq, w, a.D, 1.f);
    }
  } else {
    tile_px<DM, KTM>(o, s, vc, ld, a.D, KT);
    store_tile<DM>(o, a.out + bh * a.Lq * a.D, row0, a.Lq, a.D, 1.f);
  }
}

// Without the relation chain: grid (row groups of kWarps tiles, H, B), a
// warp per 16-row tile, K and V staged once for the block's (b, h). Two
// blocks per SM: the register budget is 128 a thread.
template <typename T, int DM, int KTM>
__global__ void __launch_bounds__(kThreads, 2) fused_attention_fwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x / 32;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, ld = D + Pad<T>::value;
  const int LkP = (Lk + 15) / 16 * 16;
  const int row_base = blockIdx.x * kWarps * 16;
  const int tiles = blockDim.x / 32;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + LkP * ld;
  T* qs = vs + LkP * ld;  // [tiles * 16][ld]
  const long bh = (long)b * a.H + h;
  stage_rows(ks, ld, a.k + bh * Lk * D, Lk, LkP, D);
  stage_rows(vs, ld, a.v + bh * Lk * D, Lk, LkP, D);
  stage_rows(qs, ld, a.q + (bh * Lq + row_base) * D, Lq - row_base, tiles * 16, D);
  cp_async_wait_all();
  __syncthreads();
  const int row0 = row_base + 16 * warp;
  if (row0 < Lq)
    attend_tile<T, DM, KTM>(a, b, h, row0, qs + 16 * warp * ld, StagedChunks<T>{ks, ld},
                            StagedChunks<T>{vs, ld}, ld, nullptr, 0);
}

// Heads wider than 128 without the relation chain: grid (row groups of
// kWideWarps tiles, H, B), a warp per 16-row tile. K and the block's q rows
// are staged, the scores and probabilities kept in registers; then V is
// staged where K was, and the output computed and stored 128 columns at a
// time (o stays 64 registers a thread). Shared memory: (LkP + 16 warps) rows
// of D + Pad<T>, 183 KB at D 256, Lk 100 in fp32.
template <typename T, int KTM>
__global__ void __launch_bounds__(32 * kWideWarps) fused_attention_fwd_wide_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.y, b = blockIdx.z, warp = threadIdx.x / 32;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D, ld = D + Pad<T>::value;
  const int LkP = (Lk + 15) / 16 * 16, KT = LkP / 16;
  const int row_base = blockIdx.x * kWideWarps * 16, tiles = blockDim.x / 32;
  T* kv = reinterpret_cast<T*>(smem);   // [LkP][ld]: K, then V
  T* qs = kv + LkP * ld;                // [tiles * 16][ld]
  const long bh = (long)b * a.H + h;
  stage_rows(kv, ld, a.k + bh * Lk * D, Lk, LkP, D);
  stage_rows(qs, ld, a.q + (bh * Lq + row_base) * D, Lq - row_base, tiles * 16, D);
  cp_async_wait_all();
  __syncthreads();
  const int row0 = row_base + 16 * warp;
  const bool live = row0 < Lq;
  float s[2 * KTM][4];
  if (live) {
    tile_abt<KTM>(s, qs + 16 * warp * ld, StagedChunks<T>{kv, ld}, ld, D, KT);
    ScoreTerms<T> st{a.bias == nullptr ? nullptr : a.bias + (bh * Lq + row0) * Lk, nullptr, 0,
                     a.mask == nullptr ? nullptr : a.mask + (long)b * Lk, Lq - row0, Lk,
                     a.scale};
    tile_scores_epilogue<T, KTM>(s, st, KT);
    tile_softmax<KTM>(s, KT);
    if (a.keep != nullptr) tile_dropout<T, KTM>(s, a, bh, row0, KT);
  }
  __syncthreads();  // every warp is done with K
  stage_rows(kv, ld, a.v + bh * Lk * D, Lk, LkP, D);
  cp_async_wait_all();
  __syncthreads();
  if (!live) return;
  float o[64];
#pragma unroll 1
  for (int c0 = 0; c0 < D; c0 += 128) {
    const int w = min(128, D - c0);
    tile_px<128, KTM>(o, s, StagedChunks<T>{kv + c0, ld}, ld, w, KT);
    store_tile_cols<128>(o, a.out + bh * Lq * D + c0, row0, Lq, w, D, 1.f);
  }
}

// With the relation chain: grid (row groups of a.tiles 16-row tiles, B,
// head groups of kMaxH heads). The block computes pre for every head of its
// group and rows into shared memory, the features once per (b, i, j) and
// group, kChainE elements a thread at a time; then a warp per (tile, head)
// streams that head's K and V through its own two chunk buffers (with kWide
// V once per 128-column window). Shared memory: pre [Hg][16 tiles][LkP]
// fp32, the chain's weights, and per warp its q rows and chunk buffers.
template <typename T, int DM, int KTM, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) fused_attention_fwd_rel_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int H = a.H, Lq = a.Lq, Lk = a.Lk, D = a.D, R = a.R, Rr = a.Rr;
  const int h0 = blockIdx.z * kMaxH, Hg = min(kMaxH, H - h0);  // the block's head group
  const int ld = D + Pad<T>::value, LkP = (Lk + 15) / 16 * 16, KT = LkP / 16;
  const int rows_b = 16 * a.tiles, row_base = blockIdx.x * rows_b;
  const int rows = min(rows_b, Lq - row_base);
  float* pres = smem;                        // [Hg][rows_b][LkP]
  float* ws = pres + Hg * rows_b * LkP;      // the chain's weights
  T* wbuf = reinterpret_cast<T*>(ws + (chain_weight_floats(R) + 3) / 4 * 4);
  load_chain_weights(a.w1, a.b1, a.wr, a.br, Rr, R, h0, Hg, ws);
  __syncthreads();

  const int E = rows * Lk;
  const T* raw = a.raw + ((long)b * Lq + row_base) * Lk * Rr;
  for (int e0 = kChainE * threadIdx.x; e0 < E; e0 += kChainE * blockDim.x) {
    float x[kChainE][kMaxRr], pre[kChainE][kMaxH];
#pragma unroll
    for (int u = 0; u < kChainE; ++u) load_raw(raw + (long)min(e0 + u, E - 1) * Rr, Rr, x[u]);
    relation_pre_heads<kChainE>(x, Rr, R, Hg, ws, pre);
#pragma unroll
    for (int u = 0; u < kChainE; ++u) {
      const int e = e0 + u;
      if (e >= E) continue;
      const int r = e / Lk, j = e - r * Lk;
#pragma unroll
      for (int hh = 0; hh < kMaxH; ++hh)
        if (hh < Hg) {
          pres[(hh * rows_b + r) * LkP + j] = pre[u][hh];
          if (a.pre != nullptr)
            a.pre[(((long)b * H + h0 + hh) * Lq + row_base + r) * Lk + j] = pre[u][hh];
        }
    }
  }
  __syncthreads();

  T* qs = wbuf + warp * 16 * (1 + kStages) * ld;  // the warp's q rows [16][ld], then its buffers
  T* ring = qs + 16 * ld;
  for (int item = warp; item < a.tiles * Hg; item += warps) {
    const int tile = item / Hg, hl = item - tile * Hg, h = h0 + hl, row0 = row_base + 16 * tile;
    if (row0 >= Lq) continue;
    const long bh = (long)b * H + h;
    __syncwarp();  // the warp is done with qs
    stage_rows(qs, ld, a.q + (bh * Lq + row0) * D, Lq - row0, 16, D, threadIdx.x % 32, 32);
    cp_async_commit();
    const WarpStream<T, kStages> kc{ring, a.k + bh * Lk * D, Lk, D, ld, KT};
    const WarpStream<T, kStages> vc{ring, a.v + bh * Lk * D, Lk, D, ld, KT};
    attend_tile<T, DM, KTM, kWide>(a, b, h, row0, qs, kc, vc, ld,
                                   pres + (hl * rows_b + 16 * tile) * LkP, LkP);
  }
}

template <typename T, int DM, int KTM>
cudaError_t launch_head(const Args<T>& a, int B, cudaStream_t stream) {
  const int ld = a.D + Pad<T>::value, LkP = (a.Lk + 15) / 16 * 16;
  const int tiles = (a.Lq + 15) / 16, warps = min(kWarps, tiles);
  const size_t bytes = (size_t)(2 * LkP + 16 * warps) * ld * sizeof(T);
  if (bytes > (size_t)kSmemCap) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_attention_fwd_kernel<T, DM, KTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((tiles + kWarps - 1) / kWarps, a.H, B);
  fused_attention_fwd_kernel<T, DM, KTM><<<grid, 32 * warps, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DM, int KTM, bool kWide = false>
cudaError_t launch_rel(Args<T> a, int B, cudaStream_t stream) {
  const int ld = a.D + Pad<T>::value, LkP = (a.Lk + 15) / 16 * 16;
  const int tiles = (a.Lq + 15) / 16, Hg = min(a.H, kMaxH);
  a.tiles = max(1, min(kWarps / Hg, tiles));  // 8 (tile, head) items a block where Hg <= 8
  const size_t fixed =
      ((size_t)Hg * 16 * a.tiles * LkP + (chain_weight_floats(a.R) + 3) / 4 * 4) * sizeof(float);
  const size_t per_warp = (size_t)16 * (1 + kStages) * ld * sizeof(T);
  if (fixed + per_warp > (size_t)kSmemCap) return cudaErrorInvalidValue;
  const int warps = min(min(kWarps, a.tiles * Hg), (int)((kSmemCap - fixed) / per_warp));
  const size_t bytes = fixed + warps * per_warp;
  cudaError_t err = cudaFuncSetAttribute(fused_attention_fwd_rel_kernel<T, DM, KTM, kWide>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((tiles + a.tiles - 1) / a.tiles, B, (a.H + kMaxH - 1) / kMaxH);
  fused_attention_fwd_rel_kernel<T, DM, KTM, kWide><<<grid, 32 * warps, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t launch_d(const Args<T>& a, int B, cudaStream_t stream) {
  const int KT = (a.Lk + 15) / 16;
  if (a.raw != nullptr) {  // keys up to 128 with the relation chain
    if (KT <= 1) return launch_rel<T, DM, 1>(a, B, stream);
    if (KT <= 8) return launch_rel<T, DM, 8>(a, B, stream);
    return cudaErrorInvalidValue;
  }
  if (KT <= 1) return launch_head<T, DM, 1>(a, B, stream);
  if (KT <= 8) return launch_head<T, DM, 8>(a, B, stream);
  if (KT <= 13) return launch_head<T, DM, 13>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int KTM>
cudaError_t launch_wide_head(const Args<T>& a, int B, cudaStream_t stream) {
  const int ld = a.D + Pad<T>::value, LkP = (a.Lk + 15) / 16 * 16;
  const int tiles = (a.Lq + 15) / 16, warps = min(kWideWarps, tiles);
  const size_t bytes = (size_t)(LkP + 16 * warps) * ld * sizeof(T);
  if (bytes > (size_t)kSmemCap) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_attention_fwd_wide_kernel<T, KTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((tiles + kWideWarps - 1) / kWideWarps, a.H, B);
  fused_attention_fwd_wide_kernel<T, KTM><<<grid, 32 * warps, bytes, stream>>>(a);
  return cudaGetLastError();
}

// heads wider than 128 (up to 256): keys up to 128
template <typename T>
cudaError_t launch_wide(const Args<T>& a, int B, cudaStream_t stream) {
  const int KT = (a.Lk + 15) / 16;
  if (a.raw != nullptr) {
    if (KT <= 1) return launch_rel<T, 128, 1, true>(a, B, stream);
    if (KT <= 8) return launch_rel<T, 128, 8, true>(a, B, stream);
    return cudaErrorInvalidValue;
  }
  if (KT <= 1) return launch_wide_head<T, 1>(a, B, stream);
  if (KT <= 8) return launch_wide_head<T, 8>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, const void* raw, const void* w1, const void* b1,
                   const void* wr, const void* br, void* out, void* keep, void* pre, int B,
                   int H, int Lq, int Lk, int D, int Rr, int R, int head0, int heads_total,
                   float scale, const void* seed, unsigned int keep_thr, float keep_p,
                   cudaStream_t stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 16 || D > kMaxD || D % 16 != 0)
    return cudaErrorInvalidValue;
  if (raw != nullptr && (Rr < 1 || Rr > kMaxRr || R < 1 || H > kMaxHeads))
    return cudaErrorInvalidValue;
  if (raw == nullptr && pre != nullptr) return cudaErrorInvalidValue;
  if (keep != nullptr && (seed == nullptr || !(keep_p > 0.f && keep_p <= 1.f)))
    return cudaErrorInvalidValue;
  if (head0 < 0 || heads_total < head0 + H) return cudaErrorInvalidValue;
  const Args<T> a{static_cast<const T*>(q),  static_cast<const T*>(k),
                  static_cast<const T*>(v),  static_cast<const T*>(bias),
                  static_cast<const unsigned char*>(mask),
                  static_cast<const T*>(raw), static_cast<const T*>(w1),
                  static_cast<const T*>(b1), static_cast<const T*>(wr),
                  static_cast<const T*>(br), static_cast<T*>(out),
                  static_cast<unsigned char*>(keep), static_cast<float*>(pre),
                  H, Lq, Lk, D, Rr, R, head0, heads_total, 1, scale,
                  static_cast<const unsigned long long*>(seed), keep_thr, keep_p};
  if (D > 128) return launch_wide<T>(a, B, stream);
  return D <= 64 ? launch_d<T, 64>(a, B, stream) : launch_d<T, 128>(a, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers may be null for absent operands
// (bias, mask, raw together with w1/b1/wr/br, keep: no dropout, pre: no
// relation chain written out). With keep, the kernel draws the mask for
// the 64-bit key at `seed` (device memory, not null), keeps an element when
// its bits are below keep_thr, scales kept probabilities by 1 / keep_p and
// writes the mask to keep; the mask of head h is the one of head head0 + h
// in a call of heads_total heads (0 and H: this call's own). With raw and
// pre it also writes the relation chain pre [B, H, Lq, Lk] fp32 for the
// backward. Returns the CUDA error code of the launch (0 = launched;
// cudaErrorInvalidValue for a shape outside the limits above); the kernel
// runs on `stream`.
extern "C" int mmnas_fused_attention_fwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* bias,
                                         const void* mask, const void* raw,
                                         const void* w1, const void* b1, const void* wr,
                                         const void* br, void* out, void* keep, void* pre,
                                         int B, int H, int Lq, int Lk, int D, int Rr, int R,
                                         int head0, int heads_total, float scale,
                                         const void* seed,
                                         unsigned int keep_thr, float keep_p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, mask, raw, w1, b1, wr, br, out, keep, pre, B, H, Lq,
                         Lk, D, Rr, R, head0, heads_total, scale, seed, keep_thr, keep_p, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, mask, raw, w1, b1, wr, br, out, keep, pre, B,
                                 H, Lq, Lk, D, Rr, R, head0, heads_total, scale, seed, keep_thr,
                                 keep_p, s);
  return cudaErrorInvalidValue;
}
