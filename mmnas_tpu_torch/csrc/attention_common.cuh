// Device code shared by the fused attention forward and backward kernels
// and the bias probes: loads and stores in the operand type, the RSA
// relation chain, and the warp-level tile arithmetic of the attention
// kernels (a warp owns a 16-row tile, the m16 of mma.sync.m16n8k16).
//
// Tile layouts. A score tile S (16 rows x 16 KT keys) lives in registers
// as float s[2 KTM][4] in the C layout of mma.m16n8k16: with g = lane / 4
// and t = lane % 4, s[n][0..1] = S[g][8n + 2t + 0..1] and s[n][2..3] =
// S[g + 8][8n + 2t + 0..1]. Both operand types use it, so the softmax,
// the dropout and the backward's elementwise steps are one code. An
// output tile (16 rows x D) is float o[DM / 2]: in bf16 the C layout of
// its D / 8 column tiles (o[4n + e]), in fp32 rows g, g + 8 by columns
// 16m + 4t + c (o[8m + 4r + c], r the row half), so that each 16-byte
// shared load of V serves four columns. Shared-memory rows of K, V, Q and
// dO are D + Pad<T> elements long (16 bytes more than a row), so that 8
// rows read together fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mmnas {

constexpr int kMaxRr = 8;          // raw relation channels held in registers
constexpr int kMaxH = 16;          // heads the relation chain holds in registers (a group)
constexpr int kMaxHeads = 32;      // heads the relation chain takes, in groups of kMaxH
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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
struct Pad;  // shared-memory row padding, in elements (16 bytes)
template <>
struct Pad<float> {
  static constexpr int value = 4;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int value = 8;
};

// ---------------------------------------------------------------------------
// the relation chain
// ---------------------------------------------------------------------------
//
// The chain of one (b, i, j), in fp32:
//   t[r] = relu(b1[r] + sum_c raw[c] W1[r, c])          (relation_feature)
//   pre  = sum_r t[r] Wr[h, r] + br[h]                   (relation_pre_heads)
// The attention forward computes it through these functions; the bias
// probes (probes.cu) repeat their operations in the same order per head, so
// all of them round alike.

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

// The chain's weights for the heads h0 .. h0 + H - 1 (H <= kMaxH, one head
// group) in shared memory, fp32: w1p [R][kMaxRr] (W1's rows, zeros past
// Rr), wrt [R][kMaxH] (those heads' rows of Wr, transposed, zeros past H),
// b1s [R], brs [kMaxH]; chain_weight_floats(R) floats from a 16-byte
// boundary, so a row of w1p or wrt is read by 16-byte loads.
__host__ __device__ constexpr int chain_weight_floats(int R) {
  return R * (kMaxRr + kMaxH + 1) + kMaxH;
}

template <typename T>
__device__ __forceinline__ void load_chain_weights(const T* w1, const T* b1, const T* wr,
                                                   const T* br, int Rr, int R, int h0, int H,
                                                   float* ws) {
  float* w1p = ws;
  float* wrt = w1p + R * kMaxRr;
  float* b1s = wrt + R * kMaxH;
  float* brs = b1s + R;
  for (int i = threadIdx.x; i < R * kMaxRr; i += blockDim.x) {
    const int r = i / kMaxRr, c = i - r * kMaxRr;
    w1p[i] = c < Rr ? load_f32(w1, (long)r * Rr + c) : 0.f;
  }
  for (int i = threadIdx.x; i < R * kMaxH; i += blockDim.x) {
    const int r = i / kMaxH, h = i - r * kMaxH;
    wrt[i] = h < H ? load_f32(wr, (long)(h0 + h) * R + r) : 0.f;
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) b1s[i] = load_f32(b1, i);
  for (int i = threadIdx.x; i < kMaxH; i += blockDim.x) brs[i] = i < H ? load_f32(br, h0 + i) : 0.f;
}

// pre[e][h] for every head h < H of a head group (the weights at ws, as
// load_chain_weights stages them) of E elements, the features computed once
// per element and group. Per head: pre = 0, then pre = fma(t[r], Wr[h, r],
// pre) for r = 0 .. R - 1, then pre + br[h]. Each weight read from shared
// memory (16 bytes at a time) serves all E elements from registers.
template <int E>
__device__ __forceinline__ void relation_pre_heads(const float (&x)[E][kMaxRr], int Rr, int R,
                                                   int H, const float* ws,
                                                   float (&pre)[E][kMaxH]) {
  const float* w1p = ws;
  const float* wrt = w1p + R * kMaxRr;
  const float* b1s = wrt + R * kMaxH;
  const float* brs = b1s + R;
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) pre[e][h] = 0.f;
  for (int rr = 0; rr < R; ++rr) {
    float w1r[kMaxRr];
#pragma unroll
    for (int c = 0; c < kMaxRr; c += 4) {
      const float4 w = *reinterpret_cast<const float4*>(w1p + rr * kMaxRr + c);
      w1r[c] = w.x;
      w1r[c + 1] = w.y;
      w1r[c + 2] = w.z;
      w1r[c + 3] = w.w;
    }
    const float b1r = b1s[rr];
    float t[E];
#pragma unroll
    for (int e = 0; e < E; ++e) t[e] = relation_feature(x[e], Rr, w1r, b1r);
#pragma unroll
    for (int q = 0; q < kMaxH; q += 4)
      if (q < H) {
        const float4 w4 = *reinterpret_cast<const float4*>(wrt + rr * kMaxH + q);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (q + c < H)
#pragma unroll
            for (int e = 0; e < E; ++e) pre[e][q + c] = fmaf(t[e], w[c], pre[e][q + c]);
      }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
      if (h < H) pre[e][h] = pre[e][h] + brs[h];
}

// ---------------------------------------------------------------------------
// copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Columns [0, width) of the rows of a [rows][src_ld] operand (src already
// at the first column) into shared memory rows of ld elements, by 16-byte
// asynchronous copies of threads tid, tid + nt, ...; rows [rows, rows_pad)
// are zeros. Operand pointers, the first column and width * sizeof(T) are
// multiples of 16 bytes (checked by the wrappers). Commit and wait, then a
// barrier of the copying threads, before reading.
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, int ld, const T* src, int src_ld, int rows,
                                           int rows_pad, int width, int tid, int nt) {
  const int per_row = width * (int)sizeof(T) / 16;
  for (int c = tid; c < rows_pad * per_row; c += nt) {
    const int r = c / per_row, k = c - r * per_row;
    void* d = reinterpret_cast<char*>(dst + (long)r * ld) + 16 * k;
    if (r < rows)
      cp_async16(d, reinterpret_cast<const char*>(src + (long)r * src_ld) + 16 * k);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}
// by the whole block: a window of a wide head's columns (the sliced backward)
template <typename T>
__device__ __forceinline__ void stage_cols(T* dst, int ld, const T* src, int src_ld, int rows,
                                           int rows_pad, int width) {
  stage_cols(dst, ld, src, src_ld, rows, rows_pad, width, threadIdx.x, blockDim.x);
}
// rows [0, rows_pad) of a [rows][D] operand, whole
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int rows, int rows_pad,
                                           int D, int tid, int nt) {
  stage_cols(dst, ld, src, D, rows, rows_pad, D, tid, nt);
}
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int rows, int rows_pad,
                                           int D) {
  stage_rows(dst, ld, src, rows, rows_pad, D, threadIdx.x, blockDim.x);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a tile product finds the keys (K or V rows) of chunk c, 16 rows of
// ld elements in shared memory. StagedChunks: the block staged them all.
// WarpStream: the warp copies them itself through NS slots, NS - 1 chunks
// in flight, for blocks that cannot hold a head's K and V whole (the
// relation chain's); begin() starts chunks 0..NS-2, chunk(c) starts chunk
// c + NS - 1 and waits for c.
template <typename T>
struct StagedChunks {
  const T* rows;
  int ld;
  __device__ __forceinline__ void begin() const {}
  __device__ __forceinline__ const T* operator()(int c) const { return rows + 16 * c * ld; }
};

template <typename T, int NS>
struct WarpStream {
  T* ring;       // [NS][16][ld] in shared memory, the warp's own
  const T* src;  // [n][D] in device memory
  int n, D, ld, chunks;
  // copy chunk c into slot c % NS, or nothing past the last; one commit group each
  __device__ __forceinline__ void stage(int c) const {
    if (c < chunks)
      stage_rows(ring + (c % NS) * 16 * ld, ld, src + (long)16 * c * D, n - 16 * c, 16, D,
                 threadIdx.x % 32, 32);
    cp_async_commit();
  }
  __device__ __forceinline__ void begin() const {
    __syncwarp();  // the warp is done with every slot
#pragma unroll
    for (int c = 0; c < NS - 1; ++c) stage(c);
  }
  __device__ __forceinline__ const T* operator()(int c) const {
    __syncwarp();  // every lane is done with chunk c - 1, whose slot chunk c + NS - 1 takes
    stage(c + NS - 1);
    cp_async_wait<NS - 1>();  // all but the NS - 1 newest groups: chunk c is in
    __syncwarp();             // and visible to the warp
    return ring + (c % NS) * 16 * ld;
  }
};

// The chunks of `inner` from column c0 on: a product over a window of a
// wide head's columns.
template <typename Chunks>
struct ColumnShift {
  Chunks inner;
  int c0;
  __device__ __forceinline__ void begin() const { inner.begin(); }
  __device__ __forceinline__ auto operator()(int c) const { return inner(c) + c0; }
};

// ---------------------------------------------------------------------------
// tensor-core primitives (bf16 operands, fp32 accumulation)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half, rounded
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b for one m16n8k16 tile: a in the A layout, (b0, b1) in the B layout
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// tile products
// ---------------------------------------------------------------------------

// (s0, s1) = A B^T for one chunk of 16 keys, the C-layout n tiles of keys
// 0-7 and 8-15: A the warp's 16 rows at `as`, B the chunk's rows at `bs`,
// both rows of ld, over the first D columns
// (with kAccumulate the products add to s0, s1 as they stand)
template <bool kAccumulate = false>
__device__ __forceinline__ void chunk_abt(float (&s0)[4], float (&s1)[4],
                                          const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                          int ld, int D) {
  const int lane = threadIdx.x % 32, mi = lane / 8, r8 = lane % 8;
  if (!kAccumulate) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s0[i] = s1[i] = 0.f;
  }
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4], b[4];
    // A: (rows 0-7 | 8-15) x (k 0-7 | 8-15), rows fastest; B: keys x k, k fastest
    ldsm_x4(a, as + ((mi & 1) * 8 + r8) * ld + 16 * kc + (mi >> 1) * 8);
    ldsm_x4(b, bs + ((mi >> 1) * 8 + r8) * ld + 16 * kc + (mi & 1) * 8);
    mma_bf16(s0, a, b[0], b[1]);
    mma_bf16(s1, a, b[2], b[3]);
  }
}

// fp32 on the CUDA cores, register-tiled: a thread's 2 rows by 4 keys; one
// 16-byte load of a row serves 8 FMAs. The sum over d runs in order.
template <bool kAccumulate = false>
__device__ __forceinline__ void chunk_abt(float (&s0)[4], float (&s1)[4], const float* as,
                                          const float* bs, int ld, int D) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (!kAccumulate) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s0[i] = s1[i] = 0.f;
  }
  const float* a0p = as + g * ld;
  const float* b0p = bs + 2 * t * ld;
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a0p + d);
    const float4 a1 = *reinterpret_cast<const float4*>(a0p + 8 * ld + d);
    const float4 b[4] = {*reinterpret_cast<const float4*>(b0p + d),
                         *reinterpret_cast<const float4*>(b0p + ld + d),
                         *reinterpret_cast<const float4*>(b0p + 8 * ld + d),
                         *reinterpret_cast<const float4*>(b0p + 9 * ld + d)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float* c = k < 2 ? s0 : s1;
      const float4 bk = b[k];
      c[k & 1] = fmaf(a0.w, bk.w, fmaf(a0.z, bk.z, fmaf(a0.y, bk.y, fmaf(a0.x, bk.x, c[k & 1]))));
      c[2 + (k & 1)] =
          fmaf(a1.w, bk.w, fmaf(a1.z, bk.z, fmaf(a1.y, bk.y, fmaf(a1.x, bk.x, c[2 + (k & 1)]))));
    }
  }
}

// o += P X for one chunk of 16 keys: (p0, p1) the C-layout probabilities of
// keys 0-7 and 8-15 (rounded to bf16 here), X the chunk's rows at `xs`
template <int DM>
__device__ __forceinline__ void chunk_px(float (&o)[DM / 2], const float (&p0)[4],
                                         const float (&p1)[4], const __nv_bfloat16* xs, int ld,
                                         int D) {
  const int lane = threadIdx.x % 32, mi = lane / 8, r8 = lane % 8;
  const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                         pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
  for (int dp = 0; dp < DM / 16; ++dp)
    if (dp < D / 16) {
      uint32_t b[4];  // keys (0-7 | 8-15) x (d 0-7 | 8-15), keys fastest, transposed
      ldsm_x4_t(b, xs + ((mi & 1) * 8 + r8) * ld + 16 * dp + (mi >> 1) * 8);
      mma_bf16(o + 8 * dp, a, b[0], b[1]);
      mma_bf16(o + 8 * dp + 4, a, b[2], b[3]);
    }
}

// fp32: the quad's probabilities reach each thread by shuffles; each 16-byte
// load of a row of X serves 8 FMAs. The sum over keys runs in order.
template <int DM>
__device__ __forceinline__ void chunk_px(float (&o)[DM / 2], const float (&p0)[4],
                                         const float (&p1)[4], const float* xs, int ld, int D) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* p = half ? p1 : p0;
#pragma unroll 1
    for (int tp = 0; tp < 4; ++tp) {
      const int src = (lane & ~3) | tp;
      const float p00 = __shfl_sync(0xffffffffu, p[0], src);
      const float p01 = __shfl_sync(0xffffffffu, p[1], src);
      const float p10 = __shfl_sync(0xffffffffu, p[2], src);
      const float p11 = __shfl_sync(0xffffffffu, p[3], src);
      const float* x0 = xs + (8 * half + 2 * tp) * ld + 4 * t;
#pragma unroll
      for (int m = 0; m < DM / 16; ++m)
        if (m < D / 16) {
          const float4 v0 = *reinterpret_cast<const float4*>(x0 + 16 * m);
          const float4 v1 = *reinterpret_cast<const float4*>(x0 + ld + 16 * m);
          float* c = o + 8 * m;
          c[0] = fmaf(p01, v1.x, fmaf(p00, v0.x, c[0]));
          c[1] = fmaf(p01, v1.y, fmaf(p00, v0.y, c[1]));
          c[2] = fmaf(p01, v1.z, fmaf(p00, v0.z, c[2]));
          c[3] = fmaf(p01, v1.w, fmaf(p00, v0.w, c[3]));
          c[4] = fmaf(p11, v1.x, fmaf(p10, v0.x, c[4]));
          c[5] = fmaf(p11, v1.y, fmaf(p10, v0.y, c[5]));
          c[6] = fmaf(p11, v1.z, fmaf(p10, v0.z, c[6]));
          c[7] = fmaf(p11, v1.w, fmaf(p10, v0.w, c[7]));
        }
    }
  }
}

// s = A B^T: A the warp's 16 rows at `as`, B the first 16 KT keys, chunk by
// chunk from `chunks` (StagedChunks or WarpStream); with kAccumulate, s +=
template <int KTM, bool kAccumulate = false, typename T, typename Chunks>
__device__ __forceinline__ void tile_abt(float (&s)[2 * KTM][4], const T* as,
                                         const Chunks& chunks, int ld, int D, int KT) {
  chunks.begin();
#pragma unroll
  for (int c = 0; c < KTM; ++c)
    if (c < KT) chunk_abt<kAccumulate>(s[2 * c], s[2 * c + 1], as, chunks(c), ld, D);
}

// o = P X: P the warp's 16 x 16 KT tile in registers (C layout), X the
// first 16 KT rows, chunk by chunk
template <int DM, int KTM, typename Chunks>
__device__ __forceinline__ void tile_px(float (&o)[DM / 2], const float (&p)[2 * KTM][4],
                                        const Chunks& chunks, int ld, int D, int KT) {
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
  chunks.begin();
#pragma unroll
  for (int c = 0; c < KTM; ++c)
    if (c < KT) chunk_px<DM>(o, p[2 * c], p[2 * c + 1], chunks(c), ld, D);
}

// o = P^T X for the 16 columns j0.. of P: P [nq * 16][ldp] and X
// [nq * 16][ld] in shared memory (the backward's dV = P^T dO, dK = dS^T Q).
template <int DM>
__device__ __forceinline__ void tile_ptx(float (&o)[DM / 2], const __nv_bfloat16* ps, int ldp,
                                         int j0, const __nv_bfloat16* xs, int ld, int D,
                                         int nq) {
  const int lane = threadIdx.x % 32, mi = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
  for (int kc = 0; kc < nq; ++kc) {
    uint32_t a[4];  // P^T: (j 0-7 | 8-15) x (i 0-7 | 8-15), j fastest, transposed
    ldsm_x4_t(a, ps + (16 * kc + (mi >> 1) * 8 + r8) * ldp + j0 + (mi & 1) * 8);
#pragma unroll
    for (int dp = 0; dp < DM / 16; ++dp)
      if (dp < D / 16) {
        uint32_t b[4];
        ldsm_x4_t(b, xs + (16 * kc + (mi & 1) * 8 + r8) * ld + 16 * dp + (mi >> 1) * 8);
        mma_bf16(o + 8 * dp, a, b[0], b[1]);
        mma_bf16(o + 8 * dp + 4, a, b[2], b[3]);
      }
  }
}

template <int DM>
__device__ __forceinline__ void tile_ptx(float (&o)[DM / 2], const float* ps, int ldp, int j0,
                                         const float* xs, int ld, int D, int nq) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < DM / 2; ++i) o[i] = 0.f;
  for (int i = 0; i < 16 * nq; ++i) {
    const float p0 = ps[i * ldp + j0 + g], p1 = ps[i * ldp + j0 + g + 8];
    const float* x = xs + i * ld + 4 * t;
#pragma unroll
    for (int m = 0; m < DM / 16; ++m)
      if (m < D / 16) {
        const float4 v = *reinterpret_cast<const float4*>(x + 16 * m);
        float* c = o + 8 * m;
        c[0] = fmaf(p0, v.x, c[0]);
        c[1] = fmaf(p0, v.y, c[1]);
        c[2] = fmaf(p0, v.z, c[2]);
        c[3] = fmaf(p0, v.w, c[3]);
        c[4] = fmaf(p1, v.x, c[4]);
        c[5] = fmaf(p1, v.y, c[5]);
        c[6] = fmaf(p1, v.z, c[6]);
        c[7] = fmaf(p1, v.w, c[7]);
      }
  }
}

// rows [row0, row0 + 16) of an output tile o * scale into columns [0, D)
// of dst (rows of ldd elements), rows at or past `rows` skipped, in the
// operand type
template <int DM>
__device__ __forceinline__ void store_tile_cols(const float (&o)[DM / 2], __nv_bfloat16* dst,
                                                int row0, int rows, int D, int ldd,
                                                float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
    if (n < D / 8) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + g + 8 * half;
        if (r < rows)
          *reinterpret_cast<uint32_t*>(dst + (long)r * ldd + 8 * n + 2 * t) =
              pack_bf16(o[4 * n + 2 * half] * scale, o[4 * n + 2 * half + 1] * scale);
      }
    }
}

template <int DM>
__device__ __forceinline__ void store_tile_cols(const float (&o)[DM / 2], float* dst, int row0,
                                                int rows, int D, int ldd, float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < DM / 16; ++m)
    if (m < D / 16) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + g + 8 * half;
        const float* c = o + 8 * m + 4 * half;
        if (r < rows)
          *reinterpret_cast<float4*>(dst + (long)r * ldd + 16 * m + 4 * t) =
              make_float4(c[0] * scale, c[1] * scale, c[2] * scale, c[3] * scale);
      }
    }
}

// the same into a [rows][D] array
template <int DM, typename T>
__device__ __forceinline__ void store_tile(const float (&o)[DM / 2], T* dst, int row0, int rows,
                                           int D, float scale) {
  store_tile_cols<DM>(o, dst, row0, rows, D, D, scale);
}

// ---------------------------------------------------------------------------
// scores and softmax of a tile
// ---------------------------------------------------------------------------

// What a score needs besides q k^T, for the warp's rows [row0, row0 + 16)
// of one (b, h): s = dot * scale (+ bias) (+ log(max(pre, 1e-6))) (- 1e9
// where the key is padded); keys at or past Lk get -inf (probability 0).
template <typename T>
struct ScoreTerms {
  const T* bias;              // row row0 of [Lq][Lk] for this (b, h), or null
  const float* pre;           // row row0 of the relation chain, rows of ldpre, or null
  int ldpre;
  const unsigned char* mask;  // [Lk] pad flags of batch row b, or null
  int rows, Lk;               // valid rows of the tile (Lq - row0) and keys
  float scale;
};

template <typename T, int KTM>
__device__ __forceinline__ void tile_scores_epilogue(float (&s)[2 * KTM][4],
                                                     const ScoreTerms<T>& st, int KT) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * st.scale;
        if (j >= st.Lk) {
          x = -INFINITY;
        } else {
          if (r < st.rows) {
            if (st.bias != nullptr) x += load_f32(st.bias, (long)r * st.Lk + j);
            if (st.pre != nullptr) x += logf(fmaxf(st.pre[(long)r * st.ldpre + j], kClamp));
          }
          if (st.mask != nullptr && st.mask[j]) x += kMaskAdd;
        }
        s[n][e] = x;
      }
    }
}

// Sums over each of the thread's two rows, of x (kFma = false) or of x * y
// by FMAs (kFma = true), in the order of a warp whose lane v adds keys v,
// v + 32, ... in turn and then sums its 32 lanes by a butterfly (xor 16,
// 8, 4, 2, 1). That is the order of PyTorch's softmax kernels for rows of
// up to 1024 keys, so the kernels' probabilities and their backward's row
// sums round as the plain version's do. Key j = 8n + 2t + c sits at
// virtual lane 8 (n mod 4) + 2t + c: the lane's keys are the thread's
// own, levels 16 and 8 pair them in the thread, 4 and 2 pair the quad's
// threads (shuffles xor 2 and 1), 1 pairs c.
template <int KTM, bool kFma>
__device__ __forceinline__ void lane_order_sums(const float (&x)[2 * KTM][4],
                                                const float (&y)[2 * KTM][4], int KT,
                                                float& r0, float& r1) {
  float acc[2][4][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k][0] = acc[r][k][1] = 0.f;
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& a = acc[e >> 1][n & 3][e & 1];
        a = kFma ? fmaf(x[n][e], y[n][e], a) : a + x[n][e];
      }
    }
  float tot[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float a0 = acc[r][0][c] + acc[r][2][c], a1 = acc[r][1][c] + acc[r][3][c];  // xor 16
      float v = a0 + a1;                                                          // xor 8
      v += __shfl_xor_sync(0xffffffffu, v, 2);                                    // xor 4
      v += __shfl_xor_sync(0xffffffffu, v, 1);                                    // xor 2
      l[c] = v;
    }
    tot[r] = l[0] + l[1];                                                         // xor 1
  }
  r0 = tot[0];
  r1 = tot[1];
}

// the softmax of each row in fp32, in place: max and exp, then the sum in
// lane order (lane_order_sums), then e / sum
template <int KTM>
__device__ __forceinline__ void tile_softmax(float (&s)[2 * KTM][4], int KT) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
    }
  float l0, l1;
  lane_order_sums<KTM, false>(s, s, KT, l0, l1);
#pragma unroll
  for (int n = 0; n < 2 * KTM; ++n)
    if (n < 2 * KT) {
      s[n][0] = s[n][0] / l0;
      s[n][1] = s[n][1] / l0;
      s[n][2] = s[n][2] / l1;
      s[n][3] = s[n][3] / l1;
    }
}

}  // namespace mmnas
