// The five Pallas debug probes of tools/debug/ as kernels for Hopper (sm_90a).
//
// Each computes what its TPU probe computes; the layouts follow the port
// (torch Linear layout: W1 [R, Rr], Wr [H, R]), not the TPU blocks.
//
// 1. probe_bias (replaces `kernel`, tools/debug/_probe_bias.py:13): the RSA
//    log-bias alone,
//      bias[b, h, i, j] = log(max(sum_r relu(raw[b,i,j] W1[r]^T + b1[r]) Wr[h, r] + br[h], 1e-6))
//    The TPU kernel computed the relation features once per batch row
//    (`h == 0` guard) and carried them across the head programs in VMEM.
//    Here a thread computes each of its elements' features once and all H
//    heads' sums from them, in registers.
// 2. probe_bias2 (`kernel`, _probe_bias2.py:13): the same chain with the
//    features computed again for every head, as the TPU probe does: a
//    thread keeps its elements' raw channels in registers and, head after
//    head, computes all R features and that head's sum.
//
//    What bounds them on this card: the fp32 FMA rate. Per element probe_bias
//    does R (Rr + H) FMAs and R maxima; probe_bias2, by its definition, H
//    times the features: H R (Rr + 1) FMAs and H R maxima. The bytes (raw
//    in, [B, H, L, L] out) take a tenth of that time or less. At the probes'
//    size (80,000 elements) the work is small for the card: each weight a
//    thread reads from shared memory must feed several elements, yet few
//    elements a thread leave the warp schedulers short of warps. The design:
//    - the chain's shapes are fixed at compile time for those of every task
//      and of the probes (Rr 4, R 64, H 4 or 8): the channel and head loops
//      unroll fully with no predicate, the feature loop 16 features a pass
//      in probe_bias (so the code stays within the instruction cache) and
//      fully in probe_bias2; a raw element is one 16-byte load, and b1, W1
//      rows and Wr rows come from shared memory by 16-byte loads;
//    - a thread computes E elements a block's width apart, so each weight
//      read, a broadcast to the warp, feeds E (Rr + H) FMAs, the E H sums
//      are independent chains, and each head's stores stay coalesced;
//    - a flat grid over the B L L elements, a block per threads x E of them,
//      so every SM gets work; probe_bias2 also splits the heads among
//      kBias2Groups blocks of the same elements (each computes all the
//      features again for each of its heads), for more warps. A block
//      stages the chain's weights (3.3 KB at R 64, H 8) in shared memory
//      once, all of a thread's 16-byte loads in flight together, with its
//      raw loads;
//    - probe_bias2 reads b1 and W1 afresh for every head (volatile loads):
//      the compiler otherwise takes the features, the same for every head,
//      out of the head loop where registers allow, and computes them once.
//    Other shapes (Rr 1..8, H 1..16, any R), and arrays off a 16-byte
//    boundary, take a generic instance of the same kernels with runtime
//    loops. E, the block size and the head groups are fixed at compile
//    time, at the best of a timed sweep at the probes' shapes (PERF.md):
//    probe_bias E 2 with 160 threads, probe_bias2 E 4 with 128 threads and
//    4 head groups.
//
//    The bits: per head every instance runs the operations of the attention
//    kernels' chain (attention_common.cuh: relation_feature,
//    relation_pre_heads) in their order: u = b1[r]; u = fma(raw[c], W1[r, c],
//    u) for c < Rr; t = max(u, 0); pre = fma(t, Wr[h, r], pre) for r < R
//    from 0; pre + br[h]; then the accurate logf(fmaxf(pre, 1e-6)). So the
//    two probes give equal bits, equal to log(max(pre, 1e-6)) of the `pre`
//    the RSA attention forward writes. That is what the probes check.
// 3. probe_slice (`k`, _probe_slice.py:7): out[i, j] = 2 plane[0, i, j] in
//    fp32 from an fp32 or bf16 plane, written per chunk of rows (the TPU
//    probe wrote four row chunks of 25) by several blocks of 128 threads a
//    chunk, four loads in flight a thread: at 10,000 elements the time is
//    the launch's and the loads' latency, so the design spreads them.
// 4. probe_outer (`k`, _probe_outer.py:9): out[i, j, r] = plane[i, j] w[r] +
//    b1[r] in fp32, from fp32 or bf16 operands. The product and the sum are
//    rounded one at a time (__fmul_rn, __fadd_rn: no FMA contraction), as
//    numpy rounds them. One thread per four r of one element, stored as one
//    16-byte write (the output's bytes are the work), one block of 256
//    threads per 1024 outputs, no 64-bit division per output.
// 5. probe_wrblock_a / probe_wrblock_b (`kA`, `kB`, _probe_wrblock.py:9,21):
//    Wr [H, R, 1] copied to out[b, h] for b < 2 on a (2, H) grid, through
//    two layouts: A reads through a pointer to its head's slice, B gets
//    the whole array and indexes it by blockIdx.y.
//
// At their shapes (at most 8 x 8 x 100 x 100 outputs) the slice, outer and
// wrblock probes are a few microseconds of work, bound by their bytes and,
// at that size, by the launch itself.

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// the bias probes
// ---------------------------------------------------------------------------

// the launches: elements a thread, threads a block, and probe_bias2's head
// groups (its blocks split the heads among this many)
constexpr int kBiasE = 2, kBiasThreads = 160;
constexpr int kBias2E = 4, kBias2Threads = 128, kBias2Groups = 4;
constexpr int kMaxBiasElements = (1 << 30);  // B L L: element indices stay in an int
constexpr size_t kDefaultSmem = 48 * 1024;   // dynamic shared memory without an opt-in

struct BiasArgs {
  const float* raw;  // [B, L, L, Rr]
  const float* w1;   // [R, Rr]
  const float* b1;   // [R]
  const float* wr;   // [H, R]
  const float* br;   // [H]
  float* out;        // [B, H, L, L]
  int n;             // B L L elements
  int plane;         // L L
  int H, Rr, R;
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// The chain's weights in shared memory, fp32, each part from a 16-byte
// boundary: w1s [R][Rr] (W1 as it is), b1s [R], wrs, brs [H]. wrs is [R][H]
// (Wr transposed: a feature's weights for every head in one row) for
// probe_bias, and [H][R] (Wr as it is: a head's weights in one row) for
// probe_bias2.
__host__ __device__ constexpr int bias_weight_floats(int Rr, int H, int R) {
  return pad4(R * Rr) + pad4(R) + pad4(R * H) + pad4(H);
}

struct BiasWeights {
  const float *w1s, *b1s, *wrs, *brs;
};

// A thread's share of the kUnits 16-byte units of an array: units tid,
// tid + blockDim.x, ... (blockDim.x >= 32), all loaded before any is stored
template <int kUnits>
struct Units {
  static constexpr int kPer = (kUnits + 31) / 32;
  float4 v[kPer];
  __device__ __forceinline__ void fetch(const float* src) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = threadIdx.x + k * blockDim.x;
      if (u < kUnits) v[k] = reinterpret_cast<const float4*>(src)[u];
    }
  }
  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int u = threadIdx.x + k * blockDim.x;
      if (u < kUnits) reinterpret_cast<float4*>(dst)[u] = v[k];
    }
  }
};

// kByHead: wrs [H][R] (probe_bias2), else [R][H] (probe_bias). With the
// shapes fixed (kRr > 0; the weights on 16-byte boundaries), a thread puts
// all of its 16-byte loads in flight, then stores them: one round trip to
// L2 for the block, where a loop that stores each value as it comes takes
// one a pass.
template <bool kByHead, int kRr, int kH, int kR>
__device__ __forceinline__ BiasWeights stage_bias_weights(const BiasArgs& a, int Rr, int H, int R,
                                                          float* s) {
  float* w1s = s;
  float* b1s = w1s + pad4(R * Rr);
  float* wrs = b1s + pad4(R);
  float* brs = wrs + pad4(R * H);
  if constexpr (kRr > 0) {
    static_assert(kR * kRr % 4 == 0 && kH % 4 == 0, "16-byte units");
    Units<kR * kRr / 4> w1;
    Units<kR / 4> b1;
    Units<kH * kR / 4> wr;
    Units<kH / 4> br;
    w1.fetch(a.w1);
    b1.fetch(a.b1);
    wr.fetch(a.wr);
    br.fetch(a.br);
    w1.put(w1s);
    b1.put(b1s);
    br.put(brs);
    if constexpr (kByHead) {
      wr.put(wrs);
    } else {
#pragma unroll
      for (int k = 0; k < wr.kPer; ++k) {
        const int u = threadIdx.x + k * blockDim.x;
        if (u < kH * kR / 4) {  // Wr[h, r .. r + 3] -> wrs[r .. r + 3][h]
          const int h = u / (kR / 4), r = 4 * (u - h * (kR / 4));
          wrs[r * kH + h] = wr.v[k].x;
          wrs[(r + 1) * kH + h] = wr.v[k].y;
          wrs[(r + 2) * kH + h] = wr.v[k].z;
          wrs[(r + 3) * kH + h] = wr.v[k].w;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * Rr; i += blockDim.x) w1s[i] = a.w1[i];
    for (int i = threadIdx.x; i < R; i += blockDim.x) b1s[i] = a.b1[i];
    for (int i = threadIdx.x; i < R * H; i += blockDim.x)
      wrs[i] = kByHead ? a.wr[i] : a.wr[(i % H) * R + i / H];
    for (int i = threadIdx.x; i < H; i += blockDim.x) brs[i] = a.br[i];
  }
  return {w1s, b1s, wrs, brs};
}

// v[0, N) = p[0, n): by 16-byte loads where the row's length is fixed at
// compile time (n == N) and a multiple of 4, p on a 16-byte boundary; else
// one float at a time, zeros past n. kFresh: volatile loads from shared
// memory, which the compiler may neither merge with an earlier load of the
// same row nor move out of a loop
template <int N, bool kVector, bool kFresh = false>
__device__ __forceinline__ void load_row(const float* p, int n, float (&v)[N]) {
  if constexpr (kVector && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 w;
      if constexpr (kFresh)
        asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(w.x), "=f"(w.y), "=f"(w.z), "=f"(w.w)
                     : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p + i))));
      else
        w = *reinterpret_cast<const float4*>(p + i);
      v[i] = w.x;
      v[i + 1] = w.y;
      v[i + 2] = w.z;
      v[i + 3] = w.w;
    }
  } else {
    using Src = std::conditional_t<kFresh, const volatile float, const float>;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = i < n ? static_cast<Src*>(p)[i] : 0.f;
  }
}

// t = relu(b + sum_c x[c] w[c]) over c < Rr: relation_feature's operations
template <int NRr>
__device__ __forceinline__ float bias_feature(const float (&x)[NRr], const float (&w)[NRr],
                                              float b, int Rr) {
  float u = b;
#pragma unroll
  for (int c = 0; c < NRr; ++c)
    if (c < Rr) u = fmaf(x[c], w[c], u);
  return fmaxf(u, 0.f);
}

// An instance's shapes: fixed at compile time (kRr, kH, kR > 0, kR a
// multiple of 4; raw and the weights on 16-byte boundaries), or all three
// 0 and read from the arguments, with registers for up to kMaxRr channels
// and kMaxH heads. A fixed instance takes its features 4 at a time (b1 and
// a head's Wr by 16-byte loads), a generic one 1 at a time.
template <int kRr, int kH, int kR>
struct BiasShape {
  static constexpr bool kFixed = kRr > 0;
  static_assert((kRr > 0) == (kH > 0) && (kH > 0) == (kR > 0), "fix all three shapes or none");
  static_assert(kR % 4 == 0, "a fixed R is a multiple of 4");
  static constexpr int NRr = kFixed ? kRr : kMaxRr;  // registers held
  static constexpr int NH = kFixed ? kH : kMaxH;
  static constexpr int G = kFixed ? 4 : 1;           // features a step
};

// A thread's E elements, blockDim.x apart from its block's first: their raw
// channels (the last element's for one past n) and where their head-0
// outputs go (-1 past n).
template <int E, int NRr, bool kFixed>
__device__ __forceinline__ void load_elements(const BiasArgs& a, int Rr, int H,
                                              float (&x)[E][NRr], long (&o)[E]) {
  const int first = blockIdx.x * blockDim.x * E + threadIdx.x;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int n = first + e * (int)blockDim.x;
    load_row<NRr, kFixed>(a.raw + (long)min(n, a.n - 1) * Rr, Rr, x[e]);
    o[e] = n < a.n ? n + (long)(n / a.plane) * (H - 1) * a.plane : -1;
  }
}

// grid (ceil(n / (blockDim.x E))): each element's features once, all heads
template <int kRr, int kH, int kR, int E>
__global__ void __launch_bounds__(kBiasThreads) probe_bias_kernel(const BiasArgs a) {
  using S = BiasShape<kRr, kH, kR>;
  constexpr int NRr = S::NRr, NH = S::NH, G = S::G;
  const int Rr = S::kFixed ? kRr : a.Rr, H = S::kFixed ? kH : a.H, R = S::kFixed ? kR : a.R;
  extern __shared__ __align__(16) float smem[];
  float x[E][NRr];
  long o[E];
  load_elements<E, NRr, S::kFixed>(a, Rr, H, x, o);  // in flight while the weights are staged
  const BiasWeights w = stage_bias_weights<false, kRr, kH, kR>(a, Rr, H, R, smem);
  __syncthreads();

  float pre[E][NH];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int h = 0; h < NH; ++h) pre[e][h] = 0.f;
#pragma unroll 4
  for (int r0 = 0; r0 < R; r0 += G) {
    float b1g[G];
    load_row<G, S::kFixed>(w.b1s + r0, G, b1g);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int r = r0 + q;
      float w1r[NRr], wrr[NH];
      load_row<NRr, S::kFixed>(w.w1s + r * Rr, Rr, w1r);
      load_row<NH, S::kFixed>(w.wrs + r * H, H, wrr);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = bias_feature(x[e], w1r, b1g[q], Rr);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          if (h < H) pre[e][h] = fmaf(t, wrr[h], pre[e][h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h)
    if (h < H) {
      const float brh = w.brs[h];
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (o[e] >= 0) a.out[o[e] + (long)h * a.plane] = logf(fmaxf(pre[e][h] + brh, kClamp));
    }
}

// grid (ceil(n / (blockDim.x E)), head groups): the features computed
// again for every head; a block takes heads blockIdx.y, + gridDim.y, ...
template <int kRr, int kH, int kR, int E>
__global__ void __launch_bounds__(kBias2Threads) probe_bias2_kernel(const BiasArgs a) {
  using S = BiasShape<kRr, kH, kR>;
  constexpr int NRr = S::NRr, G = S::G;
  const int Rr = S::kFixed ? kRr : a.Rr, H = S::kFixed ? kH : a.H, R = S::kFixed ? kR : a.R;
  extern __shared__ __align__(16) float smem[];
  float x[E][NRr];
  long o[E];
  load_elements<E, NRr, S::kFixed>(a, Rr, H, x, o);
  const BiasWeights w = stage_bias_weights<true, kRr, kH, kR>(a, Rr, H, R, smem);
  __syncthreads();

#pragma unroll 1
  for (int h = blockIdx.y; h < H; h += gridDim.y) {
    // b1 and W1 are read afresh for every head (volatile loads), so the
    // features, the same for every head, cannot be taken out of this loop
    // and computed once: that would make this kernel probe_bias
    const float* wrh = w.wrs + h * R;
    float pre[E];
#pragma unroll
    for (int e = 0; e < E; ++e) pre[e] = 0.f;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += G) {
      float b1g[G], wrg[G];
      load_row<G, S::kFixed, true>(w.b1s + r0, G, b1g);
      load_row<G, S::kFixed>(wrh + r0, G, wrg);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        float w1r[NRr];
        load_row<NRr, S::kFixed, true>(w.w1s + (r0 + q) * Rr, Rr, w1r);
#pragma unroll
        for (int e = 0; e < E; ++e)
          pre[e] = fmaf(bias_feature(x[e], w1r, b1g[q], Rr), wrg[q], pre[e]);
      }
    }
    const float brh = w.brs[h];
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (o[e] >= 0) a.out[o[e] + (long)h * a.plane] = logf(fmaxf(pre[e] + brh, kClamp));
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int kRr, int kH, int kR>
cudaError_t launch_bias(bool fresh, const BiasArgs& a, cudaStream_t s) {
  const size_t bytes = (size_t)bias_weight_floats(a.Rr, a.H, a.R) * sizeof(float);
  // the fixed instances' 3.3 KB never need the opt-in; a generic one's
  // weights above 48 KB (R over ~500) do
  cudaError_t err = cudaSuccess;
  if (fresh) {
    constexpr int kPer = kBias2Threads * kBias2E;
    const dim3 grid((a.n + kPer - 1) / kPer, a.H < kBias2Groups ? a.H : kBias2Groups);
    if (bytes > kDefaultSmem) err = opt_in(probe_bias2_kernel<kRr, kH, kR, kBias2E>, bytes);
    if (err == cudaSuccess)
      probe_bias2_kernel<kRr, kH, kR, kBias2E><<<grid, kBias2Threads, bytes, s>>>(a);
  } else {
    constexpr int kPer = kBiasThreads * kBiasE;
    const unsigned blocks = (a.n + kPer - 1) / kPer;
    if (bytes > kDefaultSmem) err = opt_in(probe_bias_kernel<kRr, kH, kR, kBiasE>, bytes);
    if (err == cudaSuccess)
      probe_bias_kernel<kRr, kH, kR, kBiasE><<<blocks, kBiasThreads, bytes, s>>>(a);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// grid (chunks, parts): rows [chunk * rows, +rows) of out = 2 plane, each
// chunk cut into parts of kSliceThreads * kPerThread elements; a block takes
// parts blockIdx.y, + gridDim.y, ... (gridDim.y is at most kMaxParts), and a
// thread kPerThread elements of a part kSliceThreads apart (coalesced,
// independent loads in flight)
constexpr int kSliceThreads = 128, kPerThread = 4, kMaxParts = 65535;

template <typename T>
__global__ void __launch_bounds__(kSliceThreads) probe_slice_kernel(const T* plane, float* out,
                                                                     int L, int rows) {
  constexpr int kPart = kSliceThreads * kPerThread;
  const int row0 = blockIdx.x * rows;
  const int n = min(rows, L - row0) * L;
  const long base = (long)row0 * L;
  for (int start = blockIdx.y * kPart; start < n; start += gridDim.y * kPart) {
    const int i0 = start + threadIdx.x;
    float v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = i0 + k * kSliceThreads;
      v[k] = i < n ? load_f32(plane, base + i) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = i0 + k * kSliceThreads;
      if (i < n) out[base + i] = v[k] * 2.f;
    }
  }
}

// out[p, r] = plane[p] w[r] + b1[r] over p < n, r < R; a thread writes V
// neighbouring r of one p, as one 16-byte store when V is 4 (R % 4 == 0)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) probe_outer_kernel(const T* plane, const T* w,
                                                                const T* b1, float* out, long n,
                                                                int R) {
  const int groups = R / V;                   // V-wide groups per p
  const long u = (long)blockIdx.x * kThreads + threadIdx.x;
  if (u >= n * groups) return;
  const long p = u / groups;
  const int r = (int)(u - p * groups) * V;
  const float x = load_f32(plane, p);
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    o[k] = __fadd_rn(__fmul_rn(x, load_f32(w, r + k)), load_f32(b1, r + k));
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(out + p * R + r) = make_float4(o[0], o[1], o[2], o[3]);
  else
    out[p * R + r] = o[0];
}

// grid (2, H): A cuts its head's slice first (the per-head block the TPU
// BlockSpec gave `kA`) and reads it from 0; B reads the whole array at
// row blockIdx.y
__global__ void probe_wrblock_a_kernel(const float* wr, float* out, int R) {
  const int b = blockIdx.x, h = blockIdx.y;
  const float* slice = wr + (long)h * R;
  for (int r = threadIdx.x; r < R; r += blockDim.x) out[((long)b * gridDim.y + h) * R + r] = slice[r];
}

__global__ void probe_wrblock_b_kernel(const float* wr, float* out, int R) {
  const int b = blockIdx.x, H = gridDim.y;
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    out[((long)b * H + blockIdx.y) * R + r] = wr[(long)blockIdx.y * R + r];
}

}  // namespace

// The bias probes, fp32. fresh = 0: probe_bias (features once per element,
// all heads); 1: probe_bias2 (features per head). Rr 4, R 64 with H 4 or
// 8 (every array on a 16-byte boundary) take the instances fixed at those
// shapes, the rest the generic one. Returns the CUDA error code of the
// launch (0 = launched); the kernel runs on `stream`.
extern "C" int mmnas_probe_bias(int fresh, const void* raw, const void* w1, const void* b1,
                                const void* wr, const void* br, void* out, int B, int H, int L,
                                int Rr, int R, void* stream) {
  if (B < 1 || H < 1 || H > kMaxH || L < 1 || Rr < 1 || Rr > kMaxRr || R < 1 ||
      (long)B * L * L > kMaxBiasElements)
    return cudaErrorInvalidValue;
  const BiasArgs a{static_cast<const float*>(raw), static_cast<const float*>(w1),
                   static_cast<const float*>(b1), static_cast<const float*>(wr),
                   static_cast<const float*>(br), static_cast<float*>(out), B * L * L, L * L, H,
                   Rr, R};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(w1) |
                          reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(wr) |
                          reinterpret_cast<uintptr_t>(br);
  const bool fixed = Rr == 4 && R == 64 && bases % 16 == 0;
  if (fixed && H == 8) return launch_bias<4, 8, 64>(fresh, a, s);
  if (fixed && H == 4) return launch_bias<4, 4, 64>(fresh, a, s);
  return launch_bias<0, 0, 0>(fresh, a, s);
}

// dtype: 0 = float32, 1 = bfloat16 plane; out fp32 [L, L] in `chunks` row chunks.
extern "C" int mmnas_probe_slice(int dtype, const void* plane, void* out, int L, int chunks,
                                 void* stream) {
  if (L < 1 || chunks < 1 || chunks > L || (long)L * L > (1L << 30)) return cudaErrorInvalidValue;
  const int rows = (L + chunks - 1) / chunks;
  const int per_block = kSliceThreads * kPerThread;
  const int parts = (rows * L + per_block - 1) / per_block;
  const dim3 grid(chunks, parts < kMaxParts ? parts : kMaxParts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    probe_slice_kernel<float><<<grid, kSliceThreads, 0, s>>>(static_cast<const float*>(plane),
                                                             static_cast<float*>(out), L, rows);
  else if (dtype == 1)
    probe_slice_kernel<__nv_bfloat16><<<grid, kSliceThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(plane), static_cast<float*>(out), L, rows);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
void launch_outer(const void* plane, const void* w, const void* b1, void* out, long n, int R,
                  cudaStream_t s) {
  // 16-byte stores need R % 4 == 0 and out on a 16-byte boundary
  const bool wide = R % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long units = n * (wide ? R / 4 : R);
  const unsigned blocks = (unsigned)((units + kThreads - 1) / kThreads);
  const T *pp = static_cast<const T*>(plane), *wp = static_cast<const T*>(w),
          *bp = static_cast<const T*>(b1);
  float* op = static_cast<float*>(out);
  if (wide)
    probe_outer_kernel<T, 4><<<blocks, kThreads, 0, s>>>(pp, wp, bp, op, n, R);
  else
    probe_outer_kernel<T, 1><<<blocks, kThreads, 0, s>>>(pp, wp, bp, op, n, R);
}

// dtype as above for plane [n], w [R], b1 [R]; out fp32 [n, R].
extern "C" int mmnas_probe_outer(int dtype, const void* plane, const void* w, const void* b1,
                                 void* out, long n, int R, void* stream) {
  if (n < 1 || R < 1 || n * R > (1L << 38)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_outer<float>(plane, w, b1, out, n, R, s);
  else if (dtype == 1)
    launch_outer<__nv_bfloat16>(plane, w, b1, out, n, R, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// Wr [H, R] fp32 -> out [2, H, R]; variant 0 = A (per-head slice), 1 = B
// (whole array, dynamic index).
extern "C" int mmnas_probe_wrblock(int variant, const void* wr, void* out, int H, int R,
                                   void* stream) {
  if (H < 1 || H > 65535 || R < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(2, H);
  const int threads = R < 1024 ? ((R + 31) / 32) * 32 : 1024;
  if (variant == 0)
    probe_wrblock_a_kernel<<<grid, threads, 0, s>>>(static_cast<const float*>(wr),
                                                     static_cast<float*>(out), R);
  else if (variant == 1)
    probe_wrblock_b_kernel<<<grid, threads, 0, s>>>(static_cast<const float*>(wr),
                                                     static_cast<float*>(out), R);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// An empty kernel of one block of 32 threads: its device time is the least
// any launch takes, the floor under the toy-size probes (probe_wrblock's
// 2x8x64 copy). Returns the CUDA error code of the launch.
extern "C" int mmnas_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
