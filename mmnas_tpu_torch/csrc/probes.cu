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
//    Here one block per (b, chunk of query rows) computes each element's
//    features once and all H heads from them, in registers.
// 2. probe_bias2 (`kernel`, _probe_bias2.py:13): the same chain with the
//    features recomputed per head. One block per (b, h, chunk of rows)
//    calls `relation_pre`, the per-head form of the chain.
//    Both kernels build the chain from attention_common.cuh's
//    `relation_feature`, with the same operations in the same order per
//    head, so they give equal bits, and the attention kernels' scores carry
//    the same bias bits. That is what the probes check.
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
// What bounds them on this card: at their shapes (at most 8 x 8 x 100 x 100
// outputs) they are a few microseconds of work, so the launch itself does.
// Of the work, the bias probes are bound by their fp32 FMAs (2 R Rr + 2 H R
// per element for probe_bias, H times the features for probe_bias2), the
// slice, outer and wrblock probes by their bytes.

#include "attention_common.cuh"

namespace {

using namespace mmnas;

constexpr int kThreads = 256;
constexpr int kRows = 4;    // query rows per block of the bias probes

struct BiasArgs {
  const float* raw;  // [B, L, L, Rr]
  const float* w1;   // [R, Rr]
  const float* b1;   // [R]
  const float* wr;   // [H, R]
  const float* br;   // [H]
  float* out;        // [B, H, L, L]
  int H, L, Rr, R;
};

// shared memory: the chain's weights (attention_common.cuh's layouts)
size_t bias_smem_bytes(int R) { return (size_t)chain_weight_floats(R) * sizeof(float); }

// grid (row chunks, B): features once per element, all heads
__global__ void __launch_bounds__(kThreads) probe_bias_kernel(const BiasArgs a) {
  extern __shared__ __align__(16) float smem[];
  load_chain_weights(a.w1, a.b1, a.wr, a.br, a.Rr, a.R, a.H, smem);
  __syncthreads();
  const int b = blockIdx.y, L = a.L, row0 = blockIdx.x * kRows;
  const int E = min(kRows, L - row0) * L;
  const long plane = (long)L * L;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const long ij = (long)row0 * L + e;
    float x[1][kMaxRr], pre[1][kMaxH];
    load_raw(a.raw + ((long)b * plane + ij) * a.Rr, a.Rr, x[0]);
    relation_pre_heads<1>(x, a.Rr, a.R, a.H, smem, pre);
#pragma unroll
    for (int h = 0; h < kMaxH; ++h)
      if (h < a.H) a.out[((long)b * a.H + h) * plane + ij] = logf(fmaxf(pre[0][h], kClamp));
  }
}

// grid (row chunks, H, B): features recomputed per head
__global__ void __launch_bounds__(kThreads) probe_bias2_kernel(const BiasArgs a) {
  extern __shared__ __align__(16) float smem[];
  load_chain_weights(a.w1, a.b1, a.wr, a.br, a.Rr, a.R, a.H, smem);
  __syncthreads();
  const int h = blockIdx.y, b = blockIdx.z, L = a.L, row0 = blockIdx.x * kRows;
  const int E = min(kRows, L - row0) * L;
  const long plane = (long)L * L;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const long ij = (long)row0 * L + e;
    const float pre = relation_pre(a.raw + ((long)b * plane + ij) * a.Rr, a.Rr, a.R, smem, h);
    a.out[((long)b * a.H + h) * plane + ij] = logf(fmaxf(pre, kClamp));
  }
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

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// The bias probes, fp32. fresh = 0: probe_bias (features once per element,
// all heads); 1: probe_bias2 (features per head). Returns the CUDA error code
// of the launch (0 = launched); the kernel runs on `stream`.
extern "C" int mmnas_probe_bias(int fresh, const void* raw, const void* w1, const void* b1,
                                const void* wr, const void* br, void* out, int B, int H, int L,
                                int Rr, int R, void* stream) {
  if (B < 1 || H < 1 || H > kMaxH || L < 1 || Rr < 1 || Rr > kMaxRr || R < 1)
    return cudaErrorInvalidValue;
  const BiasArgs a{static_cast<const float*>(raw), static_cast<const float*>(w1),
                   static_cast<const float*>(b1), static_cast<const float*>(wr),
                   static_cast<const float*>(br), static_cast<float*>(out), H, L, Rr, R};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = bias_smem_bytes(R);
  const int chunks = (L + kRows - 1) / kRows;
  cudaError_t err;
  if (fresh == 0) {
    if ((err = opt_in(probe_bias_kernel, bytes)) != cudaSuccess) return err;
    probe_bias_kernel<<<dim3(chunks, B), kThreads, bytes, s>>>(a);
  } else {
    if ((err = opt_in(probe_bias2_kernel, bytes)) != cudaSuccess) return err;
    probe_bias2_kernel<<<dim3(chunks, H, B), kThreads, bytes, s>>>(a);
  }
  return cudaGetLastError();
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
