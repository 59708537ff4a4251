// SSD (Mamba-2) chunked scan with B/C shared across heads, forward or
// reverse, for Hopper (sm_90a).
//
// Replaces the TPU kernels video_enhancer_tpu/ops/ssd.py
// _ssd_shared_pallas_batched_impl -> _ssd_batched_kernel (pallas_call at
// ssd.py:325) and _ssd_shared_pallas_impl -> _ssd_kernel (ssd.py:382). The
// TPU runs the chunk axis as a sequential grid and carries the (N, H*P)
// state in VMEM scratch from one chunk to the next.
//
// What bounds it on an H100: at the VSRM shape (b=7, L=57600, H=2, P=64,
// N=16, bf16) the function reads x, dt, B, C and writes y, ~0.24 GB, about
// 70 us at 3.35 TB/s; its chunked-matmul form needs ~11 GFLOP, a few us at
// the bf16 tensor rate. So it is bound by bytes.
//
// Design. Blocks on the card run in parallel and in no order, and b*H is 14
// sequences for 132 SMs, so the chunk loop is not kept inside a block.
// Instead the standard three-phase chunked form, three launches on one
// stream:
//   1. chunk_state: one block per (chunk, head, batch) computes its chunk's
//      own end state S_k = (B o e^(G-g))^T (dt x)  (N x P) and the chunk's
//      total log-decay G_k.
//   2. state_pass: one thread per (batch, head, n, p) walks the chunks in
//      scan order and overwrites each S_k with the state entering chunk k.
//   3. chunk_output: one block per (chunk, head, batch) computes
//      y = ((C B^T) o e^(g_q - g_s) o mask) (dt x) + (C o e^g) S_in
//      as one (Q x (Q+N)) @ ((Q+N) x P) product from shared memory.
// g is the inclusive prefix sum of dt*a inside the chunk (suffix sum for
// reverse, with the transposed mask and the chunks walked back to front), so
// every exponent is <= 0. The grid has b*H*ceil(L/64) blocks (12600 at the
// VSRM shape). The price is the chunk states round-tripping device memory
// (~51 MB at the VSRM shape) and x read twice. All arithmetic is fp32 on
// CUDA cores; the ragged last chunk is masked (dt = 0 there, an exact
// passthrough). No wgmma/TMA yet.
//
// Layouts: x (b, L, H*P) with row stride ldx; dt (b, L, H) fp32 contiguous;
// A (H,) fp32; B, C (b, L, N) with row strides ldb, ldc; y (b, L, H*P)
// contiguous. Scratch: states (b, H, K, N, P) fp32, decay (b, H, K) fp32.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int Q = 64;          // chunk length (two elements per lane of a warp)
constexpr int THREADS = 256;   // phases 1 and 3
constexpr int PASS_THREADS = 128;
constexpr int PASS_UNROLL = 8;

// dt of the chunk's rows into dts[], and the inclusive prefix (forward) or
// suffix (reverse) sums of dt*a into g[]. Ends with __syncthreads().
__device__ void load_chunk_decay(const float* __restrict__ dt, float a, int bi,
                                 int h, int H, int L, int t0, int reverse,
                                 float* dts, float* g) {
  const int tid = threadIdx.x;
  if (tid < Q) {
    const int t = t0 + tid;
    dts[tid] = t < L ? dt[((size_t)bi * L + t) * H + h] : 0.0f;
  }
  __syncthreads();
  if (tid < 32) {
    // lane holds scan positions 2*lane and 2*lane+1
    const int i0 = 2 * tid, i1 = i0 + 1;
    const int j0 = reverse ? Q - 1 - i0 : i0;
    const int j1 = reverse ? Q - 1 - i1 : i1;
    const float a0 = dts[j0] * a, a1 = dts[j1] * a;
    float s = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, s, off);
      if (tid >= off) s += o;
    }
    const float before = s - (a0 + a1);
    g[j0] = before + a0;
    g[j1] = before + a0 + a1;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ decay,
                       int L, int H, int P, int N, int K, long ldx, long ldb,
                       int reverse) {
  extern __shared__ float smem[];
  float* dts = smem;             // Q
  float* g = dts + Q;            // Q
  float* Bw = g + Q;             // Q x N: B_s[n] * e^(G - g_s)
  float* xd = Bw + Q * N;        // Q x P: dt_s * x_s[p]

  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = k * Q;
  load_chunk_decay(dt, A[h], bi, h, H, L, t0, reverse, dts, g);
  const float G = reverse ? g[0] : g[Q - 1];

  for (int i = tid; i < Q * N; i += THREADS) {
    const int s = i / N, n = i - s * N, t = t0 + s;
    const float bv = t < L ? to_f32(Bm[((size_t)bi * L + t) * ldb + n]) : 0.0f;
    Bw[i] = bv * expf(G - g[s]);
  }
  for (int i = tid; i < Q * P; i += THREADS) {
    const int s = i / P, p = i - s * P, t = t0 + s;
    const float xv =
        t < L ? to_f32(x[((size_t)bi * L + t) * ldx + (size_t)h * P + p]) : 0.0f;
    xd[i] = xv * dts[s];
  }
  __syncthreads();

  const size_t bhk = ((size_t)bi * H + h) * K + k;
  float* out = states + bhk * N * P;
  for (int i = tid; i < N * P; i += THREADS) {
    const int n = i / P, p = i - n * P;
    float acc = 0.0f;
#pragma unroll 8
    for (int s = 0; s < Q; ++s) acc += Bw[s * N + n] * xd[s * P + p];
    out[i] = acc;
  }
  if (tid == 0) decay[bhk] = G;
}

// states[b, h, k] := state entering chunk k (in scan order); in place.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      int BH, int K, int NP, int reverse) {
  const long e = (long)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= (long)BH * NP) return;
  const int bh = (int)(e / NP), j = (int)(e - (long)bh * NP);
  float* s = states + (size_t)bh * K * NP + j;
  const float* dc = decay + (size_t)bh * K;
  float run = 0.0f;
  for (int i0 = 0; i0 < K; i0 += PASS_UNROLL) {
    float v[PASS_UNROLL], d[PASS_UNROLL];
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      const int i = i0 + u;
      if (i < K) {
        const int k = reverse ? K - 1 - i : i;
        v[u] = s[(size_t)k * NP];
        d[u] = dc[k];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      const int i = i0 + u;
      if (i < K) {
        const int k = reverse ? K - 1 - i : i;
        s[(size_t)k * NP] = run;
        run = expf(d[u]) * run + v[u];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const float* __restrict__ states,
                        T* __restrict__ y, int L, int H, int P, int N, int K,
                        long ldx, long ldb, long ldc, int reverse) {
  extern __shared__ float smem[];
  const int J = Q + N;           // reduction length: Q intra terms, N state terms
  float* dts = smem;             // Q
  float* g = dts + Q;            // Q
  float* Bt = g + Q;             // N x Q (transposed: conflict-free C.B)
  float* Cs = Bt + N * Q;        // Q x N
  float* W = Cs + Q * N;         // Q x J
  float* X = W + Q * J;          // J x P: rows s < Q are dt_s x_s, then S_in

  const int k = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = k * Q;
  load_chunk_decay(dt, A[h], bi, h, H, L, t0, reverse, dts, g);

  for (int i = tid; i < Q * N; i += THREADS) {
    const int s = i / N, n = i - s * N, t = t0 + s;
    const size_t row = (size_t)bi * L + t;
    Bt[n * Q + s] = t < L ? to_f32(Bm[row * ldb + n]) : 0.0f;
    Cs[i] = t < L ? to_f32(Cm[row * ldc + n]) : 0.0f;
  }
  for (int i = tid; i < Q * P; i += THREADS) {
    const int s = i / P, p = i - s * P, t = t0 + s;
    const float xv =
        t < L ? to_f32(x[((size_t)bi * L + t) * ldx + (size_t)h * P + p]) : 0.0f;
    X[i] = xv * dts[s];
  }
  const float* s_in = states + (((size_t)bi * H + h) * K + k) * N * P;
  for (int i = tid; i < N * P; i += THREADS) X[Q * P + i] = s_in[i];
  __syncthreads();

  for (int i = tid; i < Q * J; i += THREADS) {
    const int q = i / J, j = i - q * J;
    float w;
    if (j < Q) {
      const bool keep = reverse ? (j >= q) : (j <= q);
      w = 0.0f;
      if (keep) {
        float cb = 0.0f;
        for (int n = 0; n < N; ++n) cb += Cs[q * N + n] * Bt[n * Q + j];
        w = cb * expf(g[q] - g[j]);
      }
    } else {
      w = Cs[q * N + (j - Q)] * expf(g[q]);
    }
    W[i] = w;
  }
  __syncthreads();

  // 16 x 16 threads, each a 4 x 4 tile: rows q = ty + 16r, columns p = tx + 16c.
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int j = 0; j < J; ++j) {
    float wv[4], xv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wv[r] = W[(ty + 16 * r) * J + j];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      xv[c] = p < P ? X[j * P + p] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += wv[r] * xv[c];
  }
  const int HP = H * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= L) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (p < P) y[((size_t)bi * L + t) * HP + (size_t)h * P + p] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* states, float* decay, int b, int L,
           int H, int P, int N, long ldx, long ldb, long ldc, int reverse,
           cudaStream_t stream) {
  const int K = (L + Q - 1) / Q;
  const dim3 grid(K, H, b);
  const size_t smem1 = sizeof(float) * (2 * Q + Q * N + Q * P);
  const size_t smem3 =
      sizeof(float) * (2 * Q + 2 * Q * N + Q * (Q + N) + (Q + N) * P);
  cudaError_t err;
  if ((err = allow_smem(ssd_chunk_state_kernel<T>, smem1)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_chunk_output_kernel<T>, smem3)) != cudaSuccess) return err;

  ssd_chunk_state_kernel<T><<<grid, THREADS, smem1, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), states, decay,
      L, H, P, N, K, ldx, ldb, reverse);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long total = (long)b * H * N * P;
  const int pass_blocks = (int)((total + PASS_THREADS - 1) / PASS_THREADS);
  ssd_state_pass_kernel<<<pass_blocks, PASS_THREADS, 0, stream>>>(
      states, decay, b * H, K, N * P, reverse);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_chunk_output_kernel<T><<<grid, THREADS, smem3, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), states, static_cast<T*>(y), L, H, P, N, K, ldx,
      ldb, ldc, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vetk_error_string(int err) {
  if (err >= vetk::kTensorMapError)
    return "cuTensorMapEncodeTiled failed (the code less 100000 is its CUresult; "
           "0: the driver has no such entry point)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Chunk length of the kernel; the wrapper sizes the scratch with it.
int vetk_ssd_chunk() { return Q; }

// Returns a cudaError_t (0 on success). Requires P <= 64.
int vetk_ssd_shared(int dtype, const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* states,
                    void* decay, int b, int L, int H, int P, int N, long ldx,
                    long ldb, long ldc, int reverse, void* stream) {
  if (P > 64 || P < 1 || N < 1 || L < 1 || b < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto dtf = static_cast<const float*>(dt);
  auto Af = static_cast<const float*>(A);
  auto sf = static_cast<float*>(states);
  auto df = static_cast<float*>(decay);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N, ldx, ldb,
                           ldc, reverse, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N,
                                   ldx, ldb, ldc, reverse, st);
    case kFloat16:
      return launch<__half>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N, ldx, ldb,
                            ldc, reverse, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
