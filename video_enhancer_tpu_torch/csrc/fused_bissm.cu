// The whole interior of the bidirectional shared-stream SSM (bissm) for
// short sequences, in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel video_enhancer_tpu/ops/scan.py
// fused_bidir_ssm -> _fused_bissm_impl -> _fused_bissm_kernel (pallas_call at
// scan.py:941): depthwise conv (SAME, bias), SiLU, x_proj (D -> dt_rank+2N),
// dt_proj with bias, softplus with a dt bias per direction, a forward and a
// reverse selective scan over the shared u/B/C streams with their own A and
// D skip, their sum, times SiLU(gate). None of the intermediates reaches
// device memory.
//
// What bounds it on an H100: at the VSRM temporal shape (B=57600 sequences,
// L=7, D=128, N=4, dt_rank=4, bf16) it reads u_pre and gate and writes y,
// ~0.31 GB, about 92 us at 3.35 TB/s; its ~3 GFLOP of elementwise fp32 work
// (a quarter of it exp/log on the special-function units) is below that at
// the CUDA-core rate. So it is bound by bytes.
//
// Design: one block of D threads, one thread per channel, walks a strided
// set of sequences; the per-channel weights sit in registers and the x_proj
// weight in shared memory, loaded once per block. Per sequence:
//   1. conv + SiLU for every step, thread-local, into shared xs[L][D];
//   2. the L*(dt_rank+2N) x_proj dot products over D, one per thread, from
//      shared memory (row stride D+1 keeps the banks apart);
//   3. the forward scan with the N-state in registers, stashing dt_b and the
//      forward output for the reverse pass;
//   4. the reverse scan, the D skips, times SiLU(gate), one store per step.
// A TPU grid step held a (L, 128, D) block in VMEM; here the sequence is
// short enough (L <= 32) that one sequence's stash fits a block's shared
// memory. No tensor cores: the products are 12 outputs wide.
//
// Layouts: u_pre, gate (B, L, D) with row strides ldu, ldg (the two halves
// of in_proj's output); y (B, L, D) contiguous; cw (D, K); cb, bdt, dtbf,
// dtbb, Df, Db (D,); wx (R, D) with R = dt_rank + 2N; wdt (D, dt_rank);
// Af, Ab (D, N). Weights are fp32.

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int MAX_N = 16;
constexpr int MAX_K = 8;
constexpr int MAX_RANK = 16;
constexpr int MAX_D = 256;     // threads per block: one per channel

template <typename T>
__global__ void __launch_bounds__(MAX_D)
fused_bissm_kernel(const T* __restrict__ u, const T* __restrict__ gate,
                   const float* __restrict__ cw, const float* __restrict__ cb,
                   const float* __restrict__ wx, const float* __restrict__ wdt,
                   const float* __restrict__ bdt, const float* __restrict__ dtbf,
                   const float* __restrict__ dtbb, const float* __restrict__ Af,
                   const float* __restrict__ Ab, const float* __restrict__ Df,
                   const float* __restrict__ Db, T* __restrict__ y, int B, int L,
                   int D, int N, int K, int dt_rank, long ldu, long ldg) {
  extern __shared__ float smem[];
  const int R = dt_rank + 2 * N;
  const int DS = D + 1;          // padded row stride
  float* wxs = smem;             // R x DS
  float* xs = wxs + R * DS;      // L x DS: SiLU(conv) per step
  float* dtbs = xs + L * DS;     // L x DS: reverse-direction dt
  float* accs = dtbs + L * DS;   // L x DS: forward output + D_f skip
  float* proj = accs + L * DS;   // L x R

  const int d = threadIdx.x;
  for (int i = d; i < R * D; i += D) wxs[(i / D) * DS + i % D] = wx[i];

  float cwr[MAX_K], wdtr[MAX_RANK], af[MAX_N], ab[MAX_N];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) cwr[j] = j < K ? cw[d * K + j] : 0.0f;
#pragma unroll
  for (int r = 0; r < MAX_RANK; ++r) wdtr[r] = r < dt_rank ? wdt[d * dt_rank + r] : 0.0f;
#pragma unroll
  for (int n = 0; n < MAX_N; ++n) {
    af[n] = n < N ? Af[d * N + n] : 0.0f;
    ab[n] = n < N ? Ab[d * N + n] : 0.0f;
  }
  const float cbd = cb[d], bdtd = bdt[d], fbias = dtbf[d], bbias = dtbb[d];
  const float dfd = Df[d], dbd = Db[d];
  const int lo = (K - 1) / 2;     // XLA SAME padding: lo = (K-1)//2
  __syncthreads();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* ub = u + (size_t)b * L * ldu;
    // 1. depthwise conv + SiLU
    for (int t = 0; t < L; ++t) {
      float conv = cbd;
#pragma unroll
      for (int j = 0; j < MAX_K; ++j) {
        const int tt = t + j - lo;
        if (j < K && tt >= 0 && tt < L) conv += to_f32(ub[(size_t)tt * ldu + d]) * cwr[j];
      }
      xs[t * DS + d] = silu(conv);
    }
    __syncthreads();
    // 2. x_proj: proj[t][r] = sum_c xs[t][c] * wx[r][c]
    for (int i = d; i < L * R; i += D) {
      const int t = i / R, r = i - t * R;
      const float* xr = xs + t * DS;
      const float* wr = wxs + r * DS;
      float acc = 0.0f;
      for (int c = 0; c < D; ++c) acc += xr[c] * wr[c];
      proj[i] = acc;
    }
    __syncthreads();
    // 3. forward scan
    float h[MAX_N];
#pragma unroll
    for (int n = 0; n < MAX_N; ++n) h[n] = 0.0f;
    for (int t = 0; t < L; ++t) {
      const float* pr = proj + t * R;
      float dtp = bdtd;
#pragma unroll
      for (int r = 0; r < MAX_RANK; ++r)
        if (r < dt_rank) dtp += pr[r] * wdtr[r];
      const float dtf = softplus(dtp + fbias);
      dtbs[t * DS + d] = softplus(dtp + bbias);
      const float xv = xs[t * DS + d];
      float yv = xv * dfd;
#pragma unroll
      for (int n = 0; n < MAX_N; ++n) {
        if (n < N) {
          h[n] = expf(dtf * af[n]) * h[n] + dtf * xv * pr[dt_rank + n];
          yv += h[n] * pr[dt_rank + N + n];
        }
      }
      accs[t * DS + d] = yv;
    }
    // 4. reverse scan, gate, store
#pragma unroll
    for (int n = 0; n < MAX_N; ++n) h[n] = 0.0f;
    const T* gb = gate + (size_t)b * L * ldg;
    T* yb = y + (size_t)b * L * D;
    for (int t = L - 1; t >= 0; --t) {
      const float* pr = proj + t * R;
      const float dtb = dtbs[t * DS + d];
      const float xv = xs[t * DS + d];
      float yv = accs[t * DS + d] + xv * dbd;
#pragma unroll
      for (int n = 0; n < MAX_N; ++n) {
        if (n < N) {
          h[n] = expf(dtb * ab[n]) * h[n] + dtb * xv * pr[dt_rank + n];
          yv += h[n] * pr[dt_rank + N + n];
        }
      }
      const float gv = to_f32(gb[(size_t)t * ldg + d]);
      yb[(size_t)t * D + d] = from_f32<T>(yv * silu(gv));
    }
    __syncthreads();  // xs and proj are rewritten by the next sequence
  }
}

template <typename T>
int launch(const void* u, const void* gate, const float* const* w, void* y, int B,
           int L, int D, int N, int K, int dt_rank, long ldu, long ldg, int blocks,
           cudaStream_t stream) {
  const int R = dt_rank + 2 * N;
  const size_t smem = sizeof(float) * ((size_t)(R + 3 * L) * (D + 1) + (size_t)L * R);
  cudaError_t err = allow_smem(fused_bissm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  fused_bissm_kernel<T><<<blocks, D, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(gate), w[0], w[1], w[2], w[3],
      w[4], w[5], w[6], w[7], w[8], w[9], w[10], static_cast<T*>(y), B, L, D, N, K,
      dt_rank, ldu, ldg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Requires D <= 256, N <= 16,
// K <= 8, dt_rank <= 16; `blocks` is the grid size (each block strides over
// the B sequences).
int vetk_fused_bissm(int dtype, const void* u, const void* gate, const void* cw,
                     const void* cb, const void* wx, const void* wdt,
                     const void* bdt, const void* dtbf, const void* dtbb,
                     const void* Af, const void* Ab, const void* Df,
                     const void* Db, void* y, int B, int L, int D, int N, int K,
                     int dt_rank, long ldu, long ldg, int blocks, void* stream) {
  if (D < 1 || D > MAX_D || N < 1 || N > MAX_N || K < 1 || K > MAX_K ||
      dt_rank < 1 || dt_rank > MAX_RANK || L < 1 || B < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const float* w[11] = {
      static_cast<const float*>(cw),   static_cast<const float*>(cb),
      static_cast<const float*>(wx),   static_cast<const float*>(wdt),
      static_cast<const float*>(bdt),  static_cast<const float*>(dtbf),
      static_cast<const float*>(dtbb), static_cast<const float*>(Af),
      static_cast<const float*>(Ab),   static_cast<const float*>(Df),
      static_cast<const float*>(Db)};
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(u, gate, w, y, B, L, D, N, K, dt_rank, ldu, ldg, blocks, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(u, gate, w, y, B, L, D, N, K, dt_rank, ldu, ldg,
                                   blocks, st);
    case kFloat16:
      return launch<__half>(u, gate, w, y, B, L, D, N, K, dt_rank, ldu, ldg, blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
