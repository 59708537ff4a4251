// SSD (Mamba-2) chunked scan with B/C shared across heads, forward or
// reverse, for Hopper (sm_90a).
//
// Replaces the TPU kernels video_enhancer_tpu/ops/ssd.py
// _ssd_shared_pallas_batched_impl -> _ssd_batched_kernel (pallas_call at
// ssd.py:325) and _ssd_shared_pallas_impl -> _ssd_kernel (ssd.py:382). The
// TPU runs the chunk axis as a sequential grid, carries the (N, H*P) state
// in VMEM scratch from one chunk to the next, hoists C B^T out of its head
// loop and multiplies on the MXU with fp32 sums, rounding W, dt x, C o e^g,
// the entering state and B o e^(G-g) to x's dtype (ssd.py:218-236).
//
// What bounds it on an H100: at the VSRM shape (b=7, L=57600, H=2, P=64,
// N=16, bf16) the function reads x, dt, B, C and writes y, ~0.24 GB, about
// 70 us at 3.35 TB/s; its chunked-matmul form needs ~11 GFLOP, a few us at
// the bf16 tensor rate. So it is bound by bytes.
//
// Within a chunk of Q = 64 steps, g is the inclusive prefix sum of dt*a (the
// suffix sum for reverse, with the transposed mask and the chunks walked
// back to front), so every exponent is <= 0:
//   y      = ((C B^T) o e^(g_q - g_s) o mask) (dt x) + (C o e^g) S_in
//   S_out  = e^G S_in + (B o e^(G - g))^T (dt x)
// The ragged last chunk is zero-filled (dt = 0 there, an exact passthrough).
//
// Tensor-core path (bf16, fp16; P a multiple of 16 up to 64, H*P <= 128,
// N <= 16), three launches on one stream:
//   1. run_state: one block of four warps per (run of R consecutive chunks,
//      batch), both heads, walks its chunks in scan order from a zero state
//      and writes the run's end state (fp32) and total log-decay;
//   2. state_pass: one thread per (batch, head, n, p) walks the runs in
//      scan order and overwrites each run's state with the state entering
//      it (M = K / R runs, not K chunks: 17x fewer dependent steps at the
//      VSRM shape);
//   3. run_output: the same blocks walk their chunks again from the
//      entering state, carrying the fp32 state on chip as the TPU kernel's
//      sequential grid does, and write y.
// Every product is mma.sync m16n8k16 with fp32 accumulators, its operands
// fed by ldmatrix from shared memory and rounded to x's dtype where the TPU
// kernel rounds them: C B^T (computed a k-step at a time beside the W
// fragment it feeds, which stays in registers as the next product's A
// operand), W (dt x), (C o e^g) S_in and (B o e^(G-g))^T (dt x). Only the
// tiles of W the causal mask keeps are computed; warp w takes row tile w of
// even heads and 3 - w of odd ones, so the four warps do equal work. Each
// block holds two stages of (x, B, C, dt) and loads the next chunk by
// 16-byte cp.async while it computes the current one (x, B and C are read
// in place as column slices of the conv output; element loads when a
// pointer or stride is not 16-byte aligned). The exps are ex2 on log-decays
// pre-scaled by log2 e. R is chosen by the wrapper (ops/ssd.py _ssd_plan)
// so that the b * ceil(K / R) blocks fill one wave of the card.
//
// CUDA-core path (fp32, and half types outside the tensor-core domain): one
// block per (chunk, head, batch) computes its chunk's own state, one thread
// per (batch, head, n, p) walks the K chunks, one block per chunk computes
// y as one (Q x (Q+N)) @ ((Q+N) x P) product from shared memory, all in
// fp32 (ssd_shared's dtype rule sends fp32 to the plain form on the served
// path, so fp32 keeps the exactness of fp32 sums rather than TF32's).
//
// Layouts: x (b, L, H*P) with row stride ldx; dt (b, L, H) fp32 contiguous;
// A (H,) fp32; B, C (b, L, N) with row strides ldb, ldc; y (b, L, H*P)
// contiguous. Scratch: states (b, H, runs, N, P) fp32, decay (b, H, runs)
// fp32, with runs = ceil(K / R) on the tensor-core path and K on the
// CUDA-core path.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int Q = 64;          // chunk length (two elements per lane of a warp)
constexpr int THREADS = 256;   // CUDA-core phases 1 and 3
constexpr int PASS_THREADS = 128;
constexpr int PASS_UNROLL = 8;

// ---------------------------------------------------------------------------
// CUDA-core path (fp32, and half types outside the tensor-core domain)
// ---------------------------------------------------------------------------

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
int launch_simt(const void* x, const float* dt, const float* A, const void* Bm,
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

// ---------------------------------------------------------------------------
// Tensor-core path (bf16, fp16)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;     // four warps
constexpr int TC_MIN_BLOCKS = 3;    // blocks an SM the registers must allow
constexpr int TC_MAX_HP = 128;      // H * P a block holds
constexpr int BC_LD = 24;           // B / C tile row: 16 states + 8 pad (48 B)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Byte offsets into the dynamic shared memory of the tensor-core kernels
// (ops/ssd.py _ssd_smem mirrors the sum).
struct TcLayout {
  int x_ld;                // elements a row of the x tile: H*P + 8
  int xs, bs, cs, ds;      // inside a stage: x, B, C (rows of BC_LD), dt
  int stage;               // bytes a stage
  int bg, cg, sb, ys, g2;  // B o e^(G-g), C o e^g (per head), S_in, y rows
                           // of each warp, log2 decays
  int total;
};

__host__ __device__ inline TcLayout tc_layout(int H, int P) {
  TcLayout l;
  l.x_ld = H * P + 8;
  l.xs = 0;
  l.bs = Q * l.x_ld * 2;
  l.cs = l.bs + Q * BC_LD * 2;
  l.ds = l.cs + Q * BC_LD * 2;
  l.stage = l.ds + Q * H * 4;
  l.bg = 2 * l.stage;
  l.cg = l.bg + H * Q * BC_LD * 2;
  l.sb = l.cg + H * Q * BC_LD * 2;
  l.ys = l.sb + H * 16 * (P + 8) * 2;
  l.g2 = l.ys + 4 * 16 * (P + 8) * 2;
  // g2: H x Q prefix sums, then H chunk totals, then H run totals
  l.total = (l.g2 + (H * Q + 2 * H) * 4 + 15) / 16 * 16;
  return l;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int NG>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NG) : "memory");
}

template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};
template <> struct Pack<__half> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

// d += a * b for one m16n8k16 tile, fp32 accumulators. Not volatile: a
// product touches registers only, so the compiler may interleave the
// products of one k-step with the loads and exps of the next.
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d, const uint32_t* a,
                                                        uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t* a,
                                                 uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. `trans` hands each thread a column pair instead of
// a row pair.
template <bool trans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

template <typename T>
struct TcArgs {
  const T* x;
  const float* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  float* states;   // (b, H, M, N, P)
  float* decay;    // (b, H, M), natural log
  T* y;
  int L, H, P, N, K, R, M;
  long ldx, ldb, ldc;
  int reverse, vec;
};

// Chunk k of batch bi into a stage: x (Q rows of H*P), B and C (Q rows of
// 16, zero past N; C only when kOut), dt (Q x H fp32), all zero past L.
template <typename T, bool kOut>
__device__ __forceinline__ void tc_load(const TcArgs<T>& a, const TcLayout& l,
                                        char* stage, int bi, int k) {
  T* xs = reinterpret_cast<T*>(stage + l.xs);
  T* bs = reinterpret_cast<T*>(stage + l.bs);
  T* cs = reinterpret_cast<T*>(stage + l.cs);
  float* ds = reinterpret_cast<float*>(stage + l.ds);
  const int HP = a.H * a.P, t0 = k * Q, tid = threadIdx.x;
  const size_t row0 = (size_t)bi * a.L;
  if (a.vec) {
    const int segs = HP / 8;
    for (int i = tid; i < Q * segs; i += TC_THREADS) {
      const int s = i / segs, c = i - s * segs, t = t0 + s;
      const bool ok = t < a.L;
      cp_async16(xs + s * l.x_ld + c * 8, a.x + (row0 + (ok ? t : 0)) * a.ldx + c * 8,
                 ok ? 16 : 0);
    }
    // B (and C) rows: two 16-byte segments each
    for (int i = tid; i < Q * (kOut ? 4 : 2); i += TC_THREADS) {
      const int which = kOut ? (i >> 1) & 1 : 0;
      const int row = kOut ? i >> 2 : i >> 1, c = i & 1, t = t0 + row;
      const bool ok = t < a.L && c * 8 < a.N;
      const T* src = which ? a.Cm : a.Bm;
      const long ld = which ? a.ldc : a.ldb;
      cp_async16((which ? cs : bs) + row * BC_LD + c * 8,
                 src + (row0 + (ok ? t : 0)) * ld + (ok ? c * 8 : 0), ok ? 16 : 0);
    }
    const long valid = (long)min(Q, a.L - t0) * a.H;   // dt floats in range
    for (int i = tid; i < Q * a.H / 4; i += TC_THREADS) {
      const long e = 4L * i;
      const int bytes = (int)max(0L, min(4L, valid - e)) * 4;
      cp_async16(ds + e, a.dt + (row0 + t0) * a.H + (bytes ? e : 0), bytes);
    }
  } else {
    const T zero = from_f32<T>(0.0f);
    for (int i = tid; i < Q * HP; i += TC_THREADS) {
      const int s = i / HP, c = i - s * HP, t = t0 + s;
      xs[s * l.x_ld + c] = t < a.L ? a.x[(row0 + t) * a.ldx + c] : zero;
    }
    for (int i = tid; i < Q * 16; i += TC_THREADS) {
      const int s = i >> 4, n = i & 15, t = t0 + s;
      const bool ok = t < a.L && n < a.N;
      bs[s * BC_LD + n] = ok ? a.Bm[(row0 + t) * a.ldb + n] : zero;
      if (kOut) cs[s * BC_LD + n] = ok ? a.Cm[(row0 + t) * a.ldc + n] : zero;
    }
    for (int i = tid; i < Q * a.H; i += TC_THREADS)
      ds[i] = t0 + i / a.H < a.L ? a.dt[(row0 + t0) * a.H + i] : 0.0f;
  }
}

// 16 elements of a B / C tile row times e, rounded, into dst.
template <typename T>
__device__ __forceinline__ void scale_row(const T* src, T* dst, float e) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint4 v = s4[q];
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = Pack<T>::unpack(w[j]);
      w[j] = Pack<T>::two(f.x * e, f.y * e);
    }
    d4[q] = v;
  }
}

// Phase 1 (kOut false): grid (M, b); block (r, bi) walks the chunks of run
// r from a zero state and writes the run's end state and log-decay.
// Phase 3 (kOut true): the same walk from the entering state, writing y.
template <typename T, bool kOut>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
ssd_run_kernel(const TcArgs<T> a) {
  extern __shared__ __align__(16) char tc_smem[];
  char* smem = tc_smem;
  const TcLayout l = tc_layout(a.H, a.P);
  const int r = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = a.H, P = a.P, HP = H * P, rev = a.reverse;
  const int nch = min(a.R, a.K - r * a.R);
  T* bg = reinterpret_cast<T*>(smem + l.bg);
  T* cg = reinterpret_cast<T*>(smem + l.cg);
  T* sb = reinterpret_cast<T*>(smem + l.sb);
  T* yw = reinterpret_cast<T*>(smem + l.ys) + warp * 16 * (P + 8);
  float* g2 = reinterpret_cast<float*>(smem + l.g2);
  float* G2 = g2 + H * Q;
  float* Gsum = G2 + H;
  const int sb_ld = P + 8;
  // ldmatrix lane offsets: A (and non-trans row-major) rows / columns, and
  // the B operand read non-trans from an [n][k] tile
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  auto chunk_of = [&](int i) { return rev ? r * a.R + nch - 1 - i : r * a.R + i; };

  // the state: pairs j = warp, warp + 4 of (head, 16 columns of P), rows n
  // g and g + 8, two n-tiles of 8 columns each
  const int pairs = HP / 16;
  float st[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][nt][e] = 0.0f;
  if (kOut) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = warp + 4 * i;
      if (j >= pairs) break;
      const int h = j / (P / 16), p0 = (j % (P / 16)) * 16;
      const float* s =
          a.states + ((((size_t)bi * H + h) * a.M + r) * a.N) * P + p0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int n = g + 8 * hi;
          if (n < a.N) {
            const float2 v =
                *reinterpret_cast<const float2*>(s + (size_t)n * P + nt * 8 + 2 * t4);
            st[i][nt][2 * hi] = v.x, st[i][nt][2 * hi + 1] = v.y;
          }
        }
    }
  }
  if (tid < H) Gsum[tid] = 0.0f;

  tc_load<T, kOut>(a, l, smem, bi, chunk_of(0));
  cp_async_commit();
  if (nch > 1) tc_load<T, kOut>(a, l, smem + l.stage, bi, chunk_of(1));
  cp_async_commit();

  for (int i = 0; i < nch; ++i) {
    char* stage = smem + (i & 1) * l.stage;
    T* xs = reinterpret_cast<T*>(stage + l.xs);
    const T* bs = reinterpret_cast<const T*>(stage + l.bs);
    const T* cs = reinterpret_cast<const T*>(stage + l.cs);
    const float* ds = reinterpret_cast<const float*>(stage + l.ds);
    cp_async_wait<1>();
    __syncthreads();

    // log2 decays: a warp a head, a lane two steps (in scan order)
    for (int h = warp; h < H; h += 4) {
      const float a2 = a.A[h] * LOG2E;
      const int i0 = 2 * lane, i1 = i0 + 1;
      const int j0 = rev ? Q - 1 - i0 : i0, j1 = rev ? Q - 1 - i1 : i1;
      const float v0 = ds[j0 * H + h] * a2, v1 = ds[j1 * H + h] * a2;
      float s = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      const float before = s - (v0 + v1);
      g2[h * Q + j0] = before + v0;
      g2[h * Q + j1] = before + v0 + v1;
      if (lane == 31) {
        G2[h] = s;
        Gsum[h] += s;
      }
    }
    __syncthreads();

    // dt x in place, rounded; B o e^(G-g) and C o e^g per head, rounded; the
    // entering state, rounded
    for (int e = tid; e < Q * HP / 8; e += TC_THREADS) {
      const int s = e / (HP / 8), c = 8 * (e - s * (HP / 8));
      const float d = ds[s * H + c / P];
      uint4* p = reinterpret_cast<uint4*>(xs + s * l.x_ld + c);
      uint4 v = *p;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = Pack<T>::unpack(w[j]);
        w[j] = Pack<T>::two(f.x * d, f.y * d);
      }
      *p = v;
    }
    for (int e = tid; e < H * Q; e += TC_THREADS) {
      const int h = e / Q, s = e - h * Q;
      const float gs = g2[e];
      scale_row<T>(bs + s * BC_LD, bg + e * BC_LD, ex2(G2[h] - gs));
      if (kOut) scale_row<T>(cs + s * BC_LD, cg + e * BC_LD, ex2(gs));
    }
    if (kOut) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int j = warp + 4 * ii;
        if (j >= pairs) break;
        const int h = j / (P / 16), p0 = (j % (P / 16)) * 16;
        T* d = sb + h * 16 * sb_ld + p0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          *reinterpret_cast<uint32_t*>(d + g * sb_ld + nt * 8 + 2 * t4) =
              Pack<T>::two(st[ii][nt][0], st[ii][nt][1]);
          *reinterpret_cast<uint32_t*>(d + (g + 8) * sb_ld + nt * 8 + 2 * t4) =
              Pack<T>::two(st[ii][nt][2], st[ii][nt][3]);
        }
      }
    }
    __syncthreads();

    if (kOut) {
      const int t0 = chunk_of(i) * Q;
      for (int h = 0; h < H; ++h) {
        const int rt = (h & 1) ? 3 - warp : warp, q0 = 16 * rt;
        const float* gh = g2 + h * Q;
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
        // inter: (C o e^g) S_in
        {
          uint32_t af[4];
          ldmatrix_x4<false>(af, cg + (h * Q + q0 + a_row) * BC_LD + a_col);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np * 16 < P) {
              uint32_t bf[4];
              ldmatrix_x4<true>(bf, sb + (h * 16 + a_row) * sb_ld + np * 16 + a_col);
              mma16816<T>(acc[2 * np], af, bf[0], bf[1]);
              mma16816<T>(acc[2 * np + 1], af, bf[2], bf[3]);
            }
          }
        }
        // intra: W (dt x), W's tiles on or below (above, reversed) the
        // diagonal
        const float gqa = gh[q0 + g], gqb = gh[q0 + g + 8];
        uint32_t ca[4];
        ldmatrix_x4<false>(ca, cs + (q0 + a_row) * BC_LD + a_col);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (rev ? ks < rt : ks > rt) continue;
          float cb[2][4] = {};
          uint32_t bb[4];
          ldmatrix_x4<false>(bb, bs + (16 * ks + b_row) * BC_LD + b_col);
          mma16816<T>(cb[0], ca, bb[0], bb[1]);
          mma16816<T>(cb[1], ca, bb[2], bb[3]);
          float w[2][4];
#pragma unroll
          for (int jt = 0; jt < 2; ++jt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = 16 * ks + 8 * jt + 2 * t4 + e;
              const int qa = q0 + g, qb = qa + 8;
              const float gs = gh[s];
              const bool ka = rev ? s >= qa : s <= qa;
              const bool kb = rev ? s >= qb : s <= qb;
              w[jt][e] = ka ? cb[jt][e] * ex2(gqa - gs) : 0.0f;
              w[jt][2 + e] = kb ? cb[jt][2 + e] * ex2(gqb - gs) : 0.0f;
            }
          const uint32_t wa[4] = {Pack<T>::two(w[0][0], w[0][1]),
                                  Pack<T>::two(w[0][2], w[0][3]),
                                  Pack<T>::two(w[1][0], w[1][1]),
                                  Pack<T>::two(w[1][2], w[1][3])};
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np * 16 < P) {
              uint32_t xb[4];
              ldmatrix_x4<true>(xb, xs + (16 * ks + a_row) * l.x_ld + h * P + np * 16 +
                                        a_col);
              mma16816<T>(acc[2 * np], wa, xb[0], xb[1]);
              mma16816<T>(acc[2 * np + 1], wa, xb[2], xb[3]);
            }
          }
        }
        // y: the warp's 16 rows through its own staging rows, then 16-byte
        // stores of whole rows
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt * 8 < P) {
            *reinterpret_cast<uint32_t*>(yw + g * sb_ld + nt * 8 + 2 * t4) =
                Pack<T>::two(acc[nt][0], acc[nt][1]);
            *reinterpret_cast<uint32_t*>(yw + (g + 8) * sb_ld + nt * 8 + 2 * t4) =
                Pack<T>::two(acc[nt][2], acc[nt][3]);
          }
        }
        __syncwarp();
        for (int e = lane; e < 2 * P; e += 32) {   // 16 rows of P / 8 segments
          const int rr = e / (P / 8), c = 8 * (e - rr * (P / 8));
          const int t = t0 + q0 + rr;
          if (t < a.L)
            *reinterpret_cast<uint4*>(a.y + ((size_t)bi * a.L + t) * HP + h * P + c) =
                *reinterpret_cast<const uint4*>(yw + rr * sb_ld + c);
        }
        __syncwarp();
      }
    }

    // the state: S = e^G S + (B o e^(G-g))^T (dt x)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int j = warp + 4 * ii;
      if (j >= pairs) break;
      const int h = j / (P / 16), pc = h * P + (j % (P / 16)) * 16;
      const float eG = ex2(G2[h]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[ii][nt][e] *= eG;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ba[4], xb[4];
        ldmatrix_x4<true>(ba, bg + (h * Q + 16 * ks + b_row) * BC_LD + b_col);
        ldmatrix_x4<true>(xb, xs + (16 * ks + a_row) * l.x_ld + pc + a_col);
        mma16816<T>(st[ii][0], ba, xb[0], xb[1]);
        mma16816<T>(st[ii][1], ba, xb[2], xb[3]);
      }
    }
    __syncthreads();
    if (i + 2 < nch) tc_load<T, kOut>(a, l, stage, bi, chunk_of(i + 2));
    cp_async_commit();
  }

  if (!kOut) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int j = warp + 4 * ii;
      if (j >= pairs) break;
      const int h = j / (P / 16), p0 = (j % (P / 16)) * 16;
      float* s = a.states + ((((size_t)bi * H + h) * a.M + r) * a.N) * P + p0;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int n = g + 8 * hi;
          if (n < a.N)
            *reinterpret_cast<float2*>(s + (size_t)n * P + nt * 8 + 2 * t4) =
                make_float2(st[ii][nt][2 * hi], st[ii][nt][2 * hi + 1]);
        }
    }
    if (tid < H) a.decay[((size_t)bi * H + tid) * a.M + r] = Gsum[tid] * LN2;
  }
}

template <typename T>
int launch_tc(const void* x, const float* dt, const float* A, const void* Bm,
              const void* Cm, void* y, float* states, float* decay, int b, int L,
              int H, int P, int N, long ldx, long ldb, long ldc, int reverse, int R,
              cudaStream_t stream) {
  const int K = (L + Q - 1) / Q;
  const int M = (K + R - 1) / R;
  auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
  const int vec = aligned(x) && aligned(Bm) && aligned(Cm) && aligned(dt) &&
                  ldx % 8 == 0 && ldb % 8 == 0 && ldc % 8 == 0 && N % 8 == 0 &&
                  ((long)L * H) % 4 == 0;
  const TcArgs<T> a{static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
                    static_cast<const T*>(Cm), states, decay, static_cast<T*>(y),
                    L, H, P, N, K, R, M, ldx, ldb, ldc, reverse, vec};
  const TcLayout l = tc_layout(H, P);
  cudaError_t err;
  if ((err = allow_smem(ssd_run_kernel<T, false>, l.total)) != cudaSuccess) return err;
  if ((err = allow_smem(ssd_run_kernel<T, true>, l.total)) != cudaSuccess) return err;
  const dim3 grid(M, b);
  ssd_run_kernel<T, false><<<grid, TC_THREADS, l.total, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long total = (long)b * H * N * P;
  const int pass_blocks = (int)((total + PASS_THREADS - 1) / PASS_THREADS);
  ssd_state_pass_kernel<<<pass_blocks, PASS_THREADS, 0, stream>>>(
      states, decay, b * H, M, N * P, reverse);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_run_kernel<T, true><<<grid, TC_THREADS, l.total, stream>>>(a);
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

// Bytes of dynamic shared memory of the tensor-core kernels at (H, P).
int vetk_ssd_tc_smem(int H, int P) { return tc_layout(H, P).total; }

// bf16 / fp16 with P % 16 == 0, 16 <= P <= 64, H * P <= 128 and N <= 16
// take the tensor-core path, in runs of `run` chunks; everything else the
// CUDA-core path (P <= 64), which takes run 1. The scratch holds
// ceil(K / run) states of (N, P) and decays per (frame, head). Returns a
// cudaError_t (0 on success).
int vetk_ssd_shared(int dtype, const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* states,
                    void* decay, int b, int L, int H, int P, int N, long ldx,
                    long ldb, long ldc, int reverse, int run, void* stream) {
  if (P > 64 || P < 1 || N < 1 || L < 1 || b < 1 || H < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto dtf = static_cast<const float*>(dt);
  auto Af = static_cast<const float*>(A);
  auto sf = static_cast<float*>(states);
  auto df = static_cast<float*>(decay);
  const bool tc = (dtype == kBFloat16 || dtype == kFloat16) && P % 16 == 0 &&
                  P >= 16 && H * P <= TC_MAX_HP && N <= 16;
  if (tc ? run < 1 : run != 1) return (int)cudaErrorInvalidValue;
  if (tc && dtype == kBFloat16)
    return launch_tc<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N,
                                    ldx, ldb, ldc, reverse, run, st);
  if (tc)
    return launch_tc<__half>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N, ldx, ldb,
                             ldc, reverse, run, st);
  switch (dtype) {
    case kFloat32:
      return launch_simt<float>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N, ldx,
                                ldb, ldc, reverse, st);
    case kBFloat16:
      return launch_simt<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P,
                                        N, ldx, ldb, ldc, reverse, st);
    case kFloat16:
      return launch_simt<__half>(x, dtf, Af, Bm, Cm, y, sf, df, b, L, H, P, N, ldx,
                                 ldb, ldc, reverse, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
