// Shifted-window attention with a per-head additive bias shared by every
// window, for Hopper (sm_90a).
//
// Replaces the TPU kernel video_enhancer_tpu/ops/attention.py
// window_attention -> _window_impl -> _window_kernel (pallas_call at
// attention.py:232). For q, k, v (nW, H, N, Dh) and bias (H, N, N):
// o[w, h] = softmax(q[w, h] k[w, h]^T * scale + bias[h]) v[w, h], with the
// logits, the softmax and both products in fp32; o takes q's type. The
// (N, N) logits of a window never reach device memory.
//
// What bounds it on an H100: at rvrt's served shape (a 7x180x320 clip padded
// to 8x184x320 gives nW = 4*23*40 = 3680 windows of 2x8x8 = 128 tokens, H = 4,
// Dh = 16, bf16) reading q, k, v and writing o moves 4 * 14720 * 128 * 16 * 2 B
// = 241 MB, 0.072 ms at 3.35 TB/s; its 4 nW H N^2 Dh = 15.4 GFLOP take 0.016 ms
// at the bf16 tensor-core rate, so bytes bound the work. In fp32 on CUDA cores
// the same operations need 0.23 ms at 67 TFLOP/s. Its 241 M exps take
// 0.058 ms of the special-function units. Measured on an H100 (PERF.md, PR
// 11), the half-type kernel's products and softmax alone take ~0.19 ms and
// its loads alone ~0.11: the latency of each warp's chain (ldmatrix, mma,
// the row max across a quad, ex2, mma) at 16 warps an SM, not a pipe, sets
// its pace.
//
// The TPU kernel held a group of whole windows' (N, N) logits in VMEM; here
// they live in registers, a row block at a time. Two kernels, by the input
// type:
//
// - bf16 and fp16 (the served path): window_attn_mma, 8 warps of 16 query
//   rows. A block takes one head and a run of `wpb` consecutive windows,
//   launched as about one wave (wpb from the wrapper: 2 blocks an SM at Dh
//   <= 16, 1 above). The block first copies its head's bias (times log2 e)
//   into shared memory in the order of the mma accumulator fragments, so
//   that a thread reads the bias of its 4 logits of an n-tile as one float4
//   with no bank conflict; all its windows reuse it. Q, K and V tiles (128
//   x Dh, zero-padded to 16, 32 or 64, rows padded by 8 elements so that
//   ldmatrix reads them without bank conflicts) pass through a ring of two
//   stages: while the warps work on window w, the 16-byte cp.async copies
//   of window w + 1 are in flight (the first window's under the bias copy),
//   so loads and tensor-core work overlap; a wait on the copy group and one
//   barrier open a stage, a second barrier frees it for the window after
//   next. Operands off the 16-byte grid (`vec` 0) are loaded synchronously
//   into the same ring. Each warp computes its 16-row block of S = QK^T a
//   tile of 64 keys at a time with mma.sync m16n8k16 (fp32 accumulate),
//   scales it and adds the bias, keeps an online softmax (quad shuffles for
//   the row max and sum), rounds P to the input type as the A fragment of
//   PV (V through ldmatrix.trans) and divides by the row sum at the end.
//   The plain version rounds the normalised probabilities instead; both
//   round P once. Keeping the whole 128-key row of S in registers took 253
//   registers and one block an SM; tiles of 64 keys take 128 and two
//   (unrolling the two tiles spilled and ran slower). The
//   block's shared memory is the bias (64 KB) and the ring (2 x 18 KB at
//   Dh 16); a deeper ring would need the bias out of shared memory.
// - fp32: window_attn_simt, the products on CUDA cores in fp32. A block of
//   128 threads takes one (window, head), one query row a thread: K and V staged in shared memory as fp32,
//   q in registers, an online softmax over the keys in chunks of 16 (one
//   rescale of the accumulator a chunk); all threads of a warp read the
//   same K or V row at once, a broadcast from shared memory.
//
// Layouts: q, k, v and o are (nW, H, N, Dh), each given by its window, head
// and row strides in elements with a dense last dimension, so the views of a
// split qkv projection are read in place and o may be a (nW, N, H, Dh)
// buffer seen through a permuted view. bias is a dense (H, N, N) fp32 tensor.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int THREADS = 128;   // simt: one query row a thread; N <= 128
constexpr int KC = 16;         // simt: keys a softmax chunk
constexpr int MMA_THREADS = 256;   // mma: 8 warps x 16 query rows
constexpr int ROWS = 128;          // mma: query and key rows of a window
constexpr int KT = 64;             // mma: keys a softmax tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long w, h, r;                // window, head, row
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
window_attn_simt(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, int N, int Dh, float scale, Strides qs,
                 Strides ks, Strides vs, Strides os) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // N x DP
  float* vt = kt + N * DP;                       // N x DP
  const long w = blockIdx.x;
  const int h = blockIdx.y;
  const int i = threadIdx.x;
  const float* kb = k + w * ks.w + h * ks.h;
  const float* vb = v + w * vs.w + h * vs.h;
  for (int e = i; e < N * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    kt[e] = d < Dh ? kb[r * ks.r + d] : 0.0f;
    vt[e] = d < Dh ? vb[r * vs.r + d] : 0.0f;
  }
  __syncthreads();
  if (i >= N) return;

  const float* brow = bias + ((long)h * N + i) * N;
  const float* qrow = q + w * qs.w + h * qs.h + i * qs.r;
  float qr[DP], acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = d < Dh ? qrow[d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;
  for (int j0 = 0; j0 < N; j0 += KC) {
    float s[KC];
    float cm = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) {
      const int j = j0 + jj;
      s[jj] = -INFINITY;
      if (j < N) {
        const float4* kr = reinterpret_cast<const float4*>(kt + j * DP);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < DP / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        s[jj] = dot * scale + __ldg(brow + j);
      }
      cm = fmaxf(cm, s[jj]);
    }
    const float mn = fmaxf(m, cm);
    const float corr = m == -INFINITY ? 0.0f : expf(m - mn);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < KC; ++jj) {
      const int j = j0 + jj;
      if (j < N) {
        const float p = expf(s[jj] - mn);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vt + j * DP);
#pragma unroll
        for (int d4 = 0; d4 < DP / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
    }
    m = mn;
  }
  const float inv = 1.0f / l;
  float* orow = o + w * os.w + h * os.h + i * os.r;
#pragma unroll
  for (int d = 0; d < DP; ++d)
    if (d < Dh) orow[d] = acc[d] * inv;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------

// 2^x on the special-function unit (the logits are in log2 units; a
// result below the smallest normal float is flushed to 0).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Pack<__half> {
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// d += a * b for one m16n8k16 tile, fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d, const uint32_t* a,
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t* a,
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
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

// The N rows of one window's (N, Dh) operand into a (ROWS, DP + 8) shared
// tile, zero past N and past Dh; 16-byte copies when `vec`.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long ld, int N,
                                          int Dh, bool vec) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;           // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    T* d = dst + r * LD + c;
    if (r < N && c < Dh) {
      const T* g = src + r * ld + c;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(g);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = (c + j < Dh) ? g[j] : from_f32<T>(0.0f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// As load_tile with 16-byte operands (`vec`), but by cp.async: rows past N
// and chunks past Dh read nothing and are zero-filled.
template <typename T, int DP>
__device__ __forceinline__ void issue_tile(T* dst, const T* src, long ld, int N, int Dh) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r < N && c < Dh;
    cp_async16(dst + r * LD + c, in ? src + r * ld + c : src, in ? 16 : 0);
  }
}

template <int DP>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  // the head's bias in fragment order (fp32), then two stages of the Q, K
  // and V tiles
  return ROWS * ROWS * sizeof(float) + 2 * 3 * ROWS * (DP + 8) * sizeof(uint16_t);
}

// Where bias[row][col] lands in the fragment-ordered copy: the float4 of
// (warp, n-tile, lane) holds the 4 accumulator elements that lane owns in
// the n-tile of 8 keys, so each thread reads its logits' bias 16 bytes at a
// time, without bank conflicts.
__device__ __forceinline__ int frag_index(int row, int col) {
  const int warp = row / 16, half = (row % 16) / 8, g = row % 8;
  const int n = col / 8, t = (col % 8) / 2;
  return ((warp * (ROWS / 8) + n) * 32 + g * 4 + t) * 4 + half * 2 + (col & 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
window_attn_mma(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                T* __restrict__ o, int nW, int N, int Dh, float scale,
                Strides qs, Strides ks, Strides vs, Strides os, int wpb,
                int vec) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;          // k-steps of QK^T
  constexpr int NO = DP / 8;           // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Bs = reinterpret_cast<float*>(smem_raw);   // bias * log2(e)
  T* ring = reinterpret_cast<T*>(Bs + ROWS * ROWS);  // [2][Q, K, V][ROWS * LD]

  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;                     // fragment column pair
  const int mi = lane / 8, rr = lane % 8;     // ldmatrix matrix and row
  const int wr = warp * 16;                   // the warp's first query row
  const float sl2 = scale * kLog2e;
  const int w0 = blockIdx.x * wpb;
  const int w1 = min(w0 + wpb, nW);

  // window w's Q, K and V into ring stage `st`, as one cp.async group
  auto load = [&](int w, int st) {
    T* dst = ring + st * 3 * ROWS * LD;
    const T* src[3] = {q + w * qs.w + h * qs.h, k + w * ks.w + h * ks.h,
                       v + w * vs.w + h * vs.h};
    const long ld[3] = {qs.r, ks.r, vs.r};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (vec)
        issue_tile<T, DP>(dst + i * ROWS * LD, src[i], ld[i], N, Dh);
      else
        load_tile<T, DP>(dst + i * ROWS * LD, src[i], ld[i], N, Dh, false);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (w0 < w1) load(w0, 0);

  // the head's bias, read once for all the block's windows
  const float* bh = bias + (long)h * N * N;
  for (int i = threadIdx.x; i < N * N; i += MMA_THREADS)
    Bs[frag_index(i / N, i % N)] = bh[i] * kLog2e;
  const float4* Bf = reinterpret_cast<const float4*>(Bs) + warp * (ROWS / 8) * 32 + lane;

  for (int w = w0, st = 0; w < w1; ++w, st ^= 1) {
    if (w + 1 < w1) {
      load(w + 1, st ^ 1);                    // in flight under this window
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();                          // window w (and the bias) is in
    const T* Qs = ring + st * 3 * ROWS * LD;
    const T* Ks = Qs + ROWS * LD;
    const T* Vs = Ks + ROWS * LD;
    if (wr < N) {
      uint32_t qf[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4<false>(qf[kk], Qs + (wr + rr + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8);
      float acc[NO][4];
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
      float m[2] = {kNegInf, kNegInf};   // running max of rows g, g + 8 (log2 units)
      float l[2] = {0.0f, 0.0f};         // this thread's share of their sums

      // keys in tiles of KT with an online softmax: S of one tile, 16 x KT,
      // in registers
      for (int k0 = 0; k0 < N; k0 += KT) {
        float s[KT / 8][4];
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int p = 0; p < KT / 16; ++p) {
            uint32_t bk[4];
            ldmatrix_x4<false>(bk, Ks + (k0 + p * 16 + rr + (mi >> 1) * 8) * LD + kk * 16 + (mi & 1) * 8);
            mma16816<T>(s[2 * p], qf[kk], bk[0], bk[1]);
            mma16816<T>(s[2 * p + 1], qf[kk], bk[2], bk[3]);
          }
        }
        // logits = S * scale + bias in log2 units; keys past N are masked
        // (only a tile that reaches past N compares)
        float mx[2] = {kNegInf, kNegInf};
        const bool ragged = k0 + KT > N;
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
          const float4 b = Bf[(k0 / 8 + n) * 32];
          const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[n][e];
            x = fmaf(x, sl2, bb[e]);
            if (ragged && k0 + n * 8 + 2 * t + (e & 1) >= N) x = kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // the 4 threads of a quad hold one row's scores
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          alpha[i] = ex2_ftz(m[i] - m_new);
          m[i] = m_new;
          l[i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = ex2_ftz(s[n][e] - m[e >> 1]);
            l[e >> 1] += s[n][e];
          }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {  // keys k0 + 16 kk .. + 15
          uint32_t pa[4];
          pa[0] = Pack<T>::two(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = Pack<T>::two(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = Pack<T>::two(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = Pack<T>::two(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t bv[4];
            ldmatrix_x4<true>(bv, Vs + (k0 + kk * 16 + rr + (mi & 1) * 8) * LD + np * 16 + (mi >> 1) * 8);
            mma16816<T>(acc[2 * np], pa, bv[0], bv[1]);
            mma16816<T>(acc[2 * np + 1], pa, bv[2], bv[3]);
          }
        }
      }

      T* ob = o + w * os.w + h * os.h;
      // o's pairs of columns are 4-byte aligned when its base and strides are
      const bool pair = ((reinterpret_cast<size_t>(o) | os.w | os.h | os.r) & 1) == 0 &&
                        (reinterpret_cast<size_t>(o) & 3) == 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int row = wr + lane / 4 + 8 * i;
        if (row >= N) continue;
        const float inv = 1.0f / l[i];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int col = n * 8 + 2 * t;
          T* out = ob + row * os.r + col;
          if (col + 1 < Dh && pair) {           // one 4-byte store
            *reinterpret_cast<uint32_t*>(out) =
                Pack<T>::two(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
          } else {
            if (col < Dh) out[0] = from_f32<T>(acc[n][2 * i] * inv);
            if (col + 1 < Dh) out[1] = from_f32<T>(acc[n][2 * i + 1] * inv);
          }
        }
      }
    }
    __syncthreads();                          // stage st is spent: refilled at w + 2
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const float* bias;
  void* o;
  int nW, H, N, Dh;
  float scale;
  Strides qs, ks, vs, os;
  int wpb, vec;
  cudaStream_t stream;
};

template <int DP>
cudaError_t launch_simt(const Args& a) {
  const size_t smem = 2 * static_cast<size_t>(a.N) * DP * sizeof(float);
  cudaError_t err = allow_smem(window_attn_simt<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nW, a.H);
  window_attn_simt<DP><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, static_cast<float*>(a.o), a.N,
      a.Dh, a.scale, a.qs, a.ks, a.vs, a.os);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = allow_smem(window_attn_mma<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nW + a.wpb - 1) / a.wpb, a.H);
  window_attn_mma<T, DP><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.o), a.nW, a.N,
      a.Dh, a.scale, a.qs, a.ks, a.vs, a.os, a.wpb, a.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.Dh <= 16) return launch_simt<16>(a);
    if (a.Dh <= 32) return launch_simt<32>(a);
    return launch_simt<64>(a);
  } else {
    if (a.Dh <= 16) return launch_mma<T, 16>(a);
    if (a.Dh <= 32) return launch_mma<T, 32>(a);
    return launch_mma<T, 64>(a);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Requires 1 <= N <= 128,
// 1 <= Dh <= 64, H <= 65535 and a dense last dimension; strides are in
// elements (qsw, qsh, qsr: window, head, row). In half types each block
// takes `wpb` consecutive windows of one head; fp32 takes one a block. `vec`
// says that q, k and v are 16-byte aligned, every stride a multiple of 8
// elements and Dh a multiple of 8.
int vetk_window_attention(int dtype, const void* q, const void* k,
                          const void* v, const void* bias, void* o, int nW,
                          int H, int N, int Dh, float scale, long qsw, long qsh,
                          long qsr, long ksw, long ksh, long ksr, long vsw,
                          long vsh, long vsr, long osw, long osh, long osr,
                          int wpb, int vec, void* stream) {
  if (nW < 1 || H < 1 || H > 65535 || N < 1 || N > THREADS || Dh < 1 ||
      Dh > 64 || wpb < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(bias), o, nW, H, N, Dh,
               scale, Strides{qsw, qsh, qsr}, Strides{ksw, ksh, ksr},
               Strides{vsw, vsh, vsr}, Strides{osw, osh, osr}, wpb, vec,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kFloat32:
      return launch<float>(a);
    case kBFloat16:
      return launch<__nv_bfloat16>(a);
    case kFloat16:
      return launch<__half>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory of a block of the half-type kernel for a
// head width of Dh.
int vetk_window_attention_smem(int Dh) {
  if (Dh <= 16) return (int)mma_smem_bytes<16>();
  if (Dh <= 32) return (int)mma_smem_bytes<32>();
  return (int)mma_smem_bytes<64>();
}

}  // extern "C"
