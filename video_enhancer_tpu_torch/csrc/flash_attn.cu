// Blockwise (flash) attention forward with an online softmax, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel video_enhancer_tpu/ops/attention.py
// flash_attention -> _flash_impl -> _flash_kernel (pallas_call at
// attention.py:118). For each of the B*H rows: O = softmax(scale * Q K^T) V,
// with fp32 logits, softmax statistics and accumulator; keys at index >= Lk
// are masked with -1e30 (not -inf, so a fully masked tile gives no NaN) and
// the output is acc / max(l, 1e-30), as the TPU kernel ends (:87-91). No bias,
// no causal mask. The (Lq, Lk) score matrix never reaches device memory.
//
// What bounds it on an H100: at ditvr's served shape (B*H = 2 tiles x 3
// heads, Lq = Lk = 10080, Dh = 128, bf16) it does 4*6*10080^2*128 = 312 GFLOP
// and moves 62 MB, so operations bound it: 0.316 ms at the bf16 tensor-core
// rate (989 TFLOP/s); 4.7 ms at the fp32 CUDA-core rate (67 TFLOP/s).
//
// Design, simple first: one block per (row, tile of 64 query rows); a loop
// inside the block walks the key tiles of 64, in place of the TPU's
// sequential grid axis ("arbitrary", :137-139), with the running max and sum
// of each query row and the 64 x Dh fp32 accumulator in registers. The head
// dimension is padded with zeros to 32, 64 or 128 inside the block, so any
// multiple of 16 up to 128 is taken. Ragged lengths: rows past Lq and keys
// past Lk are read as zeros, keys past Lk are masked, rows past Lq are not
// stored; nothing is read or written past either end. Two kernels, by the
// input type:
//
// - bf16 and fp16 (the served path): flash_fwd_mma, the products on the
//   tensor cores through mma.sync m16n8k16 with fp32 accumulation, in
//   FlashAttention-2's layout. 4 warps, 16 query rows each; Q, K and V tiles
//   in shared memory in the input type, rows padded by 8 elements so that
//   ldmatrix reads them without bank conflicts; K and V (transposed by
//   ldmatrix.trans) feed the B operands straight from shared memory. The
//   probabilities stay in registers: the accumulator fragment of S = QK^T is
//   the A fragment of PV once rounded to the input type (the TPU kernel
//   keeps them in fp32; the plain version rounds them the same way). Tiles
//   are loaded synchronously, 16 bytes a thread when the operands are
//   aligned for it; no cp.async, TMA or wgmma yet.
// - fp32: flash_fwd_simt, the products on CUDA cores in fp32, exact to the
//   plain version's rounding. 256 threads; each computes a 4x4 block of
//   scores from float4 reads of the transposed Q and K tiles, writes its
//   probabilities over the spent K tile, and updates its 4 x (Dh/16) share
//   of the accumulator. 98 KB of shared memory at Dh 128, two blocks an SM.
//
// Layouts: q (B, H, Lq, Dh), k and v (B, H, Lk, Dh), o (B, H, Lq, Dh), each
// given by its batch, head and row strides in elements, with a dense last
// dimension: the views of a split qkv projection are read in place, and o
// may be a (B, Lq, H, Dh) buffer seen through a permuted view.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // simt: 16 x 16, 4 query rows x 4 keys each
constexpr int KSTRIDE = BK + 4; // padded row of the transposed K tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long b, h, l;
};

// Rows of the shared K^T region: DHP for K^T, BQ for the probabilities.
template <int DHP>
__host__ __device__ constexpr int kt_rows() {
  return DHP > BQ ? DHP : BQ;
}

template <int DHP>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q^T (DHP x BQ), K^T (DHP x KSTRIDE; later P, BQ x KSTRIDE), V (BK x DHP)
  return sizeof(float) *
         ((size_t)DHP * BQ + (size_t)kt_rows<DHP>() * KSTRIDE + (size_t)BK * DHP);
}

template <int DHP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int H, int Lq,
               int Lk, int Dh, float scale, Strides qs, Strides ks, Strides vs,
               Strides os) {
  constexpr int NC = DHP / 16;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                 // [DHP][BQ]
  float* Kt = Qt + DHP * BQ;        // [DHP][KSTRIDE]; then P [BQ][KSTRIDE]
  float* Vs = Kt + kt_rows<DHP>() * KSTRIDE;  // [BK][DHP]
  float* Ps = Kt;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  float* op = o + b * os.b + h * os.h;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * DHP; i += THREADS) {
    const int r = i / DHP, d = i % DHP;
    const int qi = q0 + r;
    Qt[d * BQ + r] = (qi < Lq && d < Dh) ? qp[qi * qs.l + d] : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int n_k = (Lk + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P and V are spent
    for (int i = tid; i < BK * DHP; i += THREADS) {
      const int r = i / DHP, d = i % DHP;
      const int ki = k0 + r;
      const bool ok = ki < Lk && d < Dh;
      Kt[d * KSTRIDE + r] = ok ? kp[ki * ks.l + d] : 0.0f;
      Vs[r * DHP + d] = ok ? vp[ki * vs.l + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DHP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * BQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * KSTRIDE + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
    __syncthreads();  // K^T is spent: its space takes the probabilities

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        s[i][j] = col < Lk ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are the lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * KSTRIDE + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * KSTRIDE + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * DHP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dh) op[row * os.l + col] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

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

// Rows [r0, r0 + 64) of a (rows, Dh) operand into a (64, DHP + 8) shared
// tile, zero past `rows` and past Dh; 16-byte copies when `vec`.
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long ld, int r0,
                                          int rows, int Dh, bool vec) {
  constexpr int LD = DHP + 8;
  constexpr int CH = DHP / 8;          // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int gr = r0 + r;
    T* d = dst + r * LD + c;
    if (gr < rows && c < Dh) {
      const T* g = src + gr * ld + c;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(g);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) d[j] = g[j];
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int DHP>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return 3 * 64 * (DHP + 8) * sizeof(uint16_t);   // Q, K, V tiles
}

template <typename T, int DHP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Lq, int Lk,
              int Dh, float scale, Strides qs, Strides ks, Strides vs, Strides os,
              int vec) {
  constexpr int LD = DHP + 8;
  constexpr int KS = DHP / 16;        // k-steps of QK^T
  constexpr int NO = DHP / 8;         // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + 64 * LD;
  T* Vs = Ks + 64 * LD;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  T* op = o + b * os.b + h * os.h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;       // fragment row group, column pair
  const int mi = lane / 8, rr = lane % 8;     // ldmatrix matrix and row
  const int wr = warp * 16;                   // the warp's first query row

  load_tile<T, DHP>(Qs, qp, qs.l, q0, Lq, Dh, vec);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4<false>(qf[kk], Qs + (wr + rr + (mi & 1) * 8) * LD + kk * 16 + (mi >> 1) * 8);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf};   // running max of rows g and g + 8 (log2 units)
  float l[2] = {0.0f, 0.0f};         // this thread's share of their sums
  const float sl2 = scale * kLog2e;

  const int n_k = (Lk + 63) / 64;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * 64;
    __syncthreads();  // the previous tile's K and V are spent
    load_tile<T, DHP>(Ks, kp, ks.l, k0, Lk, Dh, vec);
    load_tile<T, DHP>(Vs, vp, vs.l, k0, Lk, Dh, vec);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bk[4];
        ldmatrix_x4<false>(bk, Ks + (p * 16 + rr + (mi >> 1) * 8) * LD + kk * 16 + (mi & 1) * 8);
        mma16816<T>(s[2 * p], qf[kk], bk[0], bk[1]);
        mma16816<T>(s[2 * p + 1], qf[kk], bk[2], bk[3]);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = col < Lk ? s[n][e] * sl2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 threads of a quad hold one row's 64 scores
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
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
    for (int kk = 0; kk < 4; ++kk) {   // keys 16 kk .. 16 kk + 15 of the tile
      uint32_t pa[4];
      pa[0] = Pack<T>::two(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = Pack<T>::two(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = Pack<T>::two(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = Pack<T>::two(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4<true>(bv, Vs + (kk * 16 + rr + (mi & 1) * 8) * LD + np * 16 + (mi >> 1) * 8);
        mma16816<T>(acc[2 * np], pa, bv[0], bv[1]);
        mma16816<T>(acc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wr + g + i * 8;
    if (row >= Lq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < Dh) {
        op[row * os.l + col] = from_f32<T>(acc[n][2 * i] / l[i]);
        op[row * os.l + col + 1] = from_f32<T>(acc[n][2 * i + 1] / l[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Lq, Lk, Dh;
  float scale;
  Strides qs, ks, vs, os;
  int vec;
  cudaStream_t stream;
};

template <int DHP>
cudaError_t launch_simt(const Args& a) {
  constexpr size_t smem = smem_bytes<DHP>();
  cudaError_t err = allow_smem(flash_fwd_simt<DHP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_simt<DHP><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H, a.Lq, a.Lk,
      a.Dh, a.scale, a.qs, a.ks, a.vs, a.os);
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<DHP>();
  cudaError_t err = allow_smem(flash_fwd_mma<T, DHP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + 63) / 64, a.B * a.H);
  flash_fwd_mma<T, DHP><<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.Lq, a.Lk, a.Dh,
      a.scale, a.qs, a.ks, a.vs, a.os, a.vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.Dh <= 32) return launch_simt<32>(a);
    if (a.Dh <= 64) return launch_simt<64>(a);
    return launch_simt<128>(a);
  } else {
    if (a.Dh <= 32) return launch_mma<T, 32>(a);
    if (a.Dh <= 64) return launch_mma<T, 64>(a);
    return launch_mma<T, 128>(a);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). Requires 16 <= Dh <= 128 with Dh a
// multiple of 16, Lq, Lk >= 1, B * H <= 65535, and a dense last dimension;
// strides are in elements (qsb, qsh, qsl: batch, head, row). `vec` says that
// q, k and v are 16-byte aligned and every stride a multiple of 8 elements.
int vetk_flash_attention(int dtype, const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Lq, int Lk, int Dh, float scale,
                         long qsb, long qsh, long qsl, long ksb, long ksh, long ksl,
                         long vsb, long vsh, long vsl, long osb, long osh, long osl,
                         int vec, void* stream) {
  if (Dh < 16 || Dh > 128 || Dh % 16 || Lq < 1 || Lk < 1 || B < 1 || H < 1 ||
      (long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, H, Lq, Lk, Dh, scale,
               Strides{qsb, qsh, qsl}, Strides{ksb, ksh, ksl},
               Strides{vsb, vsh, vsl}, Strides{osb, osh, osl}, vec,
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

}  // extern "C"
