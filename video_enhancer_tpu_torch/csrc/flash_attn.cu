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
// Two kernels, by the input type:
//
// - bf16 and fp16 (the served path): flash_fwd_wgmma, warp-specialised for
//   Hopper. One block per (tile of 128 query rows, batch * head), three
//   warpgroups: a producer whose one thread issues TMA loads (registers
//   lowered by setmaxnreg.dec), and two consumers of 64 query rows each
//   (registers raised by setmaxnreg.inc). The producer loads the Q tile once
//   and the K and V tiles of 128 keys into a ring of three stages (225 KB of
//   shared memory at Dh 128), each guarded by a full barrier per operand (the
//   TMA's byte count) and an empty barrier (one arrival per consumer warp).
//   A consumer computes S = Q K^T with wgmma m64n128k16 from shared memory,
//   keeps the online softmax in registers (the row max taken on the raw
//   scores, then exp2(s * scale * log2 e - max) as one FMA and one ex2; the
//   key mask only on a ragged last tile), rounds P to the input type in
//   registers (as the plain version rounds the probabilities) and adds P V
//   with wgmma from registers, V read MN-major through the descriptor's
//   transpose. The
//   epilogue divides by max(l, 1e-30), writes the tile into its spent Q rows
//   and stores it with one TMA store a 64-column chunk.
//   Tiles sit in shared memory in TMA's 128-byte swizzle, 64 columns a chunk;
//   the head dimension is padded to 64 or 128 by the TMA's zero fill, so any
//   multiple of 16 up to 128 is taken. Rows past Lq and keys past Lk are read
//   as zeros (keys are also masked); the store clips rows past Lq and columns
//   past Dh. The tensor maps are 4-D (Dh, then rows, heads and batches in the
//   order of their strides) with the caller's strides, so strided views of a
//   split qkv projection are read in place; the wrapper copies an operand
//   whose base or strides TMA cannot take (ops/attention.py _flash_plan).
//   The maps are encoded on the host for each call by cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint (no -lcuda).
//   Not yet: ping-pong of the consumers, overlap of the softmax with the
//   products inside a warpgroup, a persistent scheduler, clusters.
// - fp32: flash_fwd_simt, the products on CUDA cores in fp32, exact to the
//   plain version's rounding. 256 threads; each computes a 4x4 block of
//   scores from float4 reads of the transposed Q and K tiles, writes its
//   probabilities over the spent K tile, and updates its 4 x (Dh/16) share
//   of the accumulator. 98 KB of shared memory at Dh 128, two blocks an SM.
//
// Layouts: q (B, H, Lq, Dh), k and v (B, H, Lk, Dh), o (B, H, Lq, Dh), each
// given by its batch, head and row strides in elements, with a dense last
// dimension; o may be a (B, Lq, H, Dh) buffer seen through a permuted view.

#include <cuda.h>

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
// Hopper tensor-core kernel (bf16, fp16)
// ---------------------------------------------------------------------------

constexpr int TQ = 128;             // query rows a block: two consumers of 64
constexpr int TK = 128;             // keys a tile
constexpr int STAGES = 3;           // K/V ring
constexpr int WG = 128;             // threads a warpgroup
constexpr int HOP_THREADS = 3 * WG; // producer + two consumers
constexpr int CHUNK = 64;           // columns of one 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of flash_fwd_wgmma at padded width DHP, from a 1024-byte
// aligned base: Q [chunk][TQ][64], then the K and V stages [chunk][TK][64],
// then the barriers (full Q; full K, full V and empty per stage).
template <int DHP>
struct HopSmem {
  static constexpr int NCH = DHP / CHUNK;
  static constexpr int Q_CHUNK = TQ * ROW_BYTES;
  static constexpr int KV_CHUNK = TK * ROW_BYTES;
  static constexpr int KV_TILE = NCH * KV_CHUNK;
  static constexpr int K_OFF = NCH * Q_CHUNK;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;   // room to align the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A barrier that never completes (a fault in the pipeline) traps after
// about 2^26 polls, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// One 4-D box of `map` at (c0, c1, c2, c3) into shared memory at `dst`; its
// bytes count against the barrier's expected transaction.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma operand descriptor: 128-byte swizzle, strides in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's use of wgmma registers against the asynchronous
// product: no read or write of `r` moves across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float fast_ex2(float x) {
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

// S (64 x 128, fp32) = A B^T, A and B K-major in shared memory; scale_d = 0 overwrites S.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
}

// O (64 x 64, fp32) += A B, A from registers, B MN-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// O (64 x 128, fp32) += A B, A from registers, B MN-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// The map coordinate of TMA dimension 1 + pos: `perm` holds, 2 bits a
// dimension, which of (row, head, batch) it is.
__device__ __forceinline__ int coord(int perm, int pos, int row, int h, int b) {
  const int which = (perm >> (2 * pos)) & 3;
  return which == 0 ? row : (which == 1 ? h : b);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(HOP_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mo, int H, int Lk, float sl2,
                int perms) {
  using S = HopSmem<DHP>;
  constexpr int NO = DHP / 2;             // output registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + S::BAR_OFF;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES,
                 bar_e = bar_v + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TQ;
  const int n_k = (Lk + TK - 1) / TK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int pq = perms & 63, pk = (perms >> 6) & 63, pv = (perms >> 12) & 63;
      mbar_expect_tx(bar_q, S::NCH * S::Q_CHUNK);
#pragma unroll
      for (int c = 0; c < S::NCH; ++c)
        tma_load(base + c * S::Q_CHUNK, &mq, bar_q, c * CHUNK, coord(pq, 0, q0, h, b),
                 coord(pq, 1, q0, h, b), coord(pq, 2, q0, h, b));
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(bar_e + 8 * s, ph ^ 1);   // the stage's last use is spent
        const int k0 = kt * TK;
        const uint32_t kd = base + S::K_OFF + s * S::KV_TILE;
        const uint32_t vd = base + S::V_OFF + s * S::KV_TILE;
        mbar_expect_tx(bar_k + 8 * s, S::KV_TILE);
#pragma unroll
        for (int c = 0; c < S::NCH; ++c)
          tma_load(kd + c * S::KV_CHUNK, &mk, bar_k + 8 * s, c * CHUNK,
                   coord(pk, 0, k0, h, b), coord(pk, 1, k0, h, b), coord(pk, 2, k0, h, b));
        mbar_expect_tx(bar_v + 8 * s, S::KV_TILE);
#pragma unroll
        for (int c = 0; c < S::NCH; ++c)
          tma_load(vd + c * S::KV_CHUNK, &mv, bar_v + 8 * s, c * CHUNK,
                   coord(pv, 0, k0, h, b), coord(pv, 1, k0, h, b), coord(pv, 2, k0, h, b));
      }
    }
  } else {
    // ---- consumers: rows 64 * cq .. 64 * cq + 63 of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cq = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_rows = base + cq * 64 * ROW_BYTES;

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf;     // running max of rows g, g + 8 (log2 units)
    float l0 = 0.0f, l1 = 0.0f;           // this thread's share of their sums

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      const uint32_t ph = (kt / STAGES) & 1;
      const uint32_t ks = base + S::K_OFF + s * S::KV_TILE;
      const uint32_t vs = base + S::V_OFF + s * S::KV_TILE;

      // S = Q K^T: 64 x 128 in fp32, K-major operands
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
      mbar_wait(bar_k + 8 * s, ph);
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const uint32_t off = (kk / 4) * S::Q_CHUNK + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * S::KV_CHUNK + (kk % 4) * 32;
        wgmma_ss<T>(sc, make_desc(q_rows + off, 16, 1024), make_desc(ks + koff, 16, 1024),
                    kk > 0);
      }
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // online softmax; sc[4j + e]: row g (e < 2) or g + 8, key 8j + 2t + (e & 1)
      const int k0 = kt * TK;
      float mul = sl2, mx0 = kNegInf, mx1 = kNegInf;
      if (k0 + TK > Lk) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          float x = sc[i] * sl2;
          if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= Lk) x = kNegInf;
          sc[i] = x;
          if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
        }
        mul = 1.0f;
      } else if (sl2 >= 0.0f) {
        mx0 = mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
        }
        mx0 *= sl2;
        mx1 *= sl2;
      } else {
        mx0 = mx1 = INFINITY;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (i & 2) mx1 = fminf(mx1, sc[i]); else mx0 = fminf(mx0, sc[i]);
        }
        mx0 *= sl2;
        mx1 *= sl2;
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float a0 = fast_ex2(m0 - n0), a1 = fast_ex2(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const float mm = (i & 2) ? n1 : n0;
        const float p0 = fast_ex2(fmaf(sc[i], mul, -mm)),
                    p1 = fast_ex2(fmaf(sc[i + 1], mul, -mm));
        if (i & 2) l1 += p0 + p1; else l0 += p0 + p1;
        pa[i / 2] = Pack<T>::two(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a1 : a0;

      // O += P V: P's accumulator layout is the A fragment of k-step kk
      // (registers pa[4 kk .. 4 kk + 3]); V MN-major, 128 keys of 128 bytes
      mbar_wait(bar_v + 8 * s, ph);
      fence_regs(o);
      fence_regs(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<T>(o, pa + 4 * kk, make_desc(vs + kk * 16 * ROW_BYTES, S::KV_CHUNK, 1024));
      wg_commit();
      wg_wait0();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

    // epilogue: o / max(l, 1e-30) into the spent Q rows (same swizzle), then
    // one TMA store a chunk; the store clips rows past Lq and columns past Dh
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int r = 16 * warp + g + ((i & 2) ? 8 : 0);   // row within the 64
      const int col = 8 * (i / 4) + 2 * t;
      const float inv = (i & 2) ? i1 : i0;
      const uint32_t unit = ((col % CHUNK) / 8) ^ (r % 8);
      unsigned char* dst = smem + (col / CHUNK) * S::Q_CHUNK + (cq * 64 + r) * ROW_BYTES +
                           unit * 16 + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) = Pack<T>::two(o[i] * inv, o[i + 1] * inv);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cq), "r"(WG) : "memory");
    if (tid == 0) {
      const int po = (perms >> 18) & 63;
      const int r0 = q0 + 64 * cq;
#pragma unroll
      for (int c = 0; c < S::NCH; ++c)
        tma_store(&mo, q_rows + c * S::Q_CHUNK, c * CHUNK, coord(po, 0, r0, h, b),
                  coord(po, 1, r0, h, b), coord(po, 2, r0, h, b));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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
  int perms;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map of a (B, H, rows, Dh) operand: Dh first, then rows, heads and
// batches in the order `perm` gives; a box of 64 columns by `box_rows` rows.
// Returns 0, or kTensorMapError + the CUresult.
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int Dh, int rows, int H, int B,
           const Strides& st, int perm, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  const long ext[3] = {rows, H, B};
  const long str[3] = {st.l, st.h, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)Dh, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {CHUNK, 1, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  for (int pos = 0; pos < 3; ++pos) {
    const int which = (perm >> (2 * pos)) & 3;
    dims[1 + pos] = (cuuint64_t)ext[which];
    strides[pos] = (cuuint64_t)str[which] * sizeof(T);
    if (which == 0) box[1 + pos] = (cuuint32_t)box_rows;
  }
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUresult res = fn(map, dt, 4, const_cast<void*>(ptr), dims, strides, box, estr,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + (int)res;
}

template <typename T, int DHP>
int launch_wgmma(const Args& a) {
  CUtensorMap mq, mk, mv, mo;
  int err = encode<T>(&mq, a.q, a.Dh, a.Lq, a.H, a.B, a.qs, a.perms & 63, TQ);
  if (!err) err = encode<T>(&mk, a.k, a.Dh, a.Lk, a.H, a.B, a.ks, (a.perms >> 6) & 63, TK);
  if (!err) err = encode<T>(&mv, a.v, a.Dh, a.Lk, a.H, a.B, a.vs, (a.perms >> 12) & 63, TK);
  if (!err) err = encode<T>(&mo, a.o, a.Dh, a.Lq, a.H, a.B, a.os, (a.perms >> 18) & 63, 64);
  if (err) return err;
  constexpr int smem = HopSmem<DHP>::ALLOC;
  cudaError_t e = allow_smem(flash_fwd_wgmma<T, DHP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Lq + TQ - 1) / TQ, a.B * a.H);
  flash_fwd_wgmma<T, DHP><<<grid, HOP_THREADS, smem, a.stream>>>(
      mq, mk, mv, mo, a.H, a.Lk, a.scale * kLog2e, a.perms);
  return cudaGetLastError();
}

template <typename T>
int launch(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.Dh <= 32) return launch_simt<32>(a);
    if (a.Dh <= 64) return launch_simt<64>(a);
    return launch_simt<128>(a);
  } else {
    if (a.Dh <= 64) return launch_wgmma<T, 64>(a);
    return launch_wgmma<T, 128>(a);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t, or kTensorMapError (+ the CUresult)
// when a tensor map cannot be encoded. Requires 16 <= Dh <= 128 with Dh a
// multiple of 16, Lq, Lk >= 1, B * H <= 65535, and a dense last dimension;
// strides are in elements (qsb, qsh, qsl: batch, head, row). For bf16 and
// fp16, `perms` packs each operand's TMA dimension order (6 bits each: q,
// k, v, o; 2 bits a dimension, 0 row, 1 head, 2 batch), and every base must
// be 16-byte aligned with strides that are multiples of 8 elements; fp32
// ignores it.
int vetk_flash_attention(int dtype, const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Lq, int Lk, int Dh, float scale,
                         long qsb, long qsh, long qsl, long ksb, long ksh, long ksl,
                         long vsb, long vsh, long vsl, long osb, long osh, long osl,
                         int perms, void* stream) {
  if (Dh < 16 || Dh > 128 || Dh % 16 || Lq < 1 || Lk < 1 || B < 1 || H < 1 ||
      (long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, H, Lq, Lk, Dh, scale,
               Strides{qsb, qsh, qsl}, Strides{ksb, ksh, ksl},
               Strides{vsb, vsh, vsl}, Strides{osb, osh, osl}, perms,
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

// Dynamic shared memory of the bf16/fp16 kernel at padded width dhp (64 or
// 128), for the wrapper's plan to check against.
int vetk_flash_smem(int dhp) {
  return dhp <= 64 ? HopSmem<64>::ALLOC : HopSmem<128>::ALLOC;
}

}  // extern "C"
