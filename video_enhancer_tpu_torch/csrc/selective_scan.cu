// The Mamba-1 selective scans (diagonal state, per-channel decay) for Hopper
// (sm_90a):
//
//   h_t = exp(dt_t * A[d]) o h_{t-1} + dt_t * x_t * B_t      (N states per channel)
//   y_t = C_t . h_t + D[d] * x_t
//
// Replaces four TPU kernels of video_enhancer_tpu/ops/scan.py:
//   row 6  _selective_scan_bidir_impl -> _scan_bidir_kernel (pallas_call :460):
//          a forward and a backward stateless scan in one loop;
//   row 7  _selective_scan_pallas_short_impl -> _scan_short_kernel (:241):
//          h0 in, h_last out;
//   row 8  _selective_scan_pallas_short_nostate_impl -> _scan_short_kernel_nostate
//          (:362): zero state in, none out;
//   row 9  _selective_scan_pallas_impl -> _scan_kernel (:556): long sequences,
//          h0 in, h_last out;
//   row 10 _scan_bidir_shared_impl -> _scan_bidir_shared_kernel (:736): a
//          forward and a backward stateless scan over SHARED u, B and C (the
//          directions differ in dt, A and D), y = yf + yb summed in fp32 and
//          cast once (selective_scan_bidir_shared(impl="bmajor")).
//
// What bounds them on an H100. Rows 6-8 serve the video models' temporal
// axis: B = B*H*W per-pixel sequences (57600 at 180x320), L a handful of
// frames, D 96-128, N 4-16. Each step of a channel costs N exps and ~4N
// FMAs; in bf16 a step reads x and dt and writes y (6 bytes) plus B and C
// shared by the channels of a sequence. At fast_mamba_vsr's shape with a
// state (row 7: L 16, D 96, N 8) the streams are 0.56 GB and h0/h_last 0.35
// GB: 0.27 ms at 3.35 TB/s against 0.10 ms of fp32 operations, so bytes
// bound it; the exps (0.7 G, on the special-function units) come close.
// Row 9 at one window's rasters (B 7, L 57600, D 128, N 16) reads 0.34 GB
// and does 7.5 GFLOP: about even.
//
// Design. The TPU kernels held a (BB, N, D) state block in VMEM and walked
// a sequential grid; here:
// - rows 6-8: one block a sequence (several for D > 256), one thread a
//   channel with its N states and its row of A in registers, walking the L
//   steps. x, dt and y are read and written along d, so a warp's accesses
//   are contiguous. B_t and C_t are the same for every channel of the
//   sequence: the block stages them, 32 steps at a time, in shared memory
//   as fp32, and each thread reads them back as 16-byte broadcasts. h0 and
//   h_last are read and written in place in their (B, D, N) layout, 16
//   bytes a load. exp(dt A) is one ex2 on A pre-scaled by log2 e. 57600
//   blocks at the served shapes fill the card. This walking kernel serves
//   the shapes the tile kernels below do not take. Rows 7 and 8 up to N 8
//   have a tile kernel, row 8 at N 9-16 a sibling with one channel a
//   thread (scan_short_n16_kernel); row 6 has its own (scan_bidir_tile_kernel: both
//   streams' loads before the first step, both directions in one loop, x, B
//   and C read once when the streams share them, as
//   selective_scan_bidir_shared passes u, B and C twice). Its walking
//   kernel walks the forward stream up, then the backward stream down.
// - row 9: B*D channels (896 at the served shape) are too few for one
//   thread each over L = 57600, so the scan is chunked (CHUNK steps) in
//   three launches on one stream, as csrc/ssd_shared.cu does:
//     1. chunk_state: each (sequence, chunk, channel) scans its chunk from
//        zero state, writing the chunk's end state and sum of dt;
//     2. state_pass: one thread per (sequence, channel, state) walks the
//        chunks in order from h0, turning each chunk's end state into the
//        state entering it (decay exp(A * sum dt)), and writes h_last;
//     3. chunk_output: each chunk scans again from its entering state and
//        writes y.
//   The price is the inputs read twice, each exp computed twice (826 M a
//   walk at the served shape) and the chunk states (B, K, D, N) fp32
//   round-tripping device memory. The state walk reads no C and writes no
//   y. A single pass was measured against this on an H100 and lost: a
//   block a sequence walking L in tiles of 64 steps with its states in
//   registers, the runs of a tile joined by a warp scan, each exp once and
//   no scratch, took 1.30 ms (bf16) against 0.88 for these three launches,
//   and 0.69 even with its loads left out. What bounds both is issue, not
//   the exps: the scan's joins and the states split across warps (for
//   enough warps an SM) cost ~16 instructions an element, the walks ~5.5
//   each (PERF.md, PR 11).
// - row 10: up to L 32 and N 8 with u and both dt on the 16-byte grid, row
//   6's tile kernel on the shared streams with the directions in turn and a
//   summing epilogue (scan_bidir_sum_kernel: one output, the sum in fp32,
//   cast once). Other
//   shapes take a register kernel: as row 6's walking kernel, but B_t and
//   C_t of all L steps are staged once for both directions, u is read from
//   device memory once (the backward pass reads the block's few-KB slab
//   again from L1), and the forward pass keeps its y in registers as fp32
//   for the backward pass to add to. The loops
//   are unrolled to compile-time bounds (LMAX >= L up to SHARED_MAX_L, NMAX
//   >= N), so the registers hold only the states the shape needs: 55-64
//   registers and 8 blocks an SM at the served shapes (holding u in
//   registers as well, and every state to MAX_N, took 76-94 registers and
//   read 0.86-0.91 ms against 0.51-0.55 ms at vsrm's shape). Longer L takes
//   a version that walks both directions as row 6 does and passes the
//   forward y through an fp32 workspace. At vsrm's composed temporal shape
//   (B 57600, L 7, D 128, N 4, bf16) it moves 419 MB, 0.125 ms at 3.35
//   TB/s, against 3.9 GFLOP (0.059 ms at the fp32 rate): bytes.
// All arithmetic is fp32 on CUDA cores; storage is fp32, bf16 or fp16, y in
// x's dtype, states fp32. Nothing is padded: ragged B and L are bounds.
//
// Layouts: x, dt, B, C are (B, L, width) with a dense last dim and their
// own batch and step strides (column slices of a wider projection and step
// slices of a longer sequence qualify); A (D, N) and Dv (D,) fp32; h0,
// h_last (B, D, N) fp32 contiguous; y (B, L, D) contiguous. Scratch of row
// 9: states (B, K, D, N) and sumdt (B, K, D) fp32, K = ceil(L / CHUNK).

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int MAX_N = 16;
constexpr int MAX_THREADS = 256;  // channels a block, all of one sequence
constexpr int STAGE = 32;         // steps of B and C staged in shared memory
constexpr int CHUNK = 128;        // row 9: steps a chunk
constexpr int SHARED_MAX_L = 32;  // row 10: longest L held in registers
constexpr int PASS_THREADS = 128;
constexpr int PASS_UNROLL = 8;
constexpr float LOG2E = 1.4426950408889634f;

// One direction's operands.
struct Operands {
  const void* x;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  long sbx, slx, sbdt, sldt, sbb, slb, sbc, slc;  // batch and step strides
};

// `dst` = src[0..N), zero beyond (up to NMAX, a multiple of 4); 16-byte
// loads when N and src allow.
template <int NMAX = MAX_N>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int N,
                                         float* dst) {
  if ((N & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < NMAX / 4; ++q) {
      const float4 v = 4 * q < N ? reinterpret_cast<const float4*>(src)[q]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      dst[4 * q] = v.x, dst[4 * q + 1] = v.y, dst[4 * q + 2] = v.z, dst[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) dst[n] = n < N ? src[n] : 0.0f;
  }
}

template <int NMAX = MAX_N>
__device__ __forceinline__ void store_row(const float* src, int N,
                                          float* __restrict__ dst) {
  if ((N & 3) == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < NMAX / 4; ++q)
      if (4 * q < N)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
  } else {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) dst[n] = src[n];
  }
}

// A's row d times log2 e, so that exp(dt A) = exp2(dt a2) (one ex2 a state).
template <int NMAX = MAX_N>
__device__ __forceinline__ void load_a(const float* __restrict__ A, int d, int N,
                                       float* a2) {
#pragma unroll
  for (int n = 0; n < NMAX; ++n) a2[n] = n < N ? A[(size_t)d * N + n] * LOG2E : 0.0f;
}

// 2^x on the special-function unit, one instruction (exp2f adds a range
// fix for results below the smallest normal float; ftz flushes them to 0).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One step of a channel: h = exp(dt A) o h + dt x B_t, from B_t and C_t
// staged as fp32 at `bcs` (B, then C, MAX_N floats each); returns y0 +
// C_t . h (y0 without kC, which needs no C). NMAX (a multiple of 4, >= N)
// bounds the unrolled states.
template <int NMAX = MAX_N, bool kC = true>
__device__ __forceinline__ float step(float* h, const float* a2, float dtv, float xv,
                                      const float* bcs, int N, float y0) {
  const float drive = dtv * xv;
  const float4* bq = reinterpret_cast<const float4*>(bcs);
  float yv = y0;
#pragma unroll
  for (int q = 0; q < NMAX / 4; ++q) {
    if (4 * q < N) {
      const float4 b4 = bq[q];
      const float4 c4 = kC ? bq[MAX_N / 4 + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 4 * q + k;
        h[n] = ex2_ftz(dtv * a2[n]) * h[n] + drive * bv[k];
        if (kC) yv += h[n] * cv[k];
      }
    }
  }
  return yv;
}

// Stages B_t and C_t of `steps` steps from s0 of sequence b into `bc` as
// fp32, 2 * MAX_N floats a step (B, then C, zeros beyond N; without kC, B
// only). Every thread of the block takes part; the caller synchronises.
template <typename T, bool kC = true>
__device__ __forceinline__ void stage_bc(const Operands& o, long b, int s0, int steps,
                                         int N, float* bc) {
  const T* __restrict__ Bm = static_cast<const T*>(o.B) + b * o.sbb;
  const T* __restrict__ Cm = static_cast<const T*>(o.C) + b * o.sbc;
  constexpr int W = kC ? 2 * MAX_N : MAX_N;   // floats staged a step
  for (int i = threadIdx.x; i < steps * W; i += blockDim.x) {
    const int s = i / W, j = i - s * W;
    const int n = j < MAX_N ? j : j - MAX_N;
    float v = 0.0f;
    if (n < N) {
      const long t = s0 + s;
      v = to_f32(j < MAX_N ? Bm[t * o.slb + n] : Cm[t * o.slc + n]);
    }
    bc[s * 2 * MAX_N + j] = v;
  }
}

// Walks steps [t_begin, t_end) of sequence b for channel d (back to front
// when `reverse`), advancing the N states h from and into registers, and
// writes y (plus `add` at the same place, when not null) unless y is null;
// returns the sum of dt over the steps. Without kY it writes no y and
// neither stages nor reads C. Every thread of the block calls it
// (B_t and C_t of the block's sequence are staged in shared memory `bc`,
// STAGE steps at a time); `live` says whether this thread's channel exists.
template <typename T, typename TY = T, bool kY = true>
__device__ __forceinline__ float walk(const Operands& o, long b, int d, bool live,
                                      int t_begin, int t_end, int L, int D, int N,
                                      bool reverse, const float* a2, float dd,
                                      float* h, TY* __restrict__ y, float* bc,
                                      const float* add = nullptr) {
  const T* __restrict__ x = static_cast<const T*>(o.x) + b * o.sbx + d;
  const T* __restrict__ dt = static_cast<const T*>(o.dt) + b * o.sbdt + d;
  float dsum = 0.0f;
  for (int c0 = 0; c0 < t_end - t_begin; c0 += STAGE) {
    const int steps = min(STAGE, t_end - t_begin - c0);
    const int s0 = reverse ? t_end - c0 - steps : t_begin + c0;
    __syncthreads();  // the previous stage has been read
    stage_bc<T, kY>(o, b, s0, steps, N, bc);
    __syncthreads();
    if (!live) continue;
    for (int u = 0; u < steps; ++u) {
      const int s = reverse ? steps - 1 - u : u;
      const long t = s0 + s;
      const float xv = to_f32(x[t * o.slx]);
      const float dtv = to_f32(dt[t * o.sldt]);
      const float yv = step<MAX_N, kY>(h, a2, dtv, xv, bc + s * 2 * MAX_N, N, dd * xv);
      if (kY && y) {
        const size_t e = ((size_t)b * L + t) * D + d;
        y[e] = from_f32<TY>(add ? add[e] + yv : yv);
      }
      dsum += dtv;
    }
  }
  return dsum;
}

// Rows 7 (kState) and 8. Grid (B, ceil(D / blockDim)).
template <typename T, bool kState>
__global__ void __launch_bounds__(MAX_THREADS)
scan_short_kernel(Operands o, const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hlast, int L, int D, int N) {
  __shared__ __align__(16) float bc[STAGE * 2 * MAX_N];
  const long b = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = d < D;
  float a2[MAX_N], h[MAX_N];
#pragma unroll
  for (int n = 0; n < MAX_N; ++n) h[n] = 0.0f;
  float dd = 0.0f;
  if (live) {
    load_a(o.A, d, N, a2);
    if (kState) load_row(h0 + ((size_t)b * D + d) * N, N, h);
    dd = o.D[d];
  }
  walk<T>(o, b, d, live, 0, L, L, D, N, false, a2, dd, h, y, bc);
  if (kState && live) store_row(h, N, hlast + ((size_t)b * D + d) * N);
}

// Rows 7 and 8 at L <= LMAX (16 or 32) and N <= NMAX (4 or 8): `seqs`
// sequences a block, ceil(D / 2) threads a sequence, two adjacent channels
// a thread. Every load of the block is issued before the first step: x and
// dt of all L steps by 16-byte cp.async into shared memory (so x and dt
// must be 16-byte aligned with D and their strides multiples of 16 bytes;
// other operands keep the walking kernel: on an H100 the tile kernel with
// element loads took 0.92 ms at (57600, 16, 95, 8) bf16, the walking kernel
// 0.69 at D 96), A, D and h0 into
// registers, B and C into registers eight at a time and then to shared
// memory as fp32; the steps read x and dt as pairs from shared memory, y
// takes x's place there and leaves in 16-byte stores. exp(dt A) is one
// ex2.approx.ftz on A pre-scaled by log2 e. Larger N takes the kernel that
// walks any L (row 7) or scan_short_n16_kernel, one channel a thread (row
// 8; two channels a thread at N 16 held 2x the registers and ran slower
// than the walking kernel). At the sharded fast_mamba_vsr's shape the steps alone
// take ~0.26 ms (the exps' floor is 0.19) and the loads alone ~0.22, and a
// block's loads do not overlap its steps; a persistent version that loaded
// the next group under the current group's steps held 104-143 registers
// and ran slower (0.65-1.1 ms against 0.48). Grid ceil(B / seqs); blockDim
// seqs * ceil(D / 2).
constexpr int TILE_THREADS = 256;
constexpr int TILE_MAX_N = 8;

__host__ __device__ inline int tile_ld(int D) { return (D + 7) / 8 * 8; }

// Bytes of shared memory of the tile kernel (ops/scan.py _short_scan_plan
// mirrors the sum): x and dt tiles (L rows of tile_ld(D)), then B and C as
// fp32 (L rows of 2 * NMAX), a sequence after another.
__host__ __device__ inline int tile_smem(int item, int L, int D, int nmax, int seqs) {
  return seqs * (2 * L * tile_ld(D) * item + L * 2 * nmax * 4);
}

template <typename T> struct Pair;
template <> struct Pair<float> {
  static __device__ __forceinline__ float2 ld(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void st(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 ld(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};
template <> struct Pair<__half> {
  static __device__ __forceinline__ float2 ld(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  static __device__ __forceinline__ void st(__half* p, float a, float b) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One step of two channels sharing B_t and C_t (fp32 at `bc`: B, then C,
// NMAX floats each): h = exp(dt A) o h + dt x B_t; y += C_t . h.
template <int NMAX>
__device__ __forceinline__ void step_pair(float* h0, float* h1, const float* a0,
                                          const float* a1, float2 dtv, float2 xv,
                                          const float* bc, int N, float& y0,
                                          float& y1) {
  const float u0 = dtv.x * xv.x, u1 = dtv.y * xv.y;
  const float4* bq = reinterpret_cast<const float4*>(bc);
#pragma unroll
  for (int q = 0; q < NMAX / 4; ++q) {
    if (4 * q < N) {
      const float4 b4 = bq[q], c4 = bq[NMAX / 4 + q];
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 4 * q + k;
        h0[n] = ex2_ftz(dtv.x * a0[n]) * h0[n] + u0 * bv[k];
        h1[n] = ex2_ftz(dtv.y * a1[n]) * h1[n] + u1 * bv[k];
        y0 += h0[n] * cv[k];
        y1 += h1[n] * cv[k];
      }
    }
  }
}

// Stages B_t and C_t of the block's nseq sequences, every step, as fp32 at
// `bc` (NMAX floats of B, then of C, a step; zeros beyond N): eight loads in
// flight a thread, then to shared memory.
template <typename T, int NMAX>
__device__ __forceinline__ void stage_bc_tile(const Operands& o, long b0, int nseq,
                                              int L, int N, float* bc) {
  const T* __restrict__ Bm = static_cast<const T*>(o.B);
  const T* __restrict__ Cm = static_cast<const T*>(o.C);
  const int total = nseq * L * 2 * NMAX;
  for (int i0 = threadIdx.x; i0 < total; i0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * blockDim.x;
      const int row = i / (2 * NMAX), j = i - row * (2 * NMAX);
      const int rs = row / L, t = row - rs * L;
      const int n = j < NMAX ? j : j - NMAX;
      const long rb = b0 + rs;
      v[u] = 0.0f;
      if (i < total && n < N)
        v[u] = to_f32(j < NMAX ? Bm[rb * o.sbb + t * o.slb + n]
                               : Cm[rb * o.sbc + t * o.slc + n]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * blockDim.x < total) bc[i0 + u * blockDim.x] = v[u];
  }
}

// x and dt of the block's nseq sequences, all L steps, into the tiles xs and
// ds (rows of Dp) by 16-byte cp.async; the caller commits.
template <typename T>
__device__ __forceinline__ void copy_x_dt(const Operands& o, long b0, int nseq, int L,
                                          int D, int Dp, T* xs, T* ds) {
  constexpr int SEG = 16 / sizeof(T);   // elements a 16-byte copy
  const T* __restrict__ xg = static_cast<const T*>(o.x);
  const T* __restrict__ dg = static_cast<const T*>(o.dt);
  const int segs = D / SEG;
  for (int i = threadIdx.x; i < nseq * L * segs; i += blockDim.x) {
    const int row = i / segs, c = (i - row * segs) * SEG;
    const int sq = row / L, t = row - sq * L;
    const long b = b0 + sq;
    cp_async16(xs + (size_t)row * Dp + c, xg + b * o.sbx + t * o.slx + c);
    cp_async16(ds + (size_t)row * Dp + c, dg + b * o.sbdt + t * o.sldt + c);
  }
}

// The block's y tile (nseq * L rows of Dp at ys) out in 16-byte stores: its
// rows are contiguous in (B, L, D).
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const T* ys, long b0,
                                           int nseq, int L, int D, int Dp) {
  constexpr int SEG = 16 / sizeof(T);
  const int segs = D / SEG;
  T* yb = y + b0 * L * D;
  for (int i = threadIdx.x; i < nseq * L * segs; i += blockDim.x) {
    const int row = i / segs, c = (i - row * segs) * SEG;
    *reinterpret_cast<uint4*>(yb + (size_t)row * D + c) =
        *reinterpret_cast<const uint4*>(ys + (size_t)row * Dp + c);
  }
}

template <typename T, bool kState, int LMAX, int NMAX>
__global__ void __launch_bounds__(TILE_THREADS)
scan_short_tile_kernel(Operands o, const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ hlast, long Bsz, int L, int D, int N,
                       int seqs) {
  extern __shared__ __align__(16) char smem[];
  const int Dp = tile_ld(D), tps = (D + 1) / 2;
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + (size_t)seqs * L * Dp;
  float* bc = reinterpret_cast<float*>(ds + (size_t)seqs * L * Dp);
  const long b0 = (long)blockIdx.x * seqs;
  const int nseq = (int)min((long)seqs, Bsz - b0);
  copy_x_dt<T>(o, b0, nseq, L, D, Dp, xs, ds);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int sq = threadIdx.x / tps, d = 2 * (threadIdx.x - sq * tps);
  const bool live = sq < nseq, two = d + 1 < D;
  const long b = b0 + sq;
  float a0[NMAX], a1[NMAX], h0r[NMAX], h1r[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) a0[n] = a1[n] = h0r[n] = h1r[n] = 0.0f;
  float dd0 = 0.0f, dd1 = 0.0f;
  if (live) {
    load_a<NMAX>(o.A, d, N, a0);
    dd0 = o.D[d];
    if (two) {
      load_a<NMAX>(o.A, d + 1, N, a1);
      dd1 = o.D[d + 1];
    }
    if (kState) {
      load_row<NMAX>(h0 + ((size_t)b * D + d) * N, N, h0r);
      if (two) load_row<NMAX>(h0 + ((size_t)b * D + d + 1) * N, N, h1r);
    }
  }
  stage_bc_tile<T, NMAX>(o, b0, nseq, L, N, bc);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (live) {
    T* xr = xs + (size_t)sq * L * Dp + d;
    const T* dr = ds + (size_t)sq * L * Dp + d;
    const float* bcs = bc + (size_t)sq * L * 2 * NMAX;
#pragma unroll
    for (int t = 0; t < LMAX; ++t) {
      if (t < L) {
        const float2 xv = Pair<T>::ld(xr + t * Dp);
        const float2 dv = Pair<T>::ld(dr + t * Dp);
        float y0 = dd0 * xv.x, y1 = dd1 * xv.y;
        step_pair<NMAX>(h0r, h1r, a0, a1, dv, xv, bcs + t * 2 * NMAX, N, y0, y1);
        Pair<T>::st(xr + t * Dp, y0, y1);
      }
    }
  }
  __syncthreads();
  store_tile<T>(y, xs, b0, nseq, L, D, Dp);
  if (kState && live) {
    store_row<NMAX>(h0r, N, hlast + ((size_t)b * D + d) * N);
    if (two) store_row<NMAX>(h1r, N, hlast + ((size_t)b * D + d + 1) * N);
  }
}

// Row 8 at L <= LMAX (16 or 32) and 8 < N <= 16, x and dt on the 16-byte
// grid: one channel a thread (D threads a sequence, `seqs` sequences a
// group, one at D 128) in persistent blocks that walk groups blockIdx.x,
// + gridDim.x, ... through two stages of shared memory: the next group's x
// and dt (16-byte cp.async) and the 16-byte chunks that hold its B and C
// rows (column slices of x_proj, at any offset) are in flight while the
// current group steps. B and C then go to shared memory as fp32, 16 wide;
// A's row times log2 e and D stay in registers for every group; every
// state past N is zero (A, B and C padded), so the steps walk all 16
// without a guard; y takes x's place and leaves in 16-byte stores. 64
// registers (launch bounds for four blocks of 256 threads): eight blocks of
// 128 threads an SM. On an H100 at the per-pixel shape (57600, 7, 128, 16,
// bf16) it read 0.398 ms of device time against 0.486 for one stage (a
// block a group: its loads alone 0.17, its steps alone 0.41) and 0.539 for
// the walking kernel. The steps bound it: 0.41 ms with the exps or with
// FMAs in their place, twice the 826 M exps' 0.2 ms; without the B and C
// reads from shared memory 0.375. Grid min(groups, blocks an SM x SMs);
// blockDim seqs * D.
constexpr int BC_RAW = 80;   // bytes of a B or C row's chunks: 16 fp32 at any offset

// Bytes of a stage (x and dt tiles, then each row's B and C chunks) and of
// the kernel's shared memory (two stages, then B and C as fp32, 2 * MAX_N a
// step); ops/scan.py _tile_smem mirrors the sum.
__host__ __device__ inline int n16_stage(int item, int L, int D, int seqs) {
  return seqs * L * (2 * tile_ld(D) * item + 2 * BC_RAW);
}
__host__ __device__ inline int n16_smem(int item, int L, int D, int seqs) {
  return 2 * n16_stage(item, L, D, seqs) + seqs * L * 2 * MAX_N * 4;
}

template <typename T>
__device__ __forceinline__ const T* bc_row(const Operands& o, long b, int t, int c) {
  return c ? static_cast<const T*>(o.C) + b * o.sbc + t * o.slc
           : static_cast<const T*>(o.B) + b * o.sbb + t * o.slb;
}

// The 16-byte chunks that hold B and C of the group's nseq * L rows into
// `raw` (BC_RAW bytes a row and operand, B before C) by cp.async.
template <typename T>
__device__ __forceinline__ void copy_bc_rows(const Operands& o, long b0, int nseq, int L,
                                             int N, char* raw) {
  constexpr int CH = BC_RAW / 16;
  for (int i = threadIdx.x; i < nseq * L * 2 * CH; i += blockDim.x) {
    const int r = i / CH, c = i - r * CH;
    const int row = r >> 1, q = row / L, t = row - q * L;
    const T* src = bc_row<T>(o, b0 + q, t, r & 1);
    const size_t lo = reinterpret_cast<size_t>(src) & ~(size_t)15;
    if (lo + 16 * c < reinterpret_cast<size_t>(src + N))
      cp_async16(raw + (size_t)r * BC_RAW + 16 * c,
                 reinterpret_cast<const void*>(lo + 16 * c));
  }
}

// B and C of the group's rows from their chunks to `bc` as fp32, 2 * MAX_N
// a step (zeros past N).
template <typename T>
__device__ __forceinline__ void widen_bc_rows(const Operands& o, long b0, int nseq, int L,
                                              int N, const char* raw, float* bc) {
  for (int i = threadIdx.x; i < nseq * L * 2 * MAX_N; i += blockDim.x) {
    const int row = i / (2 * MAX_N), j = i - row * (2 * MAX_N);
    const int c = j >= MAX_N, n = j - c * MAX_N, q = row / L, t = row - q * L;
    float v = 0.0f;
    if (n < N) {
      const size_t off = reinterpret_cast<size_t>(bc_row<T>(o, b0 + q, t, c)) & 15;
      v = to_f32(*reinterpret_cast<const T*>(raw + (size_t)(2 * row + c) * BC_RAW + off +
                                             n * sizeof(T)));
    }
    bc[i] = v;
  }
}

template <typename T, int LMAX>
__global__ void __launch_bounds__(TILE_THREADS, 4)
scan_short_n16_kernel(Operands o, T* __restrict__ y, long Bsz, int L, int D, int N,
                      int seqs) {
  extern __shared__ __align__(16) char smem[];
  const int Dp = tile_ld(D), stage = n16_stage(sizeof(T), L, D, seqs);
  const size_t tile = (size_t)seqs * L * Dp;
  float* bc = reinterpret_cast<float*>(smem + 2 * stage);
  const long groups = (Bsz + seqs - 1) / seqs;
  const int sq = threadIdx.x / D, d = threadIdx.x - sq * D;
  float a2[MAX_N], h[MAX_N];
  load_a(o.A, d, N, a2);
  const float dd = o.D[d];
  auto fetch = [&](long g, int into) {
    T* xs = reinterpret_cast<T*>(smem + into * stage);
    const long b0 = g * seqs;
    const int nseq = (int)min((long)seqs, Bsz - b0);
    copy_x_dt<T>(o, b0, nseq, L, D, Dp, xs, xs + tile);
    copy_bc_rows<T>(o, b0, nseq, L, N, reinterpret_cast<char*>(xs + 2 * tile));
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int s = 0;
  if (blockIdx.x < groups) fetch(blockIdx.x, 0);
  for (long g = blockIdx.x; g < groups; g += gridDim.x, s ^= 1) {
    if (g + gridDim.x < groups)
      fetch(g + gridDim.x, s ^ 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");   // keeps the count
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    T* xs = reinterpret_cast<T*>(smem + s * stage);
    const long b0 = g * seqs;
    const int nseq = (int)min((long)seqs, Bsz - b0);
    widen_bc_rows<T>(o, b0, nseq, L, N, reinterpret_cast<const char*>(xs + 2 * tile),
                     bc);
    __syncthreads();
    if (sq < nseq) {
      T* xr = xs + (size_t)sq * L * Dp + d;
      const T* dr = xr + tile;
      const float* bcs = bc + (size_t)sq * L * 2 * MAX_N;
#pragma unroll
      for (int n = 0; n < MAX_N; ++n) h[n] = 0.0f;
#pragma unroll
      for (int t = 0; t < LMAX; ++t) {
        if (t < L) {
          const float xv = to_f32(xr[t * Dp]);
          xr[t * Dp] = from_f32<T>(step(h, a2, to_f32(dr[t * Dp]), xv,
                                        bcs + t * 2 * MAX_N, MAX_N, dd * xv));
        }
      }
    }
    __syncthreads();
    store_tile<T>(y, xs, b0, nseq, L, D, Dp);
    __syncthreads();   // the stage is refilled next round
  }
}

// One stateless direction of rows 6 and 10, from zero state; y gets `add`
// added when that is not null.
template <typename T, typename TY = T>
__device__ __forceinline__ void scan_stream(const Operands& o, long b, int d, bool live,
                                            int L, int D, int N, bool reverse,
                                            TY* __restrict__ y, float* bc,
                                            const float* add = nullptr) {
  float a2[MAX_N], h[MAX_N];
#pragma unroll
  for (int n = 0; n < MAX_N; ++n) h[n] = 0.0f;
  float dd = 0.0f;
  if (live) {
    load_a(o.A, d, N, a2);
    dd = o.D[d];
  }
  walk<T, TY>(o, b, d, live, 0, L, L, D, N, reverse, a2, dd, h, y, bc, add);
}

// Row 6: the forward stream walks l up, then the backward stream walks l
// down (one direction's states live at a time). Grid (B, ceil(D / blockDim)).
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
scan_bidir_kernel(Operands fo, Operands bo, T* __restrict__ yf,
                  T* __restrict__ yb, int L, int D, int N) {
  __shared__ __align__(16) float bc[STAGE * 2 * MAX_N];
  const long b = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = d < D;
  scan_stream<T>(fo, b, d, live, L, D, N, false, yf, bc);
  scan_stream<T>(bo, b, d, live, L, D, N, true, yb, bc);
}

// Bytes of shared memory of the tile kernels of rows 6 and 10 (ops/scan.py
// _bidir_smem mirrors the sum): per sequence the x tiles (one when the
// streams share x), the two dt tiles (L rows of tile_ld(D)), then B and C as
// fp32 (L rows of 2 * NMAX; one set when the streams share them), then for
// row 10's sum an fp32 tile of L rows of tile_ld(D).
__host__ __device__ inline int bidir_smem(int item, int L, int D, int nmax, int seqs,
                                          bool shared, bool sum = false) {
  return seqs * ((shared ? 3 : 4) * L * tile_ld(D) * item +
                 (shared ? 1 : 2) * L * 2 * nmax * 4 + (sum ? L * tile_ld(D) * 4 : 0));
}

// Rows 6 and 10 at L <= LMAX (8, 16 or 32) and N <= NMAX (4 or 8), x and dt
// of both streams on the 16-byte grid: `seqs` sequences a block, D / 2
// threads a sequence, two adjacent channels a thread. Every load of the
// block is issued before the first step: x and dt of both streams by
// 16-byte cp.async (x once when the streams share it), A and D of both
// directions into registers, B and C of each stream (once when shared) into
// registers eight at a time and then to shared memory as fp32, NMAX wide.
// Row 6 (scan_bidir_tile_kernel): both directions walk in one loop, the
// forward stream at step t and the backward one at L - 1 - t, so a thread
// runs four independent ex2/FMA chains; y takes dt's place in shared
// memory (each step reads its dt pair before writing its y pair there) and
// leaves in 16-byte stores. `shared`: x, B and C of the two streams are one
// (equal pointers and strides, as selective_scan_bidir_shared(impl="bidir")
// passes them). At vsrm's composed shape (57600, 7, 128, N 4, bf16, shared)
// it moves 523 MB (0.156 ms at 3.35 TB/s) and takes 413 M exps (0.11 ms on
// the special-function units); on an H100 it read 0.26-0.27 ms of device
// time against 0.62 for the walking kernel. N 16 keeps the walking kernel:
// two channels of two directions would hold 64 states and 64 decays in
// registers.
// kSum (row 10, scan_bidir_sum_kernel; the streams shared): one output, y =
// yf + yb summed in fp32 and cast once, with the directions in turn, as the
// JAX kernel's two passes: the forward pass writes its y to an fp32 tile,
// the backward pass adds its own and writes the sum as T into the forward
// dt tile, whose row it no longer needs; that tile leaves in 16-byte
// stores. One direction's states and decays are live at a time and each
// pass is a rolled loop: 48-64 registers. On an H100 at fast_mamba_vsr's N
// 8 this read 0.63 ms against 0.73-0.85 for both directions in one loop
// (118-128 registers, rolled or not), and at vsrm's N 4 0.24 against 0.26.
template <typename T, int LMAX, int NMAX, bool kSum>
__device__ __forceinline__ void bidir_tile(char* smem, const Operands& fo,
                                           const Operands& bo, T* __restrict__ yf,
                                           T* __restrict__ yb, long Bsz, int L, int D,
                                           int N, int seqs, bool shared) {
  constexpr int SEG = 16 / sizeof(T);   // elements a 16-byte copy
  const int Dp = tile_ld(D), tps = D / 2;
  const size_t tile = (size_t)seqs * L * Dp;
  T* xfs = reinterpret_cast<T*>(smem);
  T* xbs = shared ? xfs : xfs + tile;
  T* dfs = xbs + tile;
  T* dbs = dfs + tile;
  float* bcf = reinterpret_cast<float*>(dbs + tile);
  float* bcb = shared ? bcf : bcf + (size_t)seqs * L * 2 * NMAX;
  float* acc = bcb + (size_t)seqs * L * 2 * NMAX;   // kSum: the fp32 tile
  const long b0 = (long)blockIdx.x * seqs;
  const int nseq = (int)min((long)seqs, Bsz - b0);

  const int segs = D / SEG;
  for (int i = threadIdx.x; i < nseq * L * segs; i += blockDim.x) {
    const int row = i / segs, c = (i - row * segs) * SEG;
    const int sq = row / L, t = row - sq * L;
    const long b = b0 + sq;
    const size_t e = (size_t)row * Dp + c;
    cp_async16(xfs + e, static_cast<const T*>(fo.x) + b * fo.sbx + t * fo.slx + c);
    if (!shared)
      cp_async16(xbs + e, static_cast<const T*>(bo.x) + b * bo.sbx + t * bo.slx + c);
    cp_async16(dfs + e, static_cast<const T*>(fo.dt) + b * fo.sbdt + t * fo.sldt + c);
    cp_async16(dbs + e, static_cast<const T*>(bo.dt) + b * bo.sbdt + t * bo.sldt + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int sq = threadIdx.x / tps, d = 2 * (threadIdx.x - sq * tps);
  const bool live = sq < nseq;
  float af0[NMAX], af1[NMAX], ab0[NMAX], ab1[NMAX];
  float hf0[NMAX], hf1[NMAX], hb0[NMAX], hb1[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
    af0[n] = af1[n] = ab0[n] = ab1[n] = hf0[n] = hf1[n] = hb0[n] = hb1[n] = 0.0f;
  float ddf0 = 0.0f, ddf1 = 0.0f, ddb0 = 0.0f, ddb1 = 0.0f;
  if (live) {
    load_a<NMAX>(fo.A, d, N, af0);
    load_a<NMAX>(fo.A, d + 1, N, af1);
    ddf0 = fo.D[d], ddf1 = fo.D[d + 1];
    if constexpr (!kSum) {
      load_a<NMAX>(bo.A, d, N, ab0);
      load_a<NMAX>(bo.A, d + 1, N, ab1);
      ddb0 = bo.D[d], ddb1 = bo.D[d + 1];
    }
  }
  stage_bc_tile<T, NMAX>(fo, b0, nseq, L, N, bcf);
  if (!shared) stage_bc_tile<T, NMAX>(bo, b0, nseq, L, N, bcb);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (live) {
    const size_t base = (size_t)sq * L * Dp + d;
    const float* bfs = bcf + (size_t)sq * L * 2 * NMAX;
    const float* bbs = bcb + (size_t)sq * L * 2 * NMAX;
    if constexpr (kSum) {
      // the directions in turn, each loop rolled: every state past N is
      // zero (A, B and C padded), so the steps walk all NMAX
#pragma unroll 1
      for (int t = 0; t < L; ++t) {
        const float2 xf = Pair<T>::ld(xfs + base + t * Dp);
        const float2 df = Pair<T>::ld(dfs + base + t * Dp);
        float yf0 = ddf0 * xf.x, yf1 = ddf1 * xf.y;
        step_pair<NMAX>(hf0, hf1, af0, af1, df, xf, bfs + t * 2 * NMAX, NMAX, yf0,
                        yf1);
        Pair<float>::st(acc + base + t * Dp, yf0, yf1);
      }
      load_a<NMAX>(bo.A, d, N, ab0);   // after the forward pass's states
      load_a<NMAX>(bo.A, d + 1, N, ab1);
      ddb0 = bo.D[d], ddb1 = bo.D[d + 1];
#pragma unroll 1
      for (int t = L - 1; t >= 0; --t) {
        const float2 xb = Pair<T>::ld(xfs + base + t * Dp);
        const float2 db = Pair<T>::ld(dbs + base + t * Dp);
        float yb0 = ddb0 * xb.x, yb1 = ddb1 * xb.y;
        step_pair<NMAX>(hb0, hb1, ab0, ab1, db, xb, bbs + t * 2 * NMAX, NMAX, yb0,
                        yb1);
        const float2 p = Pair<float>::ld(acc + base + t * Dp);
        Pair<T>::st(dfs + base + t * Dp, p.x + yb0, p.y + yb1);
      }
    } else {
#pragma unroll
      for (int t = 0; t < LMAX; ++t) {
        if (t < L) {
          const int tb = L - 1 - t;
          const float2 xf = Pair<T>::ld(xfs + base + t * Dp);
          const float2 df = Pair<T>::ld(dfs + base + t * Dp);
          const float2 xb = Pair<T>::ld(xbs + base + tb * Dp);
          const float2 db = Pair<T>::ld(dbs + base + tb * Dp);
          float yf0 = ddf0 * xf.x, yf1 = ddf1 * xf.y;
          float yb0 = ddb0 * xb.x, yb1 = ddb1 * xb.y;
          step_pair<NMAX>(hf0, hf1, af0, af1, df, xf, bfs + t * 2 * NMAX, N, yf0, yf1);
          step_pair<NMAX>(hb0, hb1, ab0, ab1, db, xb, bbs + tb * 2 * NMAX, N, yb0, yb1);
          Pair<T>::st(dfs + base + t * Dp, yf0, yf1);
          Pair<T>::st(dbs + base + tb * Dp, yb0, yb1);
        }
      }
    }
  }
  __syncthreads();

  if (kSum) {
    store_tile<T>(yf, dfs, b0, nseq, L, D, Dp);
    return;
  }
  // yf and yb: the block's nseq * L rows are contiguous in (B, L, D)
  T* yfb = yf + b0 * L * D;
  T* ybb = yb + b0 * L * D;
  for (int i = threadIdx.x; i < nseq * L * segs; i += blockDim.x) {
    const int row = i / segs, c = (i - row * segs) * SEG;
    const size_t e = (size_t)row * Dp + c, o = (size_t)row * D + c;
    *reinterpret_cast<uint4*>(yfb + o) = *reinterpret_cast<const uint4*>(dfs + e);
    *reinterpret_cast<uint4*>(ybb + o) = *reinterpret_cast<const uint4*>(dbs + e);
  }
}

// Row 6. Grid ceil(B / seqs); blockDim seqs * D / 2.
template <typename T, int LMAX, int NMAX>
__global__ void __launch_bounds__(TILE_THREADS)
scan_bidir_tile_kernel(Operands fo, Operands bo, T* __restrict__ yf,
                       T* __restrict__ yb, long Bsz, int L, int D, int N, int seqs,
                       bool shared) {
  extern __shared__ __align__(16) char smem[];
  bidir_tile<T, LMAX, NMAX, false>(smem, fo, bo, yf, yb, Bsz, L, D, N, seqs, shared);
}

// Row 10 at L <= LMAX and N <= NMAX, u, dtf and dtb on the 16-byte grid:
// `fo` and `bo` differ in dt, A and D only. At vsrm's composed shape (57600,
// 7, 128, N 4, bf16) the floors are its 419 MB (0.125 ms) and 413 M exps
// (~0.11 ms); at fast_mamba_vsr's (57600, 16, 96, N 8, B and C 19 wide
// slices of x_proj) 1.42 G exps (~0.36 ms) and ~0.74 GB (0.22 ms).
// Its loops are rolled, so one instance serves every L <= SHARED_MAX_L.
// Grid ceil(B / seqs); blockDim seqs * D / 2.
template <typename T, int NMAX>
__global__ void __launch_bounds__(TILE_THREADS)
scan_bidir_sum_kernel(Operands fo, Operands bo, T* __restrict__ y, long Bsz, int L,
                      int D, int N, int seqs) {
  extern __shared__ __align__(16) char smem[];
  bidir_tile<T, SHARED_MAX_L, NMAX, true>(smem, fo, bo, y, nullptr, Bsz, L, D, N,
                                          seqs, true);
}

// Row 10 for L <= LMAX and N <= NMAX where the tile kernel does not take
// the call (N > 8, or u or dt off the 16-byte grid): B_t and C_t of every
// step are staged once in shared memory for both directions; the forward pass keeps its y
// (with its D skip) in registers as fp32, the backward pass adds its own
// and stores y once. u is read in both passes, the second time from L1 (the
// block's slab is a few KB), which keeps the registers at 64 or fewer.
// Loops run over LMAX and NMAX with a guard, so every register index is
// static. `fo` and `bo` differ in dt, A and D only.
// Grid (B, ceil(D / blockDim)).
template <typename T, int LMAX, int NMAX>
__global__ void __launch_bounds__(MAX_THREADS, LMAX <= 16 ? 4 : 2)
scan_bidir_shared_kernel(Operands fo, Operands bo, T* __restrict__ y, int L,
                         int D, int N) {
  __shared__ __align__(16) float bc[LMAX * 2 * MAX_N];
  const long b = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  stage_bc<T>(fo, b, 0, L, N, bc);
  __syncthreads();
  if (d >= D) return;
  const T* __restrict__ u = static_cast<const T*>(fo.x) + b * fo.sbx + d;
  float acc[LMAX], a2[NMAX], h[NMAX];

  load_a<NMAX>(fo.A, d, N, a2);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) h[n] = 0.0f;
  const float df = fo.D[d];
  const T* __restrict__ dtf = static_cast<const T*>(fo.dt) + b * fo.sbdt + d;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (l < L) {
      const float xv = to_f32(u[l * fo.slx]);
      acc[l] = step<NMAX>(h, a2, to_f32(dtf[l * fo.sldt]), xv,
                          bc + l * 2 * MAX_N, N, df * xv);
    }
  }

  load_a<NMAX>(bo.A, d, N, a2);
#pragma unroll
  for (int n = 0; n < NMAX; ++n) h[n] = 0.0f;
  const float db = bo.D[d];
  const T* __restrict__ dtb = static_cast<const T*>(bo.dt) + b * bo.sbdt + d;
#pragma unroll
  for (int l = LMAX - 1; l >= 0; --l) {
    if (l < L) {
      // u again: the block's (L, D) slab was read a pass ago and sits in L1
      const float xv = to_f32(u[l * fo.slx]);
      const float yb = step<NMAX>(h, a2, to_f32(dtb[l * bo.sldt]), xv,
                                  bc + l * 2 * MAX_N, N, db * xv);
      y[((size_t)b * L + l) * D + d] = from_f32<T>(acc[l] + yb);
    }
  }
}

// Row 10 for longer L: the forward pass writes its y to an fp32 workspace
// laid out as y, the backward pass adds it to its own and stores y once
// (each thread reads back only what it wrote). Grid (B, ceil(D / blockDim)).
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
scan_bidir_shared_ws_kernel(Operands fo, Operands bo, float* __restrict__ ws,
                            T* __restrict__ y, int L, int D, int N) {
  __shared__ __align__(16) float bc[STAGE * 2 * MAX_N];
  const long b = blockIdx.x;
  const int d = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = d < D;
  scan_stream<T, float>(fo, b, d, live, L, D, N, false, ws, bc);
  scan_stream<T, T>(bo, b, d, live, L, D, N, true, y, bc, ws);
}

// Row 9, phase 1 (kOutput false): chunk end states from zero state and the
// chunk's sum of dt. Phase 3 (kOutput true): y from the entering states.
// Grid (B, K, ceil(D / blockDim)).
template <typename T, bool kOutput>
__global__ void __launch_bounds__(MAX_THREADS)
scan_chunk_kernel(Operands o, float* __restrict__ states, float* __restrict__ sumdt,
                  T* __restrict__ y, int L, int D, int N, int K) {
  __shared__ __align__(16) float bc[STAGE * 2 * MAX_N];
  const long b = blockIdx.x;
  const int k = blockIdx.y;
  const int d = blockIdx.z * blockDim.x + threadIdx.x;
  const bool live = d < D;
  float a2[MAX_N], h[MAX_N];
#pragma unroll
  for (int n = 0; n < MAX_N; ++n) h[n] = 0.0f;
  float dd = 0.0f;
  float* st = states + (((size_t)b * K + k) * D + d) * N;
  if (live) {
    load_a(o.A, d, N, a2);
    if (kOutput) load_row(st, N, h);
    dd = o.D[d];
  }
  const int t0 = k * CHUNK, t1 = min(t0 + CHUNK, L);
  const float dsum = walk<T, T, kOutput>(o, b, d, live, t0, t1, L, D, N, false, a2,
                                         dd, h, kOutput ? y : nullptr, bc);
  if (!kOutput && live) {
    store_row(h, N, st);
    sumdt[((size_t)b * K + k) * D + d] = dsum;
  }
}

// Row 9, phase 2: states[b, k, d, n] := the state entering chunk k; h_last.
// One thread per (b, d, n).
__global__ void __launch_bounds__(PASS_THREADS)
scan_state_pass_kernel(float* __restrict__ states, const float* __restrict__ sumdt,
                       const float* __restrict__ A, const float* __restrict__ h0,
                       float* __restrict__ hlast, int Bsz, int D, int N, int K) {
  const long e = (long)blockIdx.x * PASS_THREADS + threadIdx.x;
  const long DN = (long)D * N;
  if (e >= (long)Bsz * DN) return;
  const int b = (int)(e / DN);
  const int dn = (int)(e - (long)b * DN);
  const int d = dn / N;
  const float a = A[dn];
  float run = h0 ? h0[e] : 0.0f;
  float* s = states + (size_t)b * K * DN + dn;
  const float* sd = sumdt + (size_t)b * K * D + d;
  for (int k0 = 0; k0 < K; k0 += PASS_UNROLL) {
    float v[PASS_UNROLL], g[PASS_UNROLL];
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      const int k = k0 + u;
      if (k < K) {
        v[u] = s[(size_t)k * DN];
        g[u] = sd[(size_t)k * D];
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      const int k = k0 + u;
      if (k < K) {
        s[(size_t)k * DN] = run;
        run = expf(a * g[u]) * run + v[u];
      }
    }
  }
  hlast[e] = run;
}

template <typename T>
struct Tag {
  using type = T;
};

template <typename F>
int by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kFloat32:
      return f(Tag<float>{});
    case kBFloat16:
      return f(Tag<__nv_bfloat16>{});
    case kFloat16:
      return f(Tag<__half>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline int blocks_for(long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// Threads a block: the channels of one sequence, in whole warps, at most
// MAX_THREADS (wider D takes several blocks a sequence).
inline int threads_for(int D) {
  const int warps = (D + 31) / 32 * 32;
  return warps < MAX_THREADS ? warps : MAX_THREADS;
}

inline bool bad_shape(int B, int L, int D, int N) {
  return B < 1 || L < 1 || D < 1 || N < 1 || N > MAX_N;
}

// strides: the batch and step strides of x, dt, B and C, in that order.
inline Operands operands(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, const void* Dv,
                         const long* strides) {
  return Operands{x,          dt,         static_cast<const float*>(A),
                  Bm,         Cm,         static_cast<const float*>(Dv),
                  strides[0], strides[1], strides[2],
                  strides[3], strides[4], strides[5],
                  strides[6], strides[7]};
}

}  // namespace

extern "C" {

// Chunk length of the long scan (row 9); the wrapper sizes its scratch.
int vetk_selective_scan_chunk() { return CHUNK; }

// Bytes of shared memory of the tile kernels (rows 7 and 8; N > 8: row 8's
// scan_short_n16_kernel) at these sizes.
int vetk_selective_scan_short_smem(int dtype, int L, int D, int N, int seqs) {
  const int item = dtype == kFloat32 ? 4 : 2;
  if (N > TILE_MAX_N) return n16_smem(item, L, D, seqs);
  return tile_smem(item, L, D, N <= 4 ? 4 : TILE_MAX_N, seqs);
}

// Rows 7 and 8. h0 and hlast both given: row 7; both null: row 8.
// strides (8 values, host memory): the batch and step strides, in elements,
// of x, dt, B and C. seqs > 0: the tile kernel with that many sequences a
// block (L <= SHARED_MAX_L, x and dt 16-byte aligned with D and their
// strides multiples of 16 bytes; N <= TILE_MAX_N with seqs * ceil(D / 2) <=
// TILE_THREADS, or, row 8 only, N <= MAX_N with seqs * D <= TILE_THREADS,
// one channel a thread, in `blocks` persistent blocks); 0: the kernel that
// walks any L, a block a sequence. Returns a cudaError_t (0 on success).
// Requires N <= 16.
int vetk_selective_scan_short(int dtype, const void* x, const void* dt,
                              const void* A, const void* Bm, const void* Cm,
                              const void* Dv, const void* h0, void* y, void* hlast,
                              int B, int L, int D, int N, const long* strides,
                              int seqs, int blocks, void* stream) {
  if (bad_shape(B, L, D, N) || (h0 == nullptr) != (hlast == nullptr))
    return (int)cudaErrorInvalidValue;
  const Operands o = operands(x, dt, A, Bm, Cm, Dv, strides);
  auto st = static_cast<cudaStream_t>(stream);
  auto h0f = static_cast<const float*>(h0);
  auto hlf = static_cast<float*>(hlast);
  if (seqs > 0) {
    const bool wide = N > TILE_MAX_N;   // row 8: one channel a thread
    const int threads = wide ? seqs * D : seqs * ((D + 1) / 2);
    if (L > SHARED_MAX_L || threads > TILE_THREADS || (wide && (h0 || blocks < 1)))
      return (int)cudaErrorInvalidValue;
    const int grid = (int)((B + (long)seqs - 1) / seqs);
    return by_dtype(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      constexpr int SEG = 16 / sizeof(T);
      if ((reinterpret_cast<size_t>(x) & 15) || (reinterpret_cast<size_t>(dt) & 15) ||
          D % SEG || strides[0] % SEG || strides[1] % SEG || strides[2] % SEG ||
          strides[3] % SEG)
        return (int)cudaErrorInvalidValue;
      T* yt = static_cast<T*>(y);
      auto launch_n16 = [&](auto lmax) {
        auto k = scan_short_n16_kernel<T, decltype(lmax)::value>;
        const int smem = n16_smem(sizeof(T), L, D, seqs);
        const cudaError_t err = allow_smem(k, smem);
        if (err != cudaSuccess) return (int)err;
        k<<<blocks, threads, smem, st>>>(o, yt, B, L, D, N, seqs);
        return (int)cudaGetLastError();
      };
      if (wide && L <= 16) return launch_n16(std::integral_constant<int, 16>{});
      if (wide) return launch_n16(std::integral_constant<int, SHARED_MAX_L>{});
      auto launch = [&](auto lmax, auto nmax) {
        constexpr int LM = decltype(lmax)::value, NM = decltype(nmax)::value;
        const int smem = tile_smem(sizeof(T), L, D, NM, seqs);
        cudaError_t err;
        if (h0) {
          auto k = scan_short_tile_kernel<T, true, LM, NM>;
          if ((err = allow_smem(k, smem)) != cudaSuccess) return (int)err;
          k<<<grid, threads, smem, st>>>(o, h0f, yt, hlf, B, L, D, N, seqs);
        } else {
          auto k = scan_short_tile_kernel<T, false, LM, NM>;
          if ((err = allow_smem(k, smem)) != cudaSuccess) return (int)err;
          k<<<grid, threads, smem, st>>>(o, h0f, yt, hlf, B, L, D, N, seqs);
        }
        return (int)cudaGetLastError();
      };
      auto by_n = [&](auto lmax) {
        if (N <= 4) return launch(lmax, std::integral_constant<int, 4>{});
        return launch(lmax, std::integral_constant<int, TILE_MAX_N>{});
      };
      if (L <= 16) return by_n(std::integral_constant<int, 16>{});
      return by_n(std::integral_constant<int, SHARED_MAX_L>{});
    });
  }
  const int threads = threads_for(D);
  const dim3 grid(B, blocks_for(D, threads));
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (h0)
      scan_short_kernel<T, true><<<grid, threads, 0, st>>>(
          o, h0f, static_cast<T*>(y), hlf, L, D, N);
    else
      scan_short_kernel<T, false><<<grid, threads, 0, st>>>(
          o, h0f, static_cast<T*>(y), hlf, L, D, N);
    return (int)cudaGetLastError();
  });
}

// Bytes of shared memory of row 6's tile kernel at these sizes.
int vetk_selective_scan_bidir_smem(int dtype, int L, int D, int N, int seqs,
                                   int shared) {
  const int item = dtype == kFloat32 ? 4 : 2;
  return bidir_smem(item, L, D, N <= 4 ? 4 : TILE_MAX_N, seqs, shared != 0);
}

// Row 6, with the strides of each stream as in the short scan. seqs > 0:
// the tile kernel with that many sequences a block (L <= SHARED_MAX_L, N <=
// TILE_MAX_N, D even and seqs * D / 2 <= TILE_THREADS, x and dt of both
// streams 16-byte aligned with D and their strides multiples of 16 bytes);
// `shared` (tile kernel only): x, B and C of the backward stream are those
// of the forward one, pointers and strides, and are read once. 0: the kernel
// that walks any L, a block a sequence. Returns a cudaError_t (0 on
// success). Requires N <= 16.
int vetk_selective_scan_bidir(int dtype, const void* xf, const void* dtf,
                              const void* Af, const void* Bf, const void* Cf,
                              const void* Df, const void* xb, const void* dtb,
                              const void* Ab, const void* Bb, const void* Cb,
                              const void* Db, void* yf, void* yb, int B, int L,
                              int D, int N, const long* strides_f,
                              const long* strides_b, int seqs, int shared,
                              void* stream) {
  if (bad_shape(B, L, D, N)) return (int)cudaErrorInvalidValue;
  const Operands fo = operands(xf, dtf, Af, Bf, Cf, Df, strides_f);
  const Operands bo = operands(xb, dtb, Ab, Bb, Cb, Db, strides_b);
  auto st = static_cast<cudaStream_t>(stream);
  if (seqs > 0) {
    const int threads = seqs * (D / 2);
    if (L > SHARED_MAX_L || N > TILE_MAX_N || D % 2 || threads > TILE_THREADS)
      return (int)cudaErrorInvalidValue;
    if (shared && (xb != xf || Bb != Bf || Cb != Cf || strides_b[0] != strides_f[0] ||
                   strides_b[1] != strides_f[1] || strides_b[4] != strides_f[4] ||
                   strides_b[5] != strides_f[5] || strides_b[6] != strides_f[6] ||
                   strides_b[7] != strides_f[7]))
      return (int)cudaErrorInvalidValue;
    const int grid = (int)((B + (long)seqs - 1) / seqs);
    return by_dtype(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      constexpr int SEG = 16 / sizeof(T);
      for (const void* p : {xf, dtf, xb, dtb})
        if (reinterpret_cast<size_t>(p) & 15) return (int)cudaErrorInvalidValue;
      for (const long* s : {strides_f, strides_b})
        if (D % SEG || s[0] % SEG || s[1] % SEG || s[2] % SEG || s[3] % SEG)
          return (int)cudaErrorInvalidValue;
      T* yft = static_cast<T*>(yf);
      T* ybt = static_cast<T*>(yb);
      auto launch = [&](auto lmax, auto nmax) {
        constexpr int LM = decltype(lmax)::value, NM = decltype(nmax)::value;
        auto k = scan_bidir_tile_kernel<T, LM, NM>;
        const int smem = bidir_smem(sizeof(T), L, D, NM, seqs, shared != 0);
        const cudaError_t err = allow_smem(k, smem);
        if (err != cudaSuccess) return (int)err;
        k<<<grid, threads, smem, st>>>(fo, bo, yft, ybt, B, L, D, N, seqs,
                                       shared != 0);
        return (int)cudaGetLastError();
      };
      auto by_n = [&](auto lmax) {
        if (N <= 4) return launch(lmax, std::integral_constant<int, 4>{});
        return launch(lmax, std::integral_constant<int, TILE_MAX_N>{});
      };
      if (L <= 8) return by_n(std::integral_constant<int, 8>{});
      if (L <= 16) return by_n(std::integral_constant<int, 16>{});
      return by_n(std::integral_constant<int, SHARED_MAX_L>{});
    });
  }
  const int threads = threads_for(D);
  const dim3 grid(B, blocks_for(D, threads));
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    scan_bidir_kernel<T><<<grid, threads, 0, st>>>(
        fo, bo, static_cast<T*>(yf), static_cast<T*>(yb), L, D, N);
    return (int)cudaGetLastError();
  });
}

// Longest L that row 10 keeps in registers; longer ones need the workspace.
int vetk_selective_scan_shared_max_l() { return SHARED_MAX_L; }

// Bytes of shared memory of row 10's tile kernel at these sizes.
int vetk_selective_scan_bidir_shared_smem(int dtype, int L, int D, int N, int seqs) {
  const int item = dtype == kFloat32 ? 4 : 2;
  return bidir_smem(item, L, D, N <= 4 ? 4 : TILE_MAX_N, seqs, true, true);
}

// Row 10: y = the forward scan of (u, dtf, Af, B, C, Df) plus the backward
// scan of (u, dtb, Ab, B, C, Db), summed in fp32 and cast once. strides (10
// values, host memory): the batch and step strides, in elements, of u, dtf,
// dtb, B and C. seqs > 0: the tile kernel with that many sequences a block
// (L <= SHARED_MAX_L, N <= TILE_MAX_N, D even and seqs * D / 2 <=
// TILE_THREADS, u, dtf and dtb 16-byte aligned with D and their strides
// multiples of 16 bytes); 0: the register kernel (L <= SHARED_MAX_L) or the
// workspace kernel. ws: an fp32 (B, L, D) workspace, needed (and read) only
// for L > SHARED_MAX_L. Returns a cudaError_t (0 on success). Requires N <=
// 16.
int vetk_selective_scan_bidir_shared(int dtype, const void* u, const void* dtf,
                                     const void* dtb, const void* Af,
                                     const void* Ab, const void* Bm,
                                     const void* Cm, const void* Df,
                                     const void* Db, void* y, void* ws, int B,
                                     int L, int D, int N, const long* strides,
                                     int seqs, void* stream) {
  if (bad_shape(B, L, D, N) || (L > SHARED_MAX_L && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const long sf[8] = {strides[0], strides[1], strides[2], strides[3],
                      strides[6], strides[7], strides[8], strides[9]};
  const long sb[8] = {strides[0], strides[1], strides[4], strides[5],
                      strides[6], strides[7], strides[8], strides[9]};
  const Operands fo = operands(u, dtf, Af, Bm, Cm, Df, sf);
  const Operands bo = operands(u, dtb, Ab, Bm, Cm, Db, sb);
  if (seqs > 0) {
    const int threads = seqs * (D / 2);
    if (L > SHARED_MAX_L || N > TILE_MAX_N || D % 2 || threads > TILE_THREADS)
      return (int)cudaErrorInvalidValue;
    const int grid = (int)((B + (long)seqs - 1) / seqs);
    auto st = static_cast<cudaStream_t>(stream);
    return by_dtype(dtype, [&](auto tag) {
      using T = typename decltype(tag)::type;
      constexpr int SEG = 16 / sizeof(T);
      for (const void* p : {u, dtf, dtb})
        if (reinterpret_cast<size_t>(p) & 15) return (int)cudaErrorInvalidValue;
      if (D % SEG) return (int)cudaErrorInvalidValue;
      for (int i = 0; i < 6; ++i)
        if (strides[i] % SEG) return (int)cudaErrorInvalidValue;
      T* yt = static_cast<T*>(y);
      auto launch = [&](auto nmax) {
        constexpr int NM = decltype(nmax)::value;
        auto k = scan_bidir_sum_kernel<T, NM>;
        const int smem = bidir_smem(sizeof(T), L, D, NM, seqs, true, true);
        const cudaError_t err = allow_smem(k, smem);
        if (err != cudaSuccess) return (int)err;
        k<<<grid, threads, smem, st>>>(fo, bo, yt, B, L, D, N, seqs);
        return (int)cudaGetLastError();
      };
      if (N <= 4) return launch(std::integral_constant<int, 4>{});
      return launch(std::integral_constant<int, TILE_MAX_N>{});
    });
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(D);
  const dim3 grid(B, blocks_for(D, threads));
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    T* yt = static_cast<T*>(y);
    if (L > SHARED_MAX_L) {
      scan_bidir_shared_ws_kernel<T><<<grid, threads, 0, st>>>(
          fo, bo, static_cast<float*>(ws), yt, L, D, N);
      return (int)cudaGetLastError();
    }
    // the register kernel for the smallest (LMAX, NMAX) that holds (L, N)
    auto launch = [&](auto lmax, auto nmax) {
      scan_bidir_shared_kernel<T, decltype(lmax)::value, decltype(nmax)::value>
          <<<grid, threads, 0, st>>>(fo, bo, yt, L, D, N);
    };
    auto by_n = [&](auto lmax) {
      if (N <= 4)
        launch(lmax, std::integral_constant<int, 4>{});
      else if (N <= 8)
        launch(lmax, std::integral_constant<int, 8>{});
      else
        launch(lmax, std::integral_constant<int, MAX_N>{});
    };
    if (L <= 8)
      by_n(std::integral_constant<int, 8>{});
    else if (L <= 16)
      by_n(std::integral_constant<int, 16>{});
    else
      by_n(std::integral_constant<int, SHARED_MAX_L>{});
    return (int)cudaGetLastError();
  });
}

// Row 9. h0 may be null (zero state). states (B, K, D, N) and sumdt
// (B, K, D) are fp32 scratch, K = ceil(L / CHUNK). Returns a cudaError_t
// (0 on success). Requires N <= 16 and K <= 65535.
int vetk_selective_scan_long(int dtype, const void* x, const void* dt,
                             const void* A, const void* Bm, const void* Cm,
                             const void* Dv, const void* h0, void* y, void* hlast,
                             void* states, void* sumdt, int B, int L, int D, int N,
                             const long* strides, void* stream) {
  const int K = (L + CHUNK - 1) / CHUNK;
  if (bad_shape(B, L, D, N) || K > 65535)
    return (int)cudaErrorInvalidValue;
  const Operands o = operands(x, dt, A, Bm, Cm, Dv, strides);
  auto st = static_cast<cudaStream_t>(stream);
  auto sf = static_cast<float*>(states);
  auto sd = static_cast<float*>(sumdt);
  const int threads = threads_for(D);
  const dim3 grid(B, K, blocks_for(D, threads));
  const int pass_blocks = blocks_for((long)B * D * N, PASS_THREADS);
  return by_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    cudaError_t err;
    scan_chunk_kernel<T, false><<<grid, threads, 0, st>>>(o, sf, sd, nullptr, L,
                                                           D, N, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_state_pass_kernel<<<pass_blocks, PASS_THREADS, 0, st>>>(
        sf, sd, o.A, static_cast<const float*>(h0), static_cast<float*>(hlast), B,
        D, N, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_chunk_kernel<T, true><<<grid, threads, 0, st>>>(o, sf, sd,
                                                          static_cast<T*>(y), L, D,
                                                          N, K);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
