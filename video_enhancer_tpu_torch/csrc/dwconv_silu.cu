// SiLU of a depthwise conv1d along the sequence (SAME, zero padding, bias)
// for Hopper (sm_90a):
//
//   y[b, l, c] = silu(bias[c] + sum_j w[c, j] * x[b, l - lo + j, c]),
//   lo = (K - 1) / 2, zeros outside [0, L); fp32 sums, one cast to x's type.
//
// Replaces the TPU kernel video_enhancer_tpu/ops/conv.py
// depthwise_conv1d_silu -> _dwconv_silu_impl -> _dwconv_silu_kernel
// (pallas_call at conv.py:220). It feeds vsrm's spatial SSD (bissd_apply with
// conv_impl="pallas"): x (B*T = 7, L = H*W = 57600, C = 160), K = 5, in bf16.
//
// What bounds it on an H100: it reads x once and writes y once, 2 * 7 *
// 57600 * 160 * 2 bytes = 258 MB, 0.077 ms at 3.35 TB/s; its ~0.1 GFLOP are
// far below. Bytes bound it, so the design is about keeping enough of them
// in flight and moving them in wide, whole-sector accesses.
//
// Design. A block owns tiles of `rows` consecutive rows (runs * RUN) x a
// slab of `ct` channels of one sequence (one slab when C is at most 256
// units of VEC channels), plus the K - 1 halo rows, and walks its tiles
// persistently (one wave of blocks, each a contiguous range of tiles). A
// ring of three tiles in shared memory keeps the next two tiles' loads in
// flight under the current tile's FMAs:
// - loads: each staged row is copied by 16-byte cp.async from the 16-byte
//   boundary at or below its first byte, so a row of vsrm's 290-wide in_proj
//   output (580 bytes apart: its 320-byte span starts at 4l mod 16) takes at
//   most 336 bytes in 21 copies, and reads the same 32-byte sectors as the
//   row itself; rows outside [0, L) are zero-filled by the copy. (TMA does
//   not apply: its global strides must be multiples of 16 bytes, and 580 is
//   not.) A row's data then starts at its own offset (its address mod 16) in
//   its staged row;
// - taps: a thread owns VEC neighbouring channels (2 in bf16/fp16 when the
//   rows allow 4-byte reads, else 1) over RUN consecutive output rows. It
//   reads the RUN + K - 1 rows it needs from shared memory once, neighbouring
//   threads on neighbouring words, and sums the K taps at static register
//   indices (K is a template parameter: 4 and 5 exactly, up to 8 in one
//   instance with a runtime bound); nothing is shifted;
// - stores: y goes through an output tile in shared memory (two, so that one
//   is in flight while the next is written). When a tile's rows of y are one
//   contiguous, 16-byte aligned run (one slab, C * item a multiple of 16, as
//   vsrm's 320-byte rows are), the tile is laid out densely and one thread
//   hands it to the TMA engine as one bulk copy (cp.async.bulk), which the
//   threads do not wait for; otherwise the threads store it at the output
//   rows' own offsets mod 16 in 16-byte stores, a ragged chunk at a row's
//   ends element by element.
// The launch (VEC, slab, runs, grid) is chosen by ops/conv.py _dwconv_plan;
// vetk_dwconv_silu_smem mirrors its shared-memory sum. On an H100 at vsrm's
// shape in bf16 it read 0.113 ms of device time against 0.203 for this
// file's earlier kernel (a thread walking 32 rows of two channels with
// 4-byte loads and stores); its copies alone took 0.055 ms, copies and FMAs
// 0.099, and storing the output tile by the threads instead of the bulk
// copy 0.128 in all (PERF.md).
//
// Layouts: x (B, L, C) with a dense last dim and a row stride ld (elements);
// w (C, K) and bias (C) fp32; y (B, L, C) contiguous.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int MAX_K = 8;
constexpr int RUN = 16;            // output rows a thread computes
constexpr int STAGES = 3;          // input tiles in the ring
constexpr int OUTS = 2;            // output tiles (one in a bulk store's flight)
constexpr int MAX_THREADS = 320;
constexpr int SMEM_BLOCK = 232448; // shared memory a block may use (H100)

// Bytes of a staged row: the 16-byte chunks that cover `span` bytes which
// start anywhere in a chunk at an address that is a multiple of `item`.
__host__ __device__ inline int row_pitch(int span, int item) {
  return (span + 16 - item + 15) / 16 * 16;
}

// Bytes of shared memory a block: STAGES input tiles of rows + kt - 1
// staged rows and OUTS output tiles of `rows` rows, each row row_pitch
// bytes.
__host__ __device__ inline int smem_bytes(int item, int ct, int kt, int runs) {
  const int rows = runs * RUN;
  return (STAGES * (rows + kt - 1) + OUTS * rows) * row_pitch(ct * item, item);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// VEC elements of T as fp32, and back.
template <typename T, int VEC> struct Vec;
template <typename T> struct Vec<T, 1> {
  static __device__ __forceinline__ void ld(const unsigned char* p, float* v) {
    v[0] = to_f32(*reinterpret_cast<const T*>(p));
  }
  static __device__ __forceinline__ void st(unsigned char* p, const float* v) {
    *reinterpret_cast<T*>(p) = from_f32<T>(v[0]);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void ld(const unsigned char* p, float* v) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x, v[1] = f.y;
  }
  static __device__ __forceinline__ void st(unsigned char* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};
template <> struct Vec<__half, 2> {
  static __device__ __forceinline__ void ld(const unsigned char* p, float* v) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(p));
    v[0] = f.x, v[1] = f.y;
  }
  static __device__ __forceinline__ void st(unsigned char* p, const float* v) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v[0], v[1]);
  }
};

// A tile: sequence b, rows [lt * rows, ...), channel slab `slab`. A block
// walks a contiguous range of tiles (slab fastest, then rows, then
// sequences), so a cursor steps without a division and the halo rows a
// tile shares with the one before it come from L2.
struct Cursor {
  int b, lt, slab;
  __device__ __forceinline__ void next(int ltiles, int slabs) {
    if (++slab == slabs) {
      slab = 0;
      if (++lt == ltiles) lt = 0, ++b;
    }
  }
};

// (r, k) of a thread's i-th item in a loop over rows x chunks with a
// stride of blockDim.x items, stepped without a division.
struct Walk {
  int r, k;
  __device__ __forceinline__ Walk(int chunks) : r(threadIdx.x / chunks), k(threadIdx.x % chunks) {}
  __device__ __forceinline__ void next(int chunks, int dr, int dk) {
    r += dr, k += dk;
    if (k >= chunks) k -= chunks, ++r;
  }
};

// KT taps compiled (K == KT, or K <= KT with the taps past K skipped).
// Grid: blocks walking contiguous ranges of tiles; blockDim (ct / VEC) *
// runs.
template <typename T, int KT, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, KT == MAX_K ? 1 : 2)
dwconv_silu_tile_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ y, int B,
                        int L, int C, int K, long ld, int ct, int runs) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ITEM = sizeof(T);
  constexpr bool EXACT = KT != MAX_K;
  const int rows = runs * RUN, srows = rows + KT - 1;
  const int pitch = row_pitch(ct * ITEM, ITEM), chunks = pitch / 16;
  unsigned char* const outs = smem + (size_t)STAGES * srows * pitch;
  const int lo = (K - 1) / 2;
  const int units = ct / VEC;
  const int unit = threadIdx.x % units, run = threadIdx.x / units;
  const int slabs = (C + ct - 1) / ct, ltiles = (L + rows - 1) / rows;
  const int tiles = B * ltiles * slabs;
  const long ldb = ld * ITEM;
  const int dr = blockDim.x / chunks, dk = blockDim.x % chunks;
  // y's rows of a tile are one contiguous run of 16-byte chunks: the output
  // tile is laid out densely and leaves in one bulk copy (TMA engine)
  const bool bulk = slabs == 1 && C * ITEM % 16 == 0;
  const int opitch = bulk ? C * ITEM : pitch;

  // this block's tiles: [first, first + count)
  const int base = tiles / gridDim.x, extra = tiles % gridDim.x;
  const int count = base + ((int)blockIdx.x < extra);
  const int first = (int)blockIdx.x * base + min((int)blockIdx.x, extra);
  Cursor load{first / (ltiles * slabs), first / slabs % ltiles, first % slabs};
  Cursor cur = load;

  auto issue = [&](const Cursor& t, int stage) {
    unsigned char* st = smem + (size_t)stage * srows * pitch;
    const int l0 = t.lt * rows - lo, c0 = t.slab * ct;
    const int span = min(ct, C - c0) * ITEM;
    const uintptr_t xs = reinterpret_cast<uintptr_t>(x + (long)t.b * L * ld + c0);
    for (Walk it(chunks); it.r < srows; it.next(chunks, dr, dk)) {
      const int l = l0 + it.r;
      unsigned char* dst = st + it.r * pitch + 16 * it.k;
      if (l >= 0 && l < L) {
        const uintptr_t a = xs + l * ldb, a0 = a & ~uintptr_t(15);
        if (16 * it.k < (int)(a - a0) + span)
          cp_async16(dst, reinterpret_cast<const void*>(a0 + 16 * it.k), 16);
      } else {
        cp_async16(dst, x, 0);   // zero fill
      }
    }
  };

  auto compute = [&](const Cursor& t, int stage, unsigned char* out) {
    const int c0 = t.slab * ct, l0 = t.lt * rows;
    if ((unit + 1) * VEC > min(ct, C - c0)) return;   // past a ragged last slab
    const unsigned char* st = smem + (size_t)stage * srows * pitch;
    const int c = c0 + unit * VEC;
    float wr[KT][VEC], bv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      bv[v] = bias[c + v];
#pragma unroll
      for (int j = 0; j < KT; ++j)
        wr[j][v] = (EXACT || j < K) ? w[(size_t)(c + v) * K + j] : 0.0f;
    }
    // the RUN + KT - 1 staged rows this thread reads, each at its own offset
    const int r0 = run * RUN;
    // (a staged row's data starts at its slab address mod 16)
    const uint32_t xa = (uint32_t)(reinterpret_cast<uintptr_t>(
                            x + (long)t.b * L * ld + c0) + (long)(l0 - lo + r0) * ldb);
    const uint32_t xstep = (uint32_t)ldb;
    const unsigned char* src = st + r0 * pitch + unit * VEC * ITEM;
    float xr[RUN + KT - 1][VEC];
#pragma unroll
    for (int i = 0; i < RUN + KT - 1; ++i)
      if (EXACT || i < RUN + K - 1)
        Vec<T, VEC>::ld(src + i * pitch + ((xa + i * xstep) & 15), xr[i]);
    const uint32_t ya = (uint32_t)reinterpret_cast<uintptr_t>(
        y + ((long)t.b * L + l0 + r0) * C + c0);
    const uint32_t ystep = (uint32_t)(C * ITEM);
    unsigned char* dst = out + r0 * opitch + unit * VEC * ITEM;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      if (l0 + r0 + r >= L) break;
      float o[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float acc = bv[v];
#pragma unroll
        for (int j = 0; j < KT; ++j)
          if (EXACT || j < K) acc = fmaf(wr[j][v], xr[r + j][v], acc);
        o[v] = silu(acc);
      }
      Vec<T, VEC>::st(dst + r * opitch + ((ya + r * ystep) & 15), o);
    }
  };

  // the output tile's rows to y: one bulk copy; else by the threads, whole
  // 16-byte chunks as one store, a ragged chunk at a row's ends element by
  // element
  auto flush = [&](const Cursor& t, const unsigned char* out) {
    const int l0 = t.lt * rows, c0 = t.slab * ct;
    const int span = min(ct, C - c0) * ITEM, n = min(rows, L - l0);
    const uintptr_t ys = reinterpret_cast<uintptr_t>(y + ((long)t.b * L + l0) * C + c0);
    if (bulk) {
      if (threadIdx.x == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                         ys),
                     "r"(static_cast<uint32_t>(__cvta_generic_to_shared(out))),
                     "r"(n * span)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      return;
    }
    for (Walk it(chunks); it.r < n; it.next(chunks, dr, dk)) {
      const uintptr_t a = ys + (size_t)it.r * C * ITEM, a0 = a & ~uintptr_t(15);
      const int head = (int)(a - a0), end = head + span;
      const int b0 = 16 * it.k, b1 = b0 + 16;
      if (b0 >= end || b1 <= head) continue;
      const unsigned char* src = out + it.r * opitch;
      if (b0 >= head && b1 <= end) {
        *reinterpret_cast<uint4*>(a0 + b0) = *reinterpret_cast<const uint4*>(src + b0);
      } else {
        for (int p = max(b0, head); p < min(b1, end); p += ITEM)
          *reinterpret_cast<T*>(a0 + p) = *reinterpret_cast<const T*>(src + p);
      }
    }
  };

  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < count) {
      issue(load, p);
      load.next(ltiles, slabs);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = 0; i < count; ++i) {
    // tile i's copies are done when at most STAGES - 2 groups are pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    // the bulk copy of tile i - 2 has read its output tile
    if (bulk && threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(OUTS - 1) : "memory");
    __syncthreads();   // tile i staged; tile i - 1's stage and this output tile free
    if (i + STAGES - 1 < count) {
      issue(load, (i + STAGES - 1) % STAGES);
      load.next(ltiles, slabs);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    unsigned char* out = outs + (size_t)(i % OUTS) * rows * pitch;
    compute(cur, i % STAGES, out);
    // the threads' writes of the output tile, before the bulk copy reads it
    if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    flush(cur, out);
    cur.next(ltiles, slabs);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (bulk && threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T, int KT, int VEC>
int launch_tile(const void* x, const float* w, const float* bias, void* y, int B,
                int L, int C, int K, long ld, int ct, int runs, int grid,
                cudaStream_t st) {
  auto kernel = dwconv_silu_tile_kernel<T, KT, VEC>;
  const int smem = smem_bytes(sizeof(T), ct, KT, runs);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, (ct / VEC) * runs, smem, st>>>(static_cast<const T*>(x), w, bias,
                                                static_cast<T*>(y), B, L, C, K, ld,
                                                ct, runs);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int by_k(const void* x, const float* w, const float* bias, void* y, int B, int L,
         int C, int K, long ld, int ct, int runs, int grid, cudaStream_t st) {
  switch (K) {
    case 4:
      return launch_tile<T, 4, VEC>(x, w, bias, y, B, L, C, K, ld, ct, runs, grid, st);
    case 5:
      return launch_tile<T, 5, VEC>(x, w, bias, y, B, L, C, K, ld, ct, runs, grid, st);
    default:
      return launch_tile<T, MAX_K, VEC>(x, w, bias, y, B, L, C, K, ld, ct, runs, grid,
                                        st);
  }
}

inline int taps_compiled(int K) { return K == 4 || K == 5 ? K : MAX_K; }

}  // namespace

extern "C" {

// Most taps the kernel takes; the wrapper checks K against it.
int vetk_dwconv_silu_max_k() { return MAX_K; }

// Bytes of shared memory of a block at these sizes (ops/conv.py
// _dwconv_smem mirrors the sum).
int vetk_dwconv_silu_smem(int dtype, int ct, int K, int runs) {
  return smem_bytes(dtype == kFloat32 ? 4 : 2, ct, taps_compiled(K), runs);
}

// x (B, L, C) with row stride ld; w (C, K), bias (C) fp32; y (B, L, C)
// contiguous, on 16 bytes. The launch, from ops/conv.py _dwconv_plan: vec
// (1, or 2 for bf16/fp16 with C, ld and x's address even in elements / 4
// bytes) channels a thread, ct (a multiple of vec) channels a slab, runs *
// 16 rows a tile, grid blocks. Returns a cudaError_t (0 on success).
int vetk_dwconv_silu(int dtype, const void* x, const void* w, const void* bias,
                     void* y, int B, int L, int C, int K, long ld, int vec, int ct,
                     int runs, int grid, void* stream) {
  const int item = dtype == kFloat32 ? 4 : 2;
  if (B < 1 || L < 1 || C < 1 || K < 1 || K > MAX_K || grid < 1 || runs < 1 ||
      ct < 1 || ct > C || (vec != 1 && vec != 2) || (vec == 2 && item != 2) ||
      C % vec || ct % vec || ld % vec ||
      reinterpret_cast<uintptr_t>(x) % (vec * item) ||
      reinterpret_cast<uintptr_t>(y) % 16 || (ct / vec) * runs > MAX_THREADS ||
      (long)B * ((L + runs * RUN - 1) / (runs * RUN)) * ((C + ct - 1) / ct) > INT32_MAX ||
      smem_bytes(item, ct, taps_compiled(K), runs) > SMEM_BLOCK)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(bias);
  switch (dtype) {
    case kFloat32:
      return by_k<float, 1>(x, wf, bf, y, B, L, C, K, ld, ct, runs, grid, st);
    case kBFloat16:
      return vec == 2
                 ? by_k<__nv_bfloat16, 2>(x, wf, bf, y, B, L, C, K, ld, ct, runs, grid, st)
                 : by_k<__nv_bfloat16, 1>(x, wf, bf, y, B, L, C, K, ld, ct, runs, grid, st);
    case kFloat16:
      return vec == 2 ? by_k<__half, 2>(x, wf, bf, y, B, L, C, K, ld, ct, runs, grid, st)
                      : by_k<__half, 1>(x, wf, bf, y, B, L, C, K, ld, ct, runs, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
