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
// far below. Bytes bound it.
//
// Design. The TPU kernel gathered each chunk's halo rows in XLA beforehand,
// because Mosaic's BlockSpecs cannot overlap. Here a thread reads its own
// halo rows straight from device memory. One thread owns VEC neighbouring
// channels over a run of RUN steps of one sequence: it loads the K - 1 rows
// before the run once, then slides along L with the window in registers,
// one row load and one row store a step. Neighbouring threads own
// neighbouring channel groups, so a warp reads and writes one contiguous
// span of each row. The window is MAX_K wide and right-aligned (taps beyond
// K have zero weight), so every register index is static.
//
// Layouts: x (B, L, C) with a dense last dim and a row stride ld (elements;
// vsrm hands a column slice of its 290-wide in_proj output, rows 580 bytes
// apart in bf16, so 4- but not 16-byte aligned); w (C, K) and bias (C) fp32;
// y (B, L, C) contiguous. VEC channels move as one load when the pointer,
// ld and C allow it (the wrapper picks VEC).

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int MAX_K = 8;
constexpr int RUN = 32;        // steps a thread walks
constexpr int THREADS = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
struct Row {
  float v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
dwconv_silu_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y, int B,
                   int L, int C, int K, long ld, int runs) {
  using P = Pack<T, VEC>;
  const int groups = C / VEC;
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long)B * runs * groups) return;
  const int g = (int)(i % groups);
  const long r = i / groups;
  const int run = (int)(r % runs);
  const long b = r / runs;
  const int c0 = g * VEC;
  const int lo = (K - 1) / 2;
  const int hi = K - 1 - lo;

  // taps right-aligned in MAX_K: tap j of K sits at MAX_K - K + j
  float wr[MAX_K][VEC], bv[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    bv[v] = bias[c0 + v];
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
      const int tap = j - (MAX_K - K);
      wr[j][v] = tap >= 0 ? w[(size_t)(c0 + v) * K + tap] : 0.0f;
    }
  }

  const T* __restrict__ xs = x + b * L * ld + c0;
  T* __restrict__ ys = y + (b * L) * C + c0;
  // row l of the owned channels in fp32, zeros outside the sequence
  auto load = [&](int l) {
    Row<VEC> row;
    if (l >= 0 && l < L) {
      const P p = *reinterpret_cast<const P*>(xs + (long)l * ld);
#pragma unroll
      for (int v = 0; v < VEC; ++v) row.v[v] = to_f32(p.v[v]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) row.v[v] = 0.0f;
    }
    return row;
  };

  const int l0 = run * RUN;
  const int l1 = min(l0 + RUN, L);
  // win[MAX_K - 1 - m] holds x[l + hi - m] at step l; fill m = 1 .. K - 1
  Row<VEC> win[MAX_K];
#pragma unroll
  for (int m = 1; m < MAX_K; ++m) win[MAX_K - 1 - m] = load(m < K ? l0 + hi - m : -1);
#pragma unroll 4
  for (int l = l0; l < l1; ++l) {
    win[MAX_K - 1] = load(l + hi);
    P out;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float acc = bv[v];
#pragma unroll
      for (int j = 0; j < MAX_K; ++j) acc = fmaf(wr[j][v], win[j].v[v], acc);
      out.v[v] = from_f32<T>(silu(acc));
    }
    *reinterpret_cast<P*>(ys + (long)l * C) = out;
#pragma unroll
    for (int j = 0; j < MAX_K - 1; ++j) win[j] = win[j + 1];
  }
}

template <typename T>
int launch(int vec, const void* x, const float* w, const float* bias, void* y,
           int B, int L, int C, int K, long ld, cudaStream_t st) {
  const int runs = (L + RUN - 1) / RUN;
  const long threads = (long)B * runs * (C / vec);
  const long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto xt = static_cast<const T*>(x);
  auto yt = static_cast<T*>(y);
  switch (vec) {
    case 1:
      dwconv_silu_kernel<T, 1><<<blocks, THREADS, 0, st>>>(xt, w, bias, yt, B, L, C, K, ld, runs);
      break;
    case 2:
      dwconv_silu_kernel<T, 2><<<blocks, THREADS, 0, st>>>(xt, w, bias, yt, B, L, C, K, ld, runs);
      break;
    case 4:
      dwconv_silu_kernel<T, 4><<<blocks, THREADS, 0, st>>>(xt, w, bias, yt, B, L, C, K, ld, runs);
      break;
    case 8:
      dwconv_silu_kernel<T, 8><<<blocks, THREADS, 0, st>>>(xt, w, bias, yt, B, L, C, K, ld, runs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Most taps the kernel takes; the wrapper checks K against it.
int vetk_dwconv_silu_max_k() { return MAX_K; }

// x (B, L, C) with row stride ld; w (C, K), bias (C) fp32; y (B, L, C)
// contiguous. vec (1, 2, 4 or 8; 8 not for fp32) channels a load: C, ld and
// the pointers must be multiples of it. Returns a cudaError_t (0 on
// success).
int vetk_dwconv_silu(int dtype, const void* x, const void* w, const void* bias,
                     void* y, int B, int L, int C, int K, long ld, int vec,
                     void* stream) {
  if (B < 1 || L < 1 || C < 1 || K < 1 || K > MAX_K || vec < 1 || C % vec ||
      ld % vec || (dtype == kFloat32 && vec > 4))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto wf = static_cast<const float*>(w);
  auto bf = static_cast<const float*>(bias);
  switch (dtype) {
    case kFloat32:
      return launch<float>(vec, x, wf, bf, y, B, L, C, K, ld, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(vec, x, wf, bf, y, B, L, C, K, ld, st);
    case kFloat16:
      return launch<__half>(vec, x, wf, bf, y, B, L, C, K, ld, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
