// The whole interior of the bidirectional shared-stream SSM (bissm) for
// short sequences, in one kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel video_enhancer_tpu/ops/scan.py
// fused_bidir_ssm -> _fused_bissm_impl -> _fused_bissm_kernel (pallas_call at
// scan.py:941): depthwise conv (SAME, bias), SiLU, x_proj (D -> dt_rank+2N),
// dt_proj with bias, softplus with a dt bias per direction, a forward and a
// reverse selective scan over the shared u/B/C streams with their own A and
// D skip, their sum, times SiLU(gate). All in fp32; none of the
// intermediates reaches device memory.
//
// What bounds it on an H100: at the VSRM temporal shape (B=57600 sequences,
// L=7, D=128, N=4, dt_rank=4, bf16) it reads u_pre and gate and writes y,
// 0.31 GB, 92 us at 3.35 TB/s; its 6.5 GFLOP of fp32 work (the JAX
// package's count) take 97 us at the CUDA-core rate, so operations bound it.
// The special-function units set a floor the bound does not count: 16
// exp/log/reciprocal per (sequence, step, channel) at vsrm's shape (0.83 G,
// ~0.22 ms at 16 an SM a clock), 24 at fast_mamba_vsr's (2.1 G, ~0.57 ms).
//
// Design: one warp per sequence, up to 16 warps (sequences) per block (4 in
// the generic instance), and
// each warp walks a strided list of sequences. A warp has one u tile and
// one gate tile (L rows of D) in shared memory, and refills each with its
// next sequence by cp.async as soon as it is spent: u after phase A (the
// copy lands during B and C), gate after phase C (it lands during the next
// A). Lane l owns channels l, l + 32, ...:
//   A. per step: depthwise conv + SiLU into an fp32 stash x[L][D]; x_proj
//      as per-lane partial sums over the lane's channels (wx^T in shared
//      memory, four outputs a 16-byte read), reduced across the warp by a
//      butterfly that halves the values a lane holds at each exchange; the
//      R = dt_rank + 2N outputs into proj[L][dt | B | C];
//   B. per channel: dt_proj and the softplus of each direction recomputed
//      from proj, the forward scan (its output held in registers, L
//      unrolled to a bound), then the reverse scan, the D skips and
//      SiLU(gate), written over the gate in the input type;
//   C. the tile out to y in 16-byte stores.
// No __syncthreads after the weights are staged: a warp synchronises only
// with itself. exp, log and the reciprocal are single ex2/lg2/rcp
// instructions, A prescaled by log2 e. N, K, dt_rank, the channels a lane
// and the bound on L are template parameters of the instances for vsrm's
// (4, 5, 4) and fast_mamba_vsr's (8, 5, 3) shapes; one more instance at the
// bounds (N <= 16, K <= 8, dt_rank <= 16, D <= 256, L <= 32) takes the rest
// with runtime counts. The weights are read in their own dtype and cast to
// fp32 on load. No tensor cores: x_proj is 12-19 outputs wide and the
// reference computes it in fp32.
//
// Layouts: u_pre, gate (B, L, D) with row strides ldu, ldg (the two halves
// of in_proj's output); y (B, L, D) contiguous; cw (D, K); cb, bdt, dtbf,
// dtbb, Df, Db (D,); wx (R, D); wdt (D, dt_rank); Af, Ab (D, N).

#include <cstdint>

#include "common.cuh"

namespace {

using namespace vetk;

constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory of a block
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr float LN2_F = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// Weight order of the C interface; codes hold each one's dtype, 2 bits each.
enum W { CW, CB, WX, WDT, BDT, DTBF, DTBB, AF, AB, DF, DB, NW };
struct Weights {
  const void* p[NW];
  int codes;
};

struct Params {
  const void* u;
  const void* gate;
  void* y;
  Weights w;
  int B, L, D, N, K, rank;
  long ldu, ldg;
  int warps, vec;
};

__device__ __forceinline__ float load_w(const Weights& w, int which, long i) {
  switch ((w.codes >> (2 * which)) & 3) {
    case kBFloat16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(w.p[which])[i]);
    case kFloat16:
      return __half2float(static_cast<const __half*>(w.p[which])[i]);
    default:
      return static_cast<const float*>(w.p[which])[i];
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float silu_f(float x) {
  return __fdividef(x, 1.0f + ex2(-x * LOG2E_F));
}
// log(1 + e^x) in the overflow-free form jax.nn.softplus uses.
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + LN2_F * lg2(1.0f + ex2(-fabsf(x) * LOG2E_F));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int up4(int x) { return (x + 3) / 4 * 4; }

// `n` floats (a multiple of 4) from a 16-byte aligned row of shared memory.
template <int n>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[n]) {
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x, dst[4 * q + 1] = v.y, dst[4 * q + 2] = v.z, dst[4 * q + 3] = v.w;
  }
}
__host__ __device__ constexpr long up16(long x) { return (x + 15) / 16 * 16; }

// An instance: N, K, dt_rank, channels a lane and the bound on L. EXACT
// instances run at exactly N, K and dt_rank; the last runs at the bounds.
template <int N_, int K_, int RANK_, int CPL_, int LMAX_, bool EXACT_>
struct Inst {
  static constexpr int N = N_, K = K_, RANK = RANK_, CPL = CPL_, LMAX = LMAX_;
  static constexpr bool EXACT = EXACT_;
  static constexpr int NP = up4(N), RK4 = up4(RANK);
  static constexpr int PS = RK4 + 2 * NP;          // proj row: dt | B | C
  static constexpr int RMAX = RANK + 2 * N;
  static constexpr int RP = RMAX <= 16 ? 16 : 32; // partials reduced at once
  // x_proj's weights staged as wx^T [D][RS], RS a multiple of 4 with RS / 4
  // odd (float4 reads of neighbouring lanes fall in distinct banks)
  static constexpr int RS = up4(RMAX) / 4 % 2 ? up4(RMAX) : up4(RMAX) + 4;
  // staged weight rows, D floats each: wx^T, A_f, A_b (times log2 e), wdt,
  // bdt, dtbf, dtbb, D_f, D_b; the generic instance also stages the conv's
  // taps (its specialised peers hold them in registers)
  static constexpr int WROWS = RS + 2 * N + RANK + 5 + (EXACT ? 0 : K);
  // threads a block: up to 16 warps, 4 for the generic instance, whose
  // registers are many
  static constexpr int MAX_THREADS = EXACT ? 512 : 128;
};
using InstVsrm = Inst<4, 5, 4, 4, 8, true>;
using InstFmv = Inst<8, 5, 3, 3, 16, true>;
using InstGeneric = Inst<16, 8, 16, 8, 32, false>;

// Shared memory: the staged weights, then per warp the u tile, the gate
// tile (y once it is spent), the x stash and proj. The wrapper's plan
// (ops/scan.py) mirrors it.
template <class I>
__host__ __device__ long smem_bytes(int L, int D, int item, int warps) {
  const long tile = up16((long)L * D * item);
  return up16((long)I::WROWS * D * 4) +
         warps * (2 * tile + up16((long)L * D * 4) + up16((long)L * I::PS * 4));
}

// After the reduction, lane l holds the warp's sum of v[idx]; duplicates
// of idx sit on lanes that differ in the low bits, of which `owner` is one.
template <int RP>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[RP], int lane, int& idx,
                                                     bool& owner) {
  constexpr int STEPS = RP == 16 ? 4 : 5;
  idx = 0;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int half = (RP / 2) >> s, mask = 16 >> s;
    const bool up = lane & mask;
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) {
      if (i < half) {
        const float send = up ? v[i] : v[i + half];
        const float keep = up ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, mask);
      }
    }
    if (up) idx += half;
  }
  float total = v[0];
#pragma unroll
  for (int s = STEPS; s < 5; ++s) total += __shfl_xor_sync(FULL, total, 16 >> s);
  owner = (lane & ((1 << (5 - STEPS)) - 1)) == 0;
  return total;
}

// Copies the (L, D) tile of sequence `seq` (rows `ld` apart) to `dst` as
// one cp.async group of the lane (empty past the last sequence); plain
// copies where 16-byte chunks do not fit.
template <typename T>
__device__ __forceinline__ void issue_tile(const Params& p, const void* src, long ld,
                                           int seq, T* dst, int lane) {
  if (seq < p.B) {
    const T* sb = static_cast<const T*>(src) + (size_t)seq * p.L * ld;
    if (p.vec) {
      constexpr int E = 16 / sizeof(T);          // elements a 16-byte chunk
      const int ch = p.D / E;
      for (int k = lane; k < p.L * ch; k += 32) {
        const int t = k / ch, q = (k - t * ch) * E;
        cp_async16(dst + t * p.D + q, sb + t * ld + q);
      }
    } else {
      for (int k = lane; k < p.L * p.D; k += 32) {
        const int t = k / p.D, c = k - t * p.D;
        dst[k] = sb[t * ld + c];
      }
    }
  }
  cp_async_commit();
}

template <typename T, class I>
__global__ void __launch_bounds__(I::MAX_THREADS)
fused_bissm_kernel(const Params p) {
  constexpr int N = I::N, K = I::K, RANK = I::RANK, CPL = I::CPL, LMAX = I::LMAX;
  constexpr int NP = I::NP, RK4 = I::RK4, PS = I::PS, RP = I::RP;
  const int Nn = I::EXACT ? N : p.N, Kk = I::EXACT ? K : p.K;
  const int Rk = I::EXACT ? RANK : p.rank;
  const int R = Rk + 2 * Nn;
  const int L = p.L, D = p.D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* wxs = reinterpret_cast<float*>(smem);     // wx^T [D][RS]
  float* Af2 = wxs + I::RS * D;                    // [N][D], times log2 e
  float* Ab2 = Af2 + N * D;
  float* wdts = Ab2 + N * D;                       // [RANK][D]
  float* vecs = wdts + RANK * D;                   // bdt, dtbf, dtbb, Df, Db
  float* cws = vecs + 5 * D;                       // [K][D] (generic)
  for (int i = threadIdx.x; i < D * I::RS; i += blockDim.x) {
    const int d = i / I::RS, r = i - d * I::RS;
    wxs[i] = r < R ? load_w(p.w, WX, (long)r * D + d) : 0.0f;
  }
  for (int i = threadIdx.x; i < D * Nn; i += blockDim.x) {
    const int d = i / Nn, n = i - d * Nn;
    Af2[n * D + d] = load_w(p.w, AF, i) * LOG2E_F;
    Ab2[n * D + d] = load_w(p.w, AB, i) * LOG2E_F;
  }
  for (int i = threadIdx.x; i < D * Rk; i += blockDim.x) {
    const int d = i / Rk, r = i - d * Rk;
    wdts[r * D + d] = load_w(p.w, WDT, i);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    vecs[d] = load_w(p.w, BDT, d);
    vecs[D + d] = load_w(p.w, DTBF, d);
    vecs[2 * D + d] = load_w(p.w, DTBB, d);
    vecs[3 * D + d] = load_w(p.w, DF, d);
    vecs[4 * D + d] = load_w(p.w, DB, d);
  }
  // the conv's taps and bias: in registers in the specialised instances,
  // staged in the generic one
  float cwr[I::EXACT ? CPL : 1][K], cbr[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    cbr[j] = c < D ? load_w(p.w, CB, c) : 0.0f;
    if constexpr (I::EXACT) {
#pragma unroll
      for (int k = 0; k < K; ++k) cwr[j][k] = c < D ? load_w(p.w, CW, (long)c * K + k) : 0.0f;
    }
  }
  if constexpr (!I::EXACT) {
    for (int i = threadIdx.x; i < D * Kk; i += blockDim.x) {
      const int d = i / Kk, k = i - d * Kk;
      cws[k * D + d] = load_w(p.w, CW, i);
    }
  }
  __syncthreads();   // the staged weights; from here a warp works alone

  const int tile = L * D;
  const long tile_bytes = up16((long)tile * sizeof(T));
  const long warp_bytes = 2 * tile_bytes + up16((long)tile * 4) + up16((long)L * PS * 4);
  unsigned char* wb = smem + up16((long)I::WROWS * D * 4) + warp * warp_bytes;
  T* ut = reinterpret_cast<T*>(wb);                            // u tile
  T* gt = reinterpret_cast<T*>(wb + tile_bytes);               // gate, then y
  float* xs = reinterpret_cast<float*>(wb + 2 * tile_bytes);   // [L][D]
  float* ps = xs + up16((long)tile * 4) / 4;                   // [L][PS]
  const int lo = (Kk - 1) / 2;   // XLA SAME padding: lo = (K-1)//2
  const int tw = gridDim.x * p.warps;
  const int first = blockIdx.x * p.warps + warp;

  // Each tile is refilled with the warp's next sequence as soon as it is
  // spent: u after phase A (it lands during B and C), gate after phase C
  // (it lands during the next A). A lane's cp.async groups complete in
  // commit order: u, gate, u, gate, ...
  issue_tile<T>(p, p.u, p.ldu, first, ut, lane);
  issue_tile<T>(p, p.gate, p.ldg, first, gt, lane);
  for (int seq = first; seq < p.B; seq += tw) {
    cp_async_wait<1>();   // u of this sequence
    __syncwarp();

    // A. conv + SiLU, x_proj. The specialised instances slide a window of
    // the K rows a step needs through registers (one new row a step).
    float win[I::EXACT ? CPL : 1][K];
    if constexpr (I::EXACT) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
#pragma unroll
        for (int k = 0; k < K; ++k)
          win[j][k] = c < D && k - lo < L && k >= lo ? to_f32(ut[(k - lo) * D + c]) : 0.0f;
      }
    }
    for (int t = 0; t < L; ++t) {
      float xv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        float conv = cbr[j];
        if constexpr (I::EXACT) {
#pragma unroll
          for (int k = 0; k < K; ++k) conv += win[j][k] * cwr[j][k];
        } else if (c < D) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int tt = t + k - lo;
            if (k < Kk && tt >= 0 && tt < L) conv += to_f32(ut[tt * D + c]) * cws[k * D + c];
          }
        }
        xv[j] = c < D ? silu_f(conv) : 0.0f;
        if (c < D) xs[t * D + c] = xv[j];
      }
      if constexpr (I::EXACT) {
        const int tn = t + 1 + K - 1 - lo;   // the row step t + 1 adds
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
#pragma unroll
          for (int k = 0; k < K - 1; ++k) win[j][k] = win[j][k + 1];
          win[j][K - 1] = c < D && tn < L ? to_f32(ut[tn * D + c]) : 0.0f;
        }
      }
      for (int r0 = 0; r0 < R; r0 += RP) {
        float part[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) part[r] = 0.0f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < D) {
            // wx^T's row of channel c, four outputs a 16-byte read; zero past R
            const float4* w4 = reinterpret_cast<const float4*>(wxs + c * I::RS + r0);
#pragma unroll
            for (int q = 0; q < RP / 4; ++q) {
              if (r0 + 4 * q < I::RS) {
                const float4 w = w4[q];
                part[4 * q] += xv[j] * w.x;
                part[4 * q + 1] += xv[j] * w.y;
                part[4 * q + 2] += xv[j] * w.z;
                part[4 * q + 3] += xv[j] * w.w;
              }
            }
          }
        }
        int idx;
        bool owner;
        const float total = warp_reduce_scatter<RP>(part, lane, idx, owner);
        const int r = r0 + idx;
        if (owner && r < R) {
          const int slot = r < Rk ? r : (r < Rk + Nn ? RK4 + r - Rk : RK4 + NP + r - Rk - Nn);
          ps[t * PS + slot] = total;
        }
      }
    }
    __syncwarp();
    issue_tile<T>(p, p.u, p.ldu, seq + tw, ut, lane);
    cp_async_wait<1>();   // gate of this sequence
    __syncwarp();

    // B. per channel: forward scan, reverse scan, skips, gate. A step's
    // dt_raw, B and C are read as 16-byte broadcasts; x stays in registers
    // from the forward pass to the reverse one.
#pragma unroll 1
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < D) {
        float af[N], ab[N], wd[RANK];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          af[n] = (I::EXACT || n < Nn) ? Af2[n * D + c] : 0.0f;
          ab[n] = (I::EXACT || n < Nn) ? Ab2[n * D + c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < RANK; ++r) wd[r] = (I::EXACT || r < Rk) ? wdts[r * D + c] : 0.0f;
        const float bdt = vecs[c], fb = vecs[D + c], bb = vecs[2 * D + c];
        const float df = vecs[3 * D + c], db = vecs[4 * D + c];
        float h[N], yf[LMAX], xr[LMAX];
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = 0.0f;
#pragma unroll
        for (int t = 0; t < LMAX; ++t) {
          if (t < L) {
            float pr[PS];
            load_row<PS>(ps + t * PS, pr);
            float dtp = bdt;
#pragma unroll
            for (int r = 0; r < RANK; ++r)
              if (I::EXACT || r < Rk) dtp += pr[r] * wd[r];
            const float dt = softplus_f(dtp + fb);
            xr[t] = xs[t * D + c];
            const float drive = dt * xr[t];
            float yv = xr[t] * df;
#pragma unroll
            for (int n = 0; n < N; ++n) {
              if (I::EXACT || n < Nn) {
                h[n] = ex2(dt * af[n]) * h[n] + drive * pr[RK4 + n];
                yv += h[n] * pr[RK4 + NP + n];
              }
            }
            yf[t] = yv;
          }
        }
#pragma unroll
        for (int n = 0; n < N; ++n) h[n] = 0.0f;
#pragma unroll
        for (int t = LMAX - 1; t >= 0; --t) {
          if (t < L) {
            float pr[PS];
            load_row<PS>(ps + t * PS, pr);
            float dtp = bdt;
#pragma unroll
            for (int r = 0; r < RANK; ++r)
              if (I::EXACT || r < Rk) dtp += pr[r] * wd[r];
            const float dt = softplus_f(dtp + bb);
            const float drive = dt * xr[t];
            float yv = yf[t] + xr[t] * db;
#pragma unroll
            for (int n = 0; n < N; ++n) {
              if (I::EXACT || n < Nn) {
                h[n] = ex2(dt * ab[n]) * h[n] + drive * pr[RK4 + n];
                yv += h[n] * pr[RK4 + NP + n];
              }
            }
            gt[t * D + c] = from_f32<T>(yv * silu_f(to_f32(gt[t * D + c])));
          }
        }
      }
    }
    __syncwarp();

    // C. the tile (now y) out
    T* yb = static_cast<T*>(p.y) + (size_t)seq * tile;
    if (p.vec) {
      const int n16 = tile * (int)sizeof(T) / 16;
      for (int k = lane; k < n16; k += 32)
        reinterpret_cast<uint4*>(yb)[k] = reinterpret_cast<const uint4*>(gt)[k];
    } else {
      for (int k = lane; k < tile; k += 32) yb[k] = gt[k];
    }
    __syncwarp();
    issue_tile<T>(p, p.gate, p.ldg, seq + tw, gt, lane);
  }
  cp_async_wait<0>();
}

// Instance indices of the C interface (ops/scan.py _FUSED_INSTANCES).
enum { kVsrm = 0, kFmv = 1, kGeneric = 2 };

template <typename T, class I>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  if (I::EXACT && (p.N != I::N || p.K != I::K || p.rank != I::RANK)) return cudaErrorInvalidValue;
  if (p.N > I::N || p.K > I::K || p.rank > I::RANK || p.D > 32 * I::CPL || p.L > I::LMAX ||
      32 * p.warps > I::MAX_THREADS)
    return cudaErrorInvalidValue;
  const long smem = smem_bytes<I>(p.L, p.D, sizeof(T), p.warps);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fused_bissm_kernel<T, I>, smem);
  if (err != cudaSuccess) return err;
  fused_bissm_kernel<T, I><<<blocks, 32 * p.warps, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch(const Params& p, int instance, int blocks, cudaStream_t stream) {
  switch (instance) {
    case kVsrm:
      return launch<T, InstVsrm>(p, blocks, stream);
    case kFmv:
      return launch<T, InstFmv>(p, blocks, stream);
    case kGeneric:
      return launch<T, InstGeneric>(p, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int regs_of(int instance) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (instance == kVsrm) err = cudaFuncGetAttributes(&a, fused_bissm_kernel<T, InstVsrm>);
  if (instance == kFmv) err = cudaFuncGetAttributes(&a, fused_bissm_kernel<T, InstFmv>);
  if (instance == kGeneric)
    err = cudaFuncGetAttributes(&a, fused_bissm_kernel<T, InstGeneric>);
  return err == cudaSuccess ? a.numRegs : -(int)err;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success). `wcodes` holds the dtype of each
// weight (2 bits each, in argument order cw .. Db); `instance`, `warps`
// (sequences in flight a block) and `blocks` come from
// the wrapper's plan; the kernel refuses an instance that does not take N,
// K, dt_rank, D and L, and more shared memory than a block has.
int vetk_fused_bissm(int dtype, const void* u, const void* gate, const void* cw,
                     const void* cb, const void* wx, const void* wdt,
                     const void* bdt, const void* dtbf, const void* dtbb,
                     const void* Af, const void* Ab, const void* Df,
                     const void* Db, void* y, int B, int L, int D, int N, int K,
                     int dt_rank, long ldu, long ldg, int wcodes, int instance,
                     int warps, int blocks, void* stream) {
  if (D < 1 || N < 1 || K < 1 || dt_rank < 1 || L < 1 || B < 1 || blocks < 1 ||
      warps < 1)
    return (int)cudaErrorInvalidValue;
  const int item = dtype == kFloat32 ? 4 : 2;
  // 16-byte copies: aligned bases, and rows and strides of whole chunks
  const bool vec = (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(gate) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0) && (D * item) % 16 == 0 &&
                   (ldu * item) % 16 == 0 && (ldg * item) % 16 == 0;
  Params p{u, gate, y,
           Weights{{cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db}, wcodes},
           B, L, D, N, K, dt_rank, ldu, ldg, warps, vec ? 1 : 0};
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(p, instance, blocks, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(p, instance, blocks, st);
    case kFloat16:
      return launch<__half>(p, instance, blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of an instance's block, for the wrapper's plan to
// be held against.
int vetk_fused_bissm_smem(int dtype, int instance, int L, int D, int warps) {
  const int item = dtype == kFloat32 ? 4 : 2;
  switch (instance) {
    case kVsrm:
      return (int)smem_bytes<InstVsrm>(L, D, item, warps);
    case kFmv:
      return (int)smem_bytes<InstFmv>(L, D, item, warps);
    case kGeneric:
      return (int)smem_bytes<InstGeneric>(L, D, item, warps);
    default:
      return -1;
  }
}

// Registers a thread of an instance's kernel (the plan's occupancy), or
// minus a cudaError_t.
int vetk_fused_bissm_regs(int dtype, int instance) {
  switch (dtype) {
    case kFloat32:
      return regs_of<float>(instance);
    case kBFloat16:
      return regs_of<__nv_bfloat16>(instance);
    case kFloat16:
      return regs_of<__half>(instance);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
