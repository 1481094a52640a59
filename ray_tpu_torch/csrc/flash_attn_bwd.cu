// Causal flash-attention backward for Hopper (sm_90a), plain C interface:
// two kernels, no atomics, so the result is deterministic.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` in
// ray_tpu/ops/attention.py (both launched by `_flash_bwd`). Same function:
// with the forward's lse (natural log, fp32) and delta = rowsum(o * do)
// (fp32, computed by the caller, as on the TPU), for every (batch*head)
// slice and every causal pair (query i, key j <= i):
//   p  = exp(q_i . k_j / sqrt(d) - lse_i)
//   ds = p * (do_i . v_j - delta_i)
// and
//   dq kernel     dq_i = (1/sqrt(d)) sum_j ds * k_j              (3 products)
//   dk/dv kernel  dv_j = sum_i p * do_i,                         (4 products)
//                 dk_j = (1/sqrt(d)) sum_i ds * q_i
// Every sum is in fp32; the gradients are written in q's type (float32 or
// bfloat16).
//
// Layouts: q, k, v, do, dq, dk, dv are contiguous (bh, t, d); lse and delta
// are (bh, t) fp32 (the TPU's (bh, 1, t) only served Mosaic's tiling rule).
//
// Translation from the TPU kernels:
//   - The TPU grid walked (bh, tiles) in order on one core. Here every
//     (tile, bh) pair is an independent thread block, and the walk over the
//     other operand's tiles is a loop inside the block over tiles staged in
//     shared memory. dq and dk/dv are two kernels, each owning its output
//     rows, so no block adds into another's rows: no atomics, no second
//     reduction pass.
//   - No divisibility rule: t is any length >= 1. Rows past t are computed
//     on zeros and never stored; p is forced to 0 for queries past t, so
//     their lse and delta never matter; keys past t are zero-filled.
//   - The dk/dv kernel's first query row is its tile's first key row,
//     computed from rows, not from a floored tile ratio.
//
// What bounds them on an H100 at the training shape (16 x 12 heads, t =
// 1024, d = 64, bf16): the dq kernel does 3 products of 2*d FLOP per causal
// pair, the dk/dv kernel 4, against about 7*bh*t*d elements of traffic; at
// t = 1024 that is hundreds of FLOP per byte, so arithmetic sets the least
// time, not HBM.
//
// Designs:
//
// dk/dv, bfloat16 -> flash_bwd_dkv_sm90_kernel, on the tensor cores: the
//   transposed form of FlashAttention-2/3's backward. One block per
//   (128-key tile, bh), two warpgroups of 64 key rows; k and v sit in
//   shared memory for the whole walk, dk and dv accumulate in registers in
//   fp32. Tiles of 64 query rows (32 at d = 128, to keep both accumulators
//   and the scores within 255 registers) of q and do stream through a
//   two-stage TMA ring: thread 0 issues the next tile's loads before the
//   block computes on this one, and the warpgroups meet at a barrier after
//   each tile (a three-stage ring with per-stage release barriers, which
//   frees them from that lockstep, measured slower here; see PERF.md).
//   Each warpgroup reads lse and delta for its columns straight from
//   global memory. Per tile: S^T = k q^T and dP^T = v do^T
//   (wgmma, both operands in shared memory), P^T = exp(S^T scale - lse),
//   dS^T = P^T (dP^T - delta), then dv += P^T do and dk += dS^T q with P^T
//   and dS^T rounded to bf16 in registers as the A operand and do, q
//   MN-major from shared memory. The four products are committed as
//   separate groups, so P^T is computed while dP^T runs and dS^T while
//   dv's product runs. dk takes its 1/sqrt(d) once, in fp32, at
//   the end. Only tiles that cross the diagonal or row t are masked; a
//   warpgroup whose keys all lie past the tile's queries skips it.
//
// dq (both dtypes) and dk/dv in float32 -> flash_bwd_dq_kernel and
//   flash_bwd_dkv_kernel, on the CUDA cores in fp32 (67 TFLOP/s peak, not
//   the tensor cores' 989): four threads share a row, split the head
//   dimension, and meet through warp shuffles; the tiles of the other
//   operand sit in shared memory as fp32 and are read without bank
//   conflicts (the four threads of a row read four consecutive words; the
//   eight rows of a warp read the same words, a broadcast). q is
//   pre-scaled by 1/sqrt(d), so dk carries the factor through q. Tiles of
//   32 rows keep both kernels under the 48 KB of static shared memory at d
//   = 128 in fp32 (two 32 x 128 fp32 tiles are 32 KB). fp32 stays here
//   because the tensor cores take fp32 only as TF32, which the port's fp32
//   policy turns off; dq's move to wgmma is the next redesign (PERF.md).
//
// Each launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (or the tensor map's error)
// so the Python wrapper can raise on a refused launch. The bf16 dk/dv path
// needs 16-byte-aligned q, k, v and do (TMA); the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreadsPerRow = 4;     // threads sharing one row
constexpr int kRows = 64;             // rows a block owns (dq: queries, dkv: keys)
constexpr int kTile = 32;             // rows of the other operand per smem tile
constexpr int kThreads = kRows * kThreadsPerRow;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// sum over the four threads of a row (lanes 4r .. 4r+3 of a warp)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Stage rows [r0, r0 + kTile) of a and b (bh slice at `base`) into shared
// memory as fp32, a scaled by `a_scale`; rows past t are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float (*as)[D], float (*bs)[D],
                                           const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           float a_scale, size_t base, int r0,
                                           int t) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    float ax = 0.f, bx = 0.f;
    if (r0 + r < t) {
      const size_t at = base + static_cast<size_t>(r0 + r) * D + c;
      ax = to_float(a[at]) * a_scale;
      bx = to_float(b[at]);
    }
    as[r][c] = ax;
    bs[r][c] = bx;
  }
}

// One block per (64-row query tile, bh): dq for its rows, walking the key
// tiles at or below the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int t,
                    float scale) {
  static_assert(D % kThreadsPerRow == 0, "head dim must split over a row");
  constexpr int kPer = D / kThreadsPerRow;
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];

  const int row = threadIdx.x / kThreadsPerRow;
  const int lane = threadIdx.x % kThreadsPerRow;  // element e*4+lane is ours
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int qi = q0 + row;
  const bool live = qi < t;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * D;

  float qr[kPer], dor[kPer], acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const size_t at = base + static_cast<size_t>(qi) * D + e * kThreadsPerRow + lane;
    qr[e] = live ? to_float(q[at]) * scale : 0.f;
    dor[e] = live ? to_float(dout[at]) : 0.f;
    acc[e] = 0.f;
  }
  const size_t lrow = static_cast<size_t>(blockIdx.y) * t + qi;
  const float row_lse = live ? lse[lrow] : 0.f;
  const float row_delta = live ? delta[lrow] : 0.f;

  // causal: this q tile sees keys [0, min(t, q0 + kRows))
  const int kv_end = min(t, q0 + kRows);
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<T, D>(ks, vs, k, v, 1.f, base, k0, t);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        s = fmaf(qr[e], ks[j][e * kThreadsPerRow + lane], s);
        dp = fmaf(dor[e], vs[j][e * kThreadsPerRow + lane], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const float p = (live && k0 + j <= qi) ? expf(s - row_lse) : 0.f;
      const float ds = p * (dp - row_delta);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        acc[e] = fmaf(ds, ks[j][e * kThreadsPerRow + lane], acc[e]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const size_t at = base + static_cast<size_t>(qi) * D + e * kThreadsPerRow + lane;
      dq[at] = from_float<T>(acc[e] * scale);
    }
  }
}

// One block per (64-row key tile, bh): dk and dv for its rows, walking the
// query rows from the tile's first key row to the end.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int t, float scale) {
  static_assert(D % kThreadsPerRow == 0, "head dim must split over a row");
  constexpr int kPer = D / kThreadsPerRow;
  __shared__ float qs[kTile][D];   // q * scale
  __shared__ float dos[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int row = threadIdx.x / kThreadsPerRow;
  const int lane = threadIdx.x % kThreadsPerRow;
  const int k0 = blockIdx.x * kRows;   // tile 0 sees every query: it starts first
  const int kj = k0 + row;
  const bool live = kj < t;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * D;
  const size_t lbase = static_cast<size_t>(blockIdx.y) * t;

  float kr[kPer], vr[kPer], dk_acc[kPer], dv_acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const size_t at = base + static_cast<size_t>(kj) * D + e * kThreadsPerRow + lane;
    kr[e] = live ? to_float(k[at]) : 0.f;
    vr[e] = live ? to_float(v[at]) : 0.f;
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  // causal: query i sees key kj iff i >= kj, so the walk starts at row k0
  for (int i0 = k0; i0 < t; i0 += kTile) {
    __syncthreads();
    stage_tile<T, D>(qs, dos, q, dout, scale, base, i0, t);
    if (threadIdx.x < kTile) {
      const int qi = i0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < t ? lse[lbase + qi] : 0.f;
      delta_s[threadIdx.x] = qi < t ? delta[lbase + qi] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        s = fmaf(qs[r][e * kThreadsPerRow + lane], kr[e], s);
        dp = fmaf(dos[r][e * kThreadsPerRow + lane], vr[e], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int qi = i0 + r;
      const float p = (qi < t && qi >= kj) ? expf(s - lse_s[r]) : 0.f;
      const float ds = p * (dp - delta_s[r]);
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        dv_acc[e] = fmaf(p, dos[r][e * kThreadsPerRow + lane], dv_acc[e]);
        dk_acc[e] = fmaf(ds, qs[r][e * kThreadsPerRow + lane], dk_acc[e]);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const size_t at = base + static_cast<size_t>(kj) * D + e * kThreadsPerRow + lane;
      dk[at] = from_float<T>(dk_acc[e]);
      dv[at] = from_float<T>(dv_acc[e]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int bh;
  int t;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((a.t + kRows - 1) / kRows, a.bh);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((a.t + kRows - 1) / kRows, a.bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dk/dv in bfloat16: wgmma with TMA-fed tiles

constexpr int kKeys90 = 128;     // key rows per block: two warpgroups of 64
constexpr int kThreads90 = 256;
constexpr int kStages90 = 2;     // q/do ring

template <int D>
struct DkvSmem {
  static constexpr int kQRows = D == 128 ? 32 : 64;   // query rows per tile
  using KTile = sm90::Tile<kKeys90, D>;
  using QTile = sm90::Tile<kQRows, D>;
  static constexpr int kK = 0;
  static constexpr int kV = KTile::kBytes;
  static constexpr int kQ = 2 * KTile::kBytes;                 // kStages90 q tiles
  static constexpr int kDo = kQ + kStages90 * QTile::kBytes;    // kStages90 do tiles
  static constexpr int kBar = kDo + kStages90 * QTile::kBytes;  // k/v, then per stage
  static constexpr int kBytes = kBar + 8 * (1 + kStages90) + 1024;  // + alignment
};

template <int D>
__global__ void __launch_bounds__(kThreads90, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int t, float scale,
                          float scale_log2) {
  using S = DkvSmem<D>;
  using KTile = typename S::KTile;
  using QTile = typename S::QTile;
  constexpr int kQRows = S::kQRows;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base + S::kK;
  const uint32_t v_s = base + S::kV;
  const uint32_t kv_bar = base + S::kBar;
  auto stage_bar = [&](int s) { return kv_bar + 8 * (1 + s); };

  const int wg = threadIdx.x / 128;            // warpgroup: key rows 64*wg ..
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys90;   // tile 0 sees every query: it starts first
  const int kw0 = k0 + wg * 64;          // this warpgroup's first key
  // causal: query i sees key j iff i >= j, so the walk starts at row k0
  const int n_tiles = (t - k0 + kQRows - 1) / kQRows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kStages90; ++i) sm90::mbar_init(kv_bar + 8 * i, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(kv_bar, 2 * KTile::kBytes);
    sm90::tma_load_tile<kKeys90, D>(k_s, &k_map, kv_bar, k0, bh);
    sm90::tma_load_tile<kKeys90, D>(v_s, &v_map, kv_bar, k0, bh);
    sm90::mbar_expect_tx(stage_bar(0), 2 * QTile::kBytes);
    sm90::tma_load_tile<kQRows, D>(base + S::kQ, &q_map, stage_bar(0), k0, bh);
    sm90::tma_load_tile<kQRows, D>(base + S::kDo, &do_map, stage_bar(0), k0, bh);
  }

  // this thread's two key rows (see sm90::to_a_frags for the accumulator map)
  const int row_a = kw0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int col_in = 2 * (lane % 4);
  const size_t head = static_cast<size_t>(bh) * t;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  sm90::mbar_wait(kv_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages90;
    const int i0 = k0 + j * kQRows;
    if (threadIdx.x == 0 && j + 1 < n_tiles) {
      // the stage of tile j-1: every warpgroup left it at the last barrier
      const int sn = (j + 1) % kStages90;
      sm90::mbar_expect_tx(stage_bar(sn), 2 * QTile::kBytes);
      sm90::tma_load_tile<kQRows, D>(base + S::kQ + sn * QTile::kBytes, &q_map,
                                     stage_bar(sn), i0 + kQRows, bh);
      sm90::tma_load_tile<kQRows, D>(base + S::kDo + sn * QTile::kBytes, &do_map,
                                     stage_bar(sn), i0 + kQRows, bh);
    }
    // lse (in log2 units) and delta of this thread's query columns
    float lse2[kQRows / 4], dlt[kQRows / 4];
#pragma unroll
    for (int c = 0; c < kQRows / 8; ++c) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int col = i0 + 8 * c + col_in + v;
        const bool live = col < t;
        lse2[2 * c + v] = live ? __ldg(lse + head + col) * sm90::kLog2e : 0.f;
        dlt[2 * c + v] = live ? __ldg(delta + head + col) : 0.f;
      }
    }
    sm90::mbar_wait(stage_bar(s), (j / kStages90) & 1);
    __syncwarp();
    const uint32_t q_s = base + S::kQ + s * QTile::kBytes;
    const uint32_t do_s = base + S::kDo + s * QTile::kBytes;

    // warpgroup-uniform: does any query of this tile see a key of ours?
    if (i0 + kQRows - 1 >= kw0) {
      // S^T = k q^T and dP^T = v do^T: 64 keys x kQRows queries, fp32, as
      // two groups, so that P^T is computed while dP^T is still running
      float st[kQRows / 2], dpt[kQRows / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::wgmma_ss(st, KTile::kmajor(k_s, wg * 64, kk), QTile::kmajor(q_s, 0, kk),
                       kk > 0);
      }
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        sm90::wgmma_ss(dpt, KTile::kmajor(v_s, wg * 64, kk), QTile::kmajor(do_s, 0, kk),
                       kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();   // S^T has landed
      sm90::fence_regs(st);

      // P^T in place; masked where a query precedes the key or lies past t
      // (only on tiles that cross the diagonal or row t)
      const bool masked = i0 < kw0 + 63 || i0 + kQRows > t;
#pragma unroll
      for (int c = 0; c < kQRows / 8; ++c) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int col = i0 + 8 * c + col_in + v;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int idx = 4 * c + 2 * half + v;
            float p = sm90::ex2(fmaf(st[idx], scale_log2, -lse2[2 * c + v]));
            if (masked && (col < (half ? row_b : row_a) || col >= t)) p = 0.f;
            st[idx] = p;
          }
        }
      }

      // dv += P^T do (A in bf16 from registers, do MN-major), running
      // while dS^T is computed
      uint32_t p_frag[kQRows / 16][4], ds_frag[kQRows / 16][4];
      sm90::to_a_frags<kQRows>(st, p_frag);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        sm90::wgmma_rs(acc_dv, p_frag[kk], QTile::mnmajor(do_s, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();   // dP^T has landed
      sm90::fence_regs(dpt);

      // dS^T = P^T (dP^T - delta), then dk += dS^T q
#pragma unroll
      for (int c = 0; c < kQRows / 8; ++c) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int idx = 4 * c + 2 * half + v;
            dpt[idx] = st[idx] * (dpt[idx] - dlt[2 * c + v]);
          }
        }
      }
      sm90::to_a_frags<kQRows>(dpt, ds_frag);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQRows / 16; ++kk) {
        sm90::wgmma_rs(acc_dk, ds_frag[kk], QTile::mnmajor(q_s, kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc_dv);
      sm90::fence_regs(acc_dk);
    }
    __syncthreads();   // stage s is free for tile j + 2
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= t) continue;
    const size_t at = (head + row) * D + col_in;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int i = 4 * c + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * c) =
          __floats2bfloat162_rn(acc_dk[i] * scale, acc_dk[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * c) =
          __floats2bfloat162_rn(acc_dv[i], acc_dv[i + 1]);
    }
  }
}

template <int D>
int launch_dkv_sm90(const Args& a) {
  using S = DkvSmem<D>;
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = sm90::make_tile_map(&q_map, a.q, a.bh, a.t, D, S::kQRows);
  if (rc == 0) rc = sm90::make_tile_map(&k_map, a.k, a.bh, a.t, D, kKeys90);
  if (rc == 0) rc = sm90::make_tile_map(&v_map, a.v, a.bh, a.t, D, kKeys90);
  if (rc == 0) rc = sm90::make_tile_map(&do_map, a.dout, a.bh, a.t, D, S::kQRows);
  // above the default 48 KB of dynamic shared memory
  if (rc == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_bwd_dkv_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kBytes));
  }
  if (rc != 0) return rc;
  const double scale = 1.0 / sqrt(static_cast<double>(D));
  const dim3 grid((a.t + kKeys90 - 1) / kKeys90, a.bh);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads90, S::kBytes, a.stream>>>(
      q_map, k_map, v_map, do_map, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.t, static_cast<float>(scale),
      static_cast<float>(scale * sm90::kLog2e));
  return static_cast<int>(cudaGetLastError());
}

// bf16: dq on the CUDA cores, dk/dv on the tensor cores
int dispatch_bf16(const Args& a, int d, int which) {
  using T = __nv_bfloat16;
  switch (d) {
    case 32: return which == 0 ? launch_dq<T, 32>(a) : launch_dkv_sm90<32>(a);
    case 64: return which == 0 ? launch_dq<T, 64>(a) : launch_dkv_sm90<64>(a);
    case 128: return which == 0 ? launch_dq<T, 128>(a) : launch_dkv_sm90<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// which = 0: dq kernel, 1: dk/dv kernel
template <typename T>
int dispatch_dim(const Args& a, int d, int which) {
  switch (d) {
    case 32: return which == 0 ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return which == 0 ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return which == 0 ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& a, int d, int dtype, int which) {
  if (a.bh <= 0 || a.bh > 65535 || a.t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0: return dispatch_dim<float>(a, d, which);
    case 1: return dispatch_bf16(a, d, which);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 = launched).
int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t, int d, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh, t,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, d, dtype, 0);
}

int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int t, int d, int dtype,
                       void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, bh, t,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, d, dtype, 1);
}

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
