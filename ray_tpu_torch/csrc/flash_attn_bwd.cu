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
//   flash_bwd_dq_kernel   dq_i = (1/sqrt(d)) sum_j ds * k_j      (3 products)
//   flash_bwd_dkv_kernel  dv_j = sum_i p * do_i,                 (4 products)
//                         dk_j = sum_i ds * (q_i / sqrt(d))
// q is pre-scaled by 1/sqrt(d) before the product, as in the forward, so
// dk carries the factor through q. Every product and sum is in fp32; the
// gradients are written in q's type (float32 or bfloat16).
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
//     on zeros and never stored; their lse and delta are never read (p is
//     forced to 0 there); keys past t are zero-filled and masked.
//   - The dk/dv kernel's first query row is its tile's first key row,
//     computed from rows, not from a floored tile ratio.
//
// What bounds them on an H100 at the training shape (16 x 12 heads, t =
// 1024, d = 64, bf16): the dq kernel does 3 products of 2*d FLOP per causal
// pair, the dk/dv kernel 4, against about 7*bh*t*d elements of traffic; at
// t = 1024 that is hundreds of FLOP per byte, so arithmetic sets the least
// time, not HBM. This first version, like the forward, does the products
// on the CUDA cores in fp32 (67 TFLOP/s peak, not the tensor cores'
// 989): four threads share a row, split the head dimension, and meet
// through warp shuffles; the tiles of the other operand sit in shared
// memory as fp32 and are read without bank conflicts (the four threads of
// a row read four consecutive words; the eight rows of a warp read the
// same words, a broadcast). Tiles of 32 rows keep both kernels under the
// 48 KB of static shared memory at d = 128 in fp32 (two 32 x 128 fp32
// tiles are 32 KB). Moving the products onto wgmma with TMA-fed tiles is
// later work; see PERF.md for the measured times against the bound.
//
// Each launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
    case 1: return dispatch_dim<__nv_bfloat16>(a, d, which);
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
