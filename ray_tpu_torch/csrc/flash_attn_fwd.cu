// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in ray_tpu/ops/attention.py
// (launched by `_flash_fwd`). Same function: for every (batch*head) slice,
//   o   = softmax(mask(q k^T / sqrt(d))) v      (in the input type)
//   lse = m + log(l)                            (fp32, natural log)
// with the causal mask at -1e30, q pre-scaled by 1/sqrt(d), and every
// product and the online softmax (running max m, running sum l) in fp32.
//
// Layouts: q, k, v and o are contiguous (bh, t, d). lse is (bh, t) fp32.
// The TPU kernel wrote lse as (bh, 1, t) only to satisfy Mosaic's rule on
// the last two block dimensions; nothing on this card needs that, so the
// singleton axis is gone.
//
// Translation from the TPU kernel:
//   - The TPU grid walked (bh, t/block_q) in order on one core. Here every
//     (q tile, bh) pair is an independent thread block; the K/V walk that
//     the TPU kept in VMEM is a loop inside the block over tiles staged in
//     shared memory.
//   - No divisibility rule: t may be any length >= 1. The last q tile and
//     the last K/V tile are ragged; rows past t are computed on zeros and
//     never stored, keys past t are zero-filled and masked.
//   - The heaviest q tiles (the ones near the end of the sequence, which
//     walk the most K/V tiles) are launched first, so the short tiles fill
//     the tail of the launch.
//
// What bounds it on an H100 at the serving shapes (one prompt of 16..1024
// tokens, 12 heads, d = 64): the work is 4*d multiply-adds per causal
// (query, key) pair, about 2*bh*t^2*d FLOP, against 4*bh*t*d elements of
// q/k/v/o traffic. At t = 512 that is about 64 FLOP per fp32 byte, so the
// least time is set by arithmetic, not by HBM. This first version does the
// products on the CUDA cores in fp32 (67 TFLOP/s peak, not the tensor
// cores), with four threads per query row that split the head dimension
// and meet through warp shuffles, and K/V tiles read from shared memory
// without bank conflicts (the four threads of a row read four consecutive
// words; the eight rows of a warp read the same words, a broadcast).
// Moving the two products onto wgmma with TMA-fed, double-buffered tiles is
// later work; see PERF.md for its measured time against the bound.
//
// The launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockM = 64;                  // query rows per thread block
constexpr int kBlockN = 32;                  // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;            // threads sharing one query row
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr float kNegInf = -1e30f;            // the TPU kernel's NEG_INF

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, float scale) {
  static_assert(D % kThreadsPerRow == 0, "head dim must split over a row");
  constexpr int kPerThread = D / kThreadsPerRow;
  __shared__ float ks[kBlockN][D];
  __shared__ float vs[kBlockN][D];

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int lane = tid % kThreadsPerRow;  // element e*4+lane of a row is ours
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = q_tile * kBlockM;
  const int qi = q0 + row;
  const bool live = qi < t;
  const size_t base = static_cast<size_t>(blockIdx.y) * t * D;

  float qr[kPerThread];
  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const size_t at = base + static_cast<size_t>(qi) * D + e * kThreadsPerRow + lane;
    qr[e] = live ? to_float(q[at]) * scale : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  // causal: this q tile sees keys [0, min(t, q0 + kBlockM))
  const int kv_end = min(t, q0 + kBlockM);
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const int kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < t) {
        const size_t at = base + static_cast<size_t>(kj) * D + c;
        kx = to_float(k[at]);
        vx = to_float(v[at]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float s[kBlockN];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        part = fmaf(qr[e], ks[j][e * kThreadsPerRow + lane], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      s[j] = (kj <= qi && kj < t) ? part : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // key 0 is in the first tile and visible to every row, so m is finite
    // from the first tile on and exp(-1e30 - m) underflows to exactly 0
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        acc[e] = fmaf(p, vs[j][e * kThreadsPerRow + lane], acc[e]);
      }
    }
    m = m_new;
  }

  if (live) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const size_t at = base + static_cast<size_t>(qi) * D + e * kThreadsPerRow + lane;
      o[at] = from_float<T>(acc[e] / l);
    }
    if (lane == 0) {
      lse[static_cast<size_t>(blockIdx.y) * t + qi] = m + logf(l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int t, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((t + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int t, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, int d, int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(q, k, v, o, lse, bh, t, d, s);
    case 1: return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
