// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in ray_tpu/ops/attention.py
// (launched by `_flash_fwd`). Same function: for every (batch*head) slice,
//   o   = softmax(mask(q k^T / sqrt(d))) v      (in the input type)
//   lse = m + log(l)                            (fp32, natural log)
// with the causal mask at -1e30 and the online softmax (running max m,
// running sum l) in fp32.
//
// Layouts: q, k, v and o are contiguous (bh, t, d). lse is (bh, t) fp32.
// The TPU kernel wrote lse as (bh, 1, t) only to satisfy Mosaic's rule on
// the last two block dimensions; nothing on this card needs that, so the
// singleton axis is gone.
//
// Two designs, chosen by the dtype (not a fallback: each dtype has exactly
// one kernel):
//
// bfloat16 -> flash_fwd_sm90_kernel, on the tensor cores. FlashAttention-
//   2/3's layout: one block per (128-row q tile, bh), two warpgroups of 64
//   query rows each. The q tile and a three-stage ring of K and V tiles
//   (64 keys at d <= 64, where two blocks share an SM; 128 keys at d = 128)
//   arrive by TMA (128-byte swizzle at d >= 64, 64-byte at d = 32) into
//   dynamic shared memory, completing on mbarriers. Thread 0 issues each
//   tile's loads two tiles ahead, into the stage both warpgroups have
//   released (an "empty" mbarrier per stage), so the warpgroups are not
//   held in lockstep and one's softmax can overlap the other's products.
//   S = q k^T is a wgmma with both operands in shared memory (m64nNk16,
//   bf16 in, fp32 out); the 1/sqrt(d) scale (times log2 e, for ex2) is
//   applied to S in fp32, never to q in bf16. The softmax runs on the
//   accumulator in registers (a row is spread over a quad of four threads:
//   two shuffles per reduction); P is rounded to bf16 and fed back as the A
//   operand of O += P v straight from registers, with v read from shared
//   memory as an MN-major (transposed) B. Only tiles that cross the
//   diagonal or hold key t-1 are masked; tiles above the diagonal are never
//   loaded, and a warpgroup skips a loaded tile whose keys all lie past its
//   rows.
//   Bound at the training shape (16 x 12 heads, t = 1024, d = 64): 4*d FLOP
//   per visible pair against 8*bh*t*d bytes of q/k/v/o, about 256 FLOP a
//   byte, just under the card's 295: HBM sets the least time (0.030 ms),
//   the tensor cores' 989 TFLOP/s come close behind (0.026 ms), and the
//   exponentials (one per visible pair, on special-function units that
//   retire 16 a clock per SM) are the limit a kernel meets first.
//
// float32 -> flash_fwd_kernel, on the CUDA cores. The tensor cores take
//   fp32 only as TF32 (about three decimal digits), which the port's fp32
//   policy turns off, so fp32 keeps this design: four threads per query
//   row that split the head dimension and meet through warp shuffles, K/V
//   tiles in shared memory read without bank conflicts (the four threads
//   of a row read four consecutive words; the eight rows of a warp read
//   the same words, a broadcast), every product in fp32 with q pre-scaled
//   by 1/sqrt(d). It serves fp32 prompts, where a 1024-token prompt has
//   about 64 FLOP per fp32 byte, so arithmetic, not HBM, sets its bound.
//
// Translation from the TPU kernel (both designs):
//   - The TPU grid walked (bh, t/block_q) in order on one core. Here every
//     (q tile, bh) pair is an independent thread block; the K/V walk that
//     the TPU kept in VMEM is a loop inside the block over tiles staged in
//     shared memory.
//   - No divisibility rule: t may be any length >= 1. The last q tile and
//     the last K/V tile are ragged; rows past t are computed on zeros and
//     never stored, keys past t are zero-filled and masked (a zero key
//     would score 0, not -inf).
//   - The heaviest q tiles (the ones near the end of the sequence, which
//     walk the most K/V tiles) are launched first, so the short tiles fill
//     the tail of the launch.
//
// The launch runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (or the tensor map's error)
// so the Python wrapper can raise on a refused launch. The bf16 path needs
// 16-byte-aligned q, k and v (TMA); the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 64;                  // query rows per thread block
constexpr int kBlockN = 32;                  // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;            // threads sharing one query row
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr float kNegInf = -1e30f;            // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bfloat16: wgmma with TMA-fed tiles

constexpr int kM90 = 128;      // query rows per block: two warpgroups of 64
constexpr int kThreads90 = 256;
constexpr int kStages90 = 3;   // K/V ring
constexpr float kLn2 = 0.6931471805599453f;

// Keys per K/V tile, and blocks per SM. At d <= 64, 64-key tiles keep a
// thread within 128 registers, so two blocks share an SM and one's softmax
// overlaps the other's products; at d = 128 the 64 x 128 output
// accumulator alone takes 64 registers a thread, so one block of 128-key
// tiles holds the SM (both measured; see PERF.md).
template <int D>
struct FwdShape {
  static constexpr int kN = D == 128 ? 128 : 64;
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
};

template <int D>
struct FwdSmem {
  static constexpr int kN = FwdShape<D>::kN;
  using QTile = sm90::Tile<kM90, D>;
  using KTile = sm90::Tile<kN, D>;
  static constexpr int kQ = 0;
  static constexpr int kK = QTile::kBytes;                    // kStages90 K tiles
  static constexpr int kV = kK + kStages90 * KTile::kBytes;   // kStages90 V tiles
  // barriers: q, then full and empty for each stage
  static constexpr int kBar = kV + kStages90 * KTile::kBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages90) + 1024;  // + alignment
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <int D>
__global__ void __launch_bounds__(kThreads90, FwdShape<D>::kMinBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int t,
                      float scale_log2) {
  using S = FwdSmem<D>;
  using QTile = typename S::QTile;
  using KTile = typename S::KTile;
  constexpr int kN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + S::kQ;
  const uint32_t q_bar = base + S::kBar;
  // full[s]: the stage's K and V have landed; empty[s]: both warpgroups
  // are done with it
  auto full_bar = [&](int s) { return q_bar + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return q_bar + 8 * (1 + kStages90 + s); };

  const int wg = threadIdx.x / 128;            // warpgroup: query rows 64*wg ..
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM90;  // heaviest tiles first
  // causal: this q tile sees keys [0, min(t, q0 + kM90))
  const int n_tiles = (min(t, q0 + kM90) + kN - 1) / kN;

  // thread 0 loads tile j into stage j % kStages90, once both warpgroups
  // have released the tile that was there
  auto load_kv = [&](int j) {
    const int s = j % kStages90;
    if (j >= kStages90) sm90::mbar_wait(empty_bar(s), (j / kStages90 - 1) & 1);
    sm90::mbar_expect_tx(full_bar(s), 2 * KTile::kBytes);
    sm90::tma_load_tile<kN, D>(base + S::kK + s * KTile::kBytes, &k_map, full_bar(s),
                               j * kN, bh);
    sm90::tma_load_tile<kN, D>(base + S::kV + s * KTile::kBytes, &v_map, full_bar(s),
                               j * kN, bh);
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < kStages90; ++s) {
      sm90::mbar_init(full_bar(s), 1);
      sm90::mbar_init(empty_bar(s), 2);   // one arrival per warpgroup
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(q_bar, QTile::kBytes);
    sm90::tma_load_tile<kM90, D>(q_s, &q_map, q_bar, q0, bh);
    for (int j = 0; j < kStages90 - 1 && j < n_tiles; ++j) load_kv(j);
  }

  // this thread's two rows (see sm90::to_a_frags for the accumulator map)
  const int row_a = q0 + wg * 64 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int col_in = 2 * (lane % 4);
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;   // running max, in log2 units
  float l_a = 0.f, l_b = 0.f;           // this thread's share of the row sums

  sm90::mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages90;
    // into the stage of tile j-1; warpgroup 0 waits here until warpgroup 1
    // is done with that tile, so the two run at most a tile apart
    if (threadIdx.x == 0 && j + kStages90 - 1 < n_tiles) load_kv(j + kStages90 - 1);
    sm90::mbar_wait(full_bar(s), (j / kStages90) & 1);
    __syncwarp();
    const uint32_t k_s = base + S::kK + s * KTile::kBytes;
    const uint32_t v_s = base + S::kV + s * KTile::kBytes;
    // warpgroup-uniform: every key of the tile lies past this warpgroup's
    // rows (with 64-key tiles, the last tile for warpgroup 0)
    if (j * kN > q0 + wg * 64 + 63) {
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(empty_bar(s));
      continue;
    }

    // S = q k^T for this warpgroup's 64 rows and the tile's keys, fp32
    float acc_s[kN / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss(acc_s, QTile::kmajor(q_s, wg * 64, kk), KTile::kmajor(k_s, 0, kk),
                     kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_s);

    // scale (in fp32), mask, and the tile's row max
    const int k0 = j * kN;
    const bool masked = k0 + kN - 1 > q0 + wg * 64 || k0 + kN > t;
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int c = 0; c < kN / 8; ++c) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int col = k0 + 8 * c + col_in + v;
        float xa = acc_s[4 * c + v] * scale_log2;
        float xb = acc_s[4 * c + 2 + v] * scale_log2;
        if (masked) {
          if (col > row_a || col >= t) xa = kNegInf;
          if (col > row_b || col >= t) xb = kNegInf;
        }
        acc_s[4 * c + v] = xa;
        acc_s[4 * c + 2 + v] = xb;
        mx_a = fmaxf(mx_a, xa);
        mx_b = fmaxf(mx_b, xb);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // key 0 is in the first tile and visible to every row, so m is finite
    // from the first tile on and ex2(-1e30 - m) is exactly 0
    const float new_a = fmaxf(m_a, mx_a);
    const float new_b = fmaxf(m_b, mx_b);
    const float alpha_a = sm90::ex2(m_a - new_a);
    const float alpha_b = sm90::ex2(m_b - new_b);
    m_a = new_a;
    m_b = new_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int c = 0; c < kN / 8; ++c) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float pa = sm90::ex2(acc_s[4 * c + v] - new_a);
        const float pb = sm90::ex2(acc_s[4 * c + 2 + v] - new_b);
        acc_s[4 * c + v] = pa;
        acc_s[4 * c + 2 + v] = pb;
        sum_a += pa;
        sum_b += pb;
      }
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc_o[4 * c] *= alpha_a;
      acc_o[4 * c + 1] *= alpha_a;
      acc_o[4 * c + 2] *= alpha_b;
      acc_o[4 * c + 3] *= alpha_b;
    }

    // O += P v: P in bf16 from registers, v MN-major from shared memory
    uint32_t p_frag[kN / 16][4];
    sm90::to_a_frags<kN>(acc_s, p_frag);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      sm90::wgmma_rs(acc_o, p_frag[kk], KTile::mnmajor(v_s, kk));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_o);
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(empty_bar(s));
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const size_t head = static_cast<size_t>(bh) * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_b : row_a;
    if (row >= t) continue;
    const float l = half ? l_b : l_a;
    const float inv = 1.f / l;
    __nv_bfloat16* out = o + (head + row) * D + col_in;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) = __floats2bfloat162_rn(
          acc_o[4 * c + 2 * half] * inv, acc_o[4 * c + 2 * half + 1] * inv);
    }
    // lse in natural log: ln(sum 2^x) = (m + log2 l) ln 2
    if (lane % 4 == 0) lse[head + row] = ((half ? m_b : m_a) + log2f(l)) * kLn2;
  }
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                int bh, int t, cudaStream_t stream) {
  constexpr int kN = FwdShape<D>::kN;
  CUtensorMap q_map, k_map, v_map;
  int rc = sm90::make_tile_map(&q_map, q, bh, t, D, kM90);
  if (rc == 0) rc = sm90::make_tile_map(&k_map, k, bh, t, D, kN);
  if (rc == 0) rc = sm90::make_tile_map(&v_map, v, bh, t, D, kN);
  // above the default 48 KB of dynamic shared memory
  if (rc == 0) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FwdSmem<D>::kBytes));
  }
  if (rc != 0) return rc;
  const float scale_log2 =
      static_cast<float>(sm90::kLog2e / sqrt(static_cast<double>(D)));
  const dim3 grid((t + kM90 - 1) / kM90, bh);
  flash_fwd_sm90_kernel<D><<<grid, kThreads90, FwdSmem<D>::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), t,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                  int bh, int t, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_sm90<32>(q, k, v, o, lse, bh, t, stream);
    case 64: return launch_sm90<64>(q, k, v, o, lse, bh, t, stream);
    case 128: return launch_sm90<128>(q, k, v, o, lse, bh, t, stream);
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
    case 1: return dispatch_sm90(q, k, v, o, lse, bh, t, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
