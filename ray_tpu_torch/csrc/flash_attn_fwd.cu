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
// float32 -> flash_fwd_fp32_kernel<D, BM>, register-tiled on the CUDA
//   cores. The tensor cores take fp32 only as TF32 (about three decimal
//   digits; 3xTF32 needs a tolerance argument of its own), which the
//   port's fp32 policy turns off, so every product is an fp32 FMA. It runs
//   every fp32 prompt of the serving engine (12 launches a cold prefill of
//   GPT-2-124M, at (1, 12, T <= 1024, 64)).
//   Bound: 4*d FLOP per visible pair over the CUDA cores' 67 TFLOP/s;
//   a 1024-token prompt has about 64 FLOP per fp32 byte of q/k/v/o against
//   the card's 20, so arithmetic, not HBM, sets the least time (0.0241 ms
//   at (1, 12, 1024, 64)). Before the FMAs reach that rate three things
//   stand in the way, and the design answers each:
//   - Shared-memory bandwidth (32 words a clock per SM against 128 FMA
//     lanes). A block of 128 threads is 16 row groups x 8 key groups; a
//     thread owns BM/16 query rows (rg, rg+16, ...) by 8 keys (cg, cg+8,
//     ...) of S and the same rows by d/8 columns of O (4 cg .. 4 cg + 3,
//     then every 32 on). Both products read 16-byte fragments: per 4-wide
//     slice of d, BM/16 q rows and 8 k rows feed BM/16 x 8 x 4 FMAs, and per
//     4 keys, BM/16 P rows and 4 v rows feed as many. Rows of q, k and v sit
//     in shared memory at a stride of d+4 words, and P at 64+8, so the
//     row groups and key groups of a warp hit distinct banks (the 8 lanes
//     of a row group share a row: a broadcast). A row's max and sum meet
//     through three shuffles among the 8 lanes of its key groups, all in
//     one warp; P goes through shared memory that only that warp reads.
//   - Memory latency. The q tile and a two-stage ring of 64-key K and V
//     tiles arrive by 16-byte cp.async copies (keys and rows past t are
//     zero-filled); tile j+1 is in flight while tile j's products run.
//   - A grid too small for 132 SMs at one request's shapes. The grid is
//     (bh, ceil(t / BM)): blockIdx.x the slice, blockIdx.y the rank of the
//     q tile counted from the last one, so the heaviest tiles of every
//     slice launch first. BM (64, 32 or 16 query rows) is chosen by the
//     host from the launch (ray_tpu_torch/ops/attention.py
//     `fwd_block_m`): 64 where the grid holds two waves of blocks, 32
//     where it holds one, else 16, so a short prompt of one request still
//     spreads over every SM and no 64-row tile walks a long prompt alone
//     at the end of the launch; K and V, 6.3 MB for 12 heads at t = 1024,
//     stay in the 50 MB L2 while smaller q tiles read them again.
//   The softmax works in log2 units (the scale times log2 e, ex2), and
//   masks only the tiles that cross the diagonal or hold key t-1. The
//   keys are not split across blocks: each row is one block's, so the
//   output is bitwise repeatable.
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
// so the Python wrapper can raise on a refused launch. Both paths need
// 16-byte-aligned q, k and v (TMA, cp.async); the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;            // the TPU kernel's NEG_INF

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

// ---------------------------------------------------------------------------
// float32: register tiles on the CUDA cores, cp.async-fed tiles

constexpr int kThreads32 = 128;
constexpr int kRowGroups = 16;               // a thread's rows: rg + 16 r
constexpr int kKeyGroups = 8;                // its keys: cg + 8 i
constexpr int kN32 = 64;                     // keys per K/V tile
constexpr int kKeys32 = kN32 / kKeyGroups;   // keys of S per thread

// Shared memory, in floats: the q tile, two stages of K and V, P. Rows of
// q, k and v are d+4 floats apart and rows of P 64+8: 16-byte fragments of
// consecutive rows start 4 (q, k) or 8 (P) banks apart, so the 4 row groups
// and the 8 key groups of a warp read without bank conflicts.
template <int D, int BM>
struct Fp32Smem {
  static constexpr int kRow = D + 4;
  static constexpr int kPRow = kN32 + 8;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BM * kRow;
  static constexpr int kV = kK + 2 * kN32 * kRow;
  static constexpr int kP = kV + 2 * kN32 * kRow;
  static constexpr int kBytes = 4 * (kP + BM * kPRow);
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
  // blocks an SM holds (228 KB of shared memory, 1 KB reserved a block),
  // at most 4: given to ptxas as the occupancy to aim for, so that it
  // spends the registers that allows (at least 128 a thread) instead of
  // spilling for an occupancy shared memory never lets it reach
  static constexpr int kFit = 233472 / (kBytes + 1024);
  static constexpr int kBlocksPerSm = kFit < 4 ? kFit : 4;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows r0 .. r0+R-1 of one (t, D) slice into shared memory at dst (rows D+4
// floats apart); rows past t arrive as zeros. Thread i copies chunk i % (D/4)
// of rows i / (D/4), then every 128 / (D/4) rows on: its shared address
// moves by a constant each pass, so the copy holds one offset, not one a pass.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src, int r0, int t) {
  constexpr int kChunks = D / 4;                    // 16-byte chunks a row
  constexpr int kPassRows = kThreads32 / kChunks;   // rows a pass of the block copies
  static_assert(kThreads32 % kChunks == 0 && R % kPassRows == 0, "whole rows a pass");
  const int r = r0 + threadIdx.x / kChunks;
  const int c = threadIdx.x % kChunks;
  dst += 4 * ((threadIdx.x / kChunks) * (D + 4) + 4 * c);
  src += 4 * c;
#pragma unroll
  for (int pass = 0; pass < R / kPassRows; ++pass) {
    const int row = r + pass * kPassRows;
    const bool in = row < t;
    cp_async16(dst + 4 * pass * kPassRows * (D + 4),
               src + static_cast<size_t>(in ? row : 0) * D, in);
  }
}

// K/V tile j (keys j*64 ..) into stage j % 2
template <int D, int BM>
__device__ __forceinline__ void load_kv(uint32_t base, const float* kh, const float* vh,
                                        int j, int t) {
  using S = Fp32Smem<D, BM>;
  const int s = j & 1;
  load_rows<D, kN32>(base + 4 * (S::kK + s * kN32 * S::kRow), kh, j * kN32, t);
  load_rows<D, kN32>(base + 4 * (S::kV + s * kN32 * S::kRow), vh, j * kN32, t);
}

template <int D, int BM>
__global__ void __launch_bounds__(kThreads32, (Fp32Smem<D, BM>::kBlocksPerSm))
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t, float scale_log2) {
  using S = Fp32Smem<D, BM>;
  constexpr int TM = BM / kRowGroups;    // query rows a thread
  constexpr int kCols = D / 32;          // 4-wide column chunks of O a thread
  constexpr int kRow = S::kRow;
  constexpr int kPRow = S::kPRow;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t base = sm90::smem_u32(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp * 4 + lane / 8;    // 4 row groups a warp
  const int cg = lane % 8;               // 8 key groups, one row group's lanes
  const size_t head = static_cast<size_t>(blockIdx.x) * t;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const float* kh = k + head * D;
  const float* vh = v + head * D;
  // causal: this q tile sees keys [0, min(t, q0 + BM))
  const int n_tiles = (min(t, q0 + BM) + kN32 - 1) / kN32;

  load_rows<D, BM>(base + 4 * S::kQ, q + head * D, q0, t);
  load_kv<D, BM>(base, kh, vh, 0, t);
  cp_async_commit();

  const float* qs = smem + S::kQ;
  float* ps = smem + S::kP;
  float acc[TM][4 * kCols];
  float m[TM], l[TM];                    // running max (log2 units), partial sum
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    // tile j+1 into the other stage, freed by the barrier that ended j-1
    if (j + 1 < n_tiles) {
      load_kv<D, BM>(base, kh, vh, j + 1, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // every thread's copies of tile j (and q) have landed
    const float* ks = smem + S::kK + (j & 1) * kN32 * kRow;
    const float* vs = smem + S::kV + (j & 1) * kN32 * kRow;

    // S = q k^T: rows rg + 16 r, keys cg + 8 i
    float s[TM][kKeys32];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int i = 0; i < kKeys32; ++i) s[r][i] = 0.f;
#pragma unroll
    for (int dc = 0; dc < D; dc += 4) {
      float4 qf[TM], kf[kKeys32];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        qf[r] = *reinterpret_cast<const float4*>(qs + (rg + kRowGroups * r) * kRow + dc);
#pragma unroll
      for (int i = 0; i < kKeys32; ++i)
        kf[i] = *reinterpret_cast<const float4*>(ks + (cg + kKeyGroups * i) * kRow + dc);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int i = 0; i < kKeys32; ++i) {
          s[r][i] = fmaf(qf[r].x, kf[i].x, s[r][i]);
          s[r][i] = fmaf(qf[r].y, kf[i].y, s[r][i]);
          s[r][i] = fmaf(qf[r].z, kf[i].z, s[r][i]);
          s[r][i] = fmaf(qf[r].w, kf[i].w, s[r][i]);
        }
    }

    // scale (in log2 units), mask the tiles that cross the diagonal or
    // hold key t-1, the online softmax, P into this warp's rows of ps
    const int k0 = j * kN32;
    const bool masked = k0 + kN32 - 1 > q0 || k0 + kN32 > t;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int qi = q0 + rg + kRowGroups * r;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeys32; ++i) {
        float x = s[r][i] * scale_log2;
        if (masked) {
          const int kj = k0 + cg + kKeyGroups * i;
          if (kj > qi || kj >= t) x = kNegInf;
        }
        s[r][i] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // key 0 is in the first tile and visible to every row, so m is finite
      // from the first tile on and ex2(-1e30 - m) is exactly 0
      const float m_new = fmaxf(m[r], mx);
      const float alpha = sm90::ex2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys32; ++i) {
        const float p = sm90::ex2(s[r][i] - m_new);
        sum += p;
        ps[(rg + kRowGroups * r) * kPRow + cg + kKeyGroups * i] = p;
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();      // a row's P is written and read by its row group's lanes

    // O += P v: rows rg + 16 r, columns 4 cg + 32 c .. + 3
#pragma unroll
    for (int jc = 0; jc < kN32; jc += 4) {
      float4 pf[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        pf[r] = *reinterpret_cast<const float4*>(ps + (rg + kRowGroups * r) * kPRow + jc);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vf[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vf[c] = *reinterpret_cast<const float4*>(vs + (jc + jj) * kRow + 4 * cg + 32 * c);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float p = jj == 0 ? pf[r].x : jj == 1 ? pf[r].y : jj == 2 ? pf[r].z : pf[r].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[r][4 * c] = fmaf(p, vf[c].x, acc[r][4 * c]);
            acc[r][4 * c + 1] = fmaf(p, vf[c].y, acc[r][4 * c + 1]);
            acc[r][4 * c + 2] = fmaf(p, vf[c].z, acc[r][4 * c + 2]);
            acc[r][4 * c + 3] = fmaf(p, vf[c].w, acc[r][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();   // tile j's stage and P are free for the next writes
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    const int qi = q0 + rg + kRowGroups * r;
    if (qi >= t) continue;
    float* out = o + (head + qi) * D + 4 * cg;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      *reinterpret_cast<float4*>(out + 32 * c) =
          make_float4(acc[r][4 * c] / lr, acc[r][4 * c + 1] / lr,
                      acc[r][4 * c + 2] / lr, acc[r][4 * c + 3] / lr);
    }
    // lse in natural log: ln(sum 2^x) = (m + log2 l) ln 2
    if (cg == 0) lse[head + qi] = (m[r] + log2f(lr)) * kLn2;
  }
}

template <int D, int BM>
int launch_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                int bh, int t, cudaStream_t stream) {
  using S = Fp32Smem<D, BM>;
  const int n_tiles = (t + BM - 1) / BM;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // above the default 48 KB of dynamic shared memory
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_fp32_kernel<D, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes));
  if (rc != 0) return rc;
  const float scale_log2 =
      static_cast<float>(sm90::kLog2e / sqrt(static_cast<double>(D)));
  const dim3 grid(bh, n_tiles);
  flash_fwd_fp32_kernel<D, BM><<<grid, kThreads32, S::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      t, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_fp32_rows(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int block_m, cudaStream_t stream) {
  switch (block_m) {
    case 64: return launch_fp32<D, 64>(q, k, v, o, lse, bh, t, stream);
    case 32: return launch_fp32<D, 32>(q, k, v, o, lse, bh, t, stream);
    case 16: return launch_fp32<D, 16>(q, k, v, o, lse, bh, t, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                  int bh, int t, int d, int block_m, cudaStream_t stream) {
  switch (d) {
    case 32: return dispatch_fp32_rows<32>(q, k, v, o, lse, bh, t, block_m, stream);
    case 64: return dispatch_fp32_rows<64>(q, k, v, o, lse, bh, t, block_m, stream);
    case 128: return dispatch_fp32_rows<128>(q, k, v, o, lse, bh, t, block_m, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. block_m: query rows per block, from the
// host's plan (ray_tpu_torch/ops/attention.py `fwd_block_m`): 64, 32 or 16
// for float32, 128 (the bf16 design's two warpgroups) for bfloat16.
// Returns a cudaError_t (0 = launched).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, int d, int dtype, int block_m,
                   void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_fp32(q, k, v, o, lse, bh, t, d, block_m, s);
    case 1:
      if (block_m != kM90) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_sm90(q, k, v, o, lse, bh, t, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
