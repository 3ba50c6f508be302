// Mamba2 SSD intra-chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_intra_chunk). For every chunk n (one chunk
// of one sequence, cl <= 256 positions) and head h, with
// cum = cumsum_m(dt[m] * A[h]) over the chunk and g = h / (nh / G):
//     y[n,i,h,:]    = sum_{j <= i} (C[n,i,g,:] . B[n,j,g,:]) exp(cum_i - cum_j) x[n,j,h,:] dt[j]
//     states[n,h]   = sum_j exp(cum_last - cum_j) (x[n,j,h,:] dt[j]) (outer) B[n,j,g,:]
//     decays[n,h]   = exp(cum_last)
// x, B, C in f32 or bf16, dt and A in f32; the outputs are f32. The decay
// exp(cum_i - cum_j) is evaluated only where j <= i and zero is SELECTED
// elsewhere: for j > i the exponent is positive and can overflow, and a
// 0/1 mask times inf would give NaN.
//
// Bound on the H100: per (chunk, head), cl(cl+1)/2 live (i, j) pairs of
// 2(ds + hd) operations each plus 2 cl hd ds for the state, against reading
// x, B, C, dt once and writing y, states, decays once. At the training shape
// (32 chunks of 256, 32 heads of 64, ds 128, one group) that is 17.2 GFLOP
// by the function's definition against 139 MB, 100 MB of it the f32
// outputs: bound by bytes in bf16 at the tensor cores' rate.
//
// bf16 (the training dtype): wgmma + TMA, warp-specialised.
//   * C.B^T once per (chunk, group, row tile), shared by the group's heads:
//     a block takes one chunk, one group, a slice of the group's heads and
//     a pair of 64-row tiles (p, T-1-p) of the chunk's T = ceil(cl/64), so
//     that the pairs' live key tiles even out across blocks (5 and 5 at
//     cl = 256). Each of its two consumer warpgroups computes
//     S = C[row tile] B[0 : i0+64]^T once (wgmma, both operands K-major in
//     shared memory, f32 accumulators) and keeps it in shared memory as f32
//     for every head of the slice. The heads are split into as many slices
//     as fill the SMs (128 blocks at the training shape and at
//     Mamba2-2.7B's).
//   * dt A is scanned once per (block, head) by a warp of the producer
//     warpgroup, up to three heads ahead, into a ring of shared buffers:
//     cum2 = cum log2(e), cjd = cum2 - log2(dt) and sc = dt exp(cum_last -
//     cum). The consumers only wait for a head's buffer.
//   * Per head, P = S * exp2(cum2_i - cjd_j) = S * exp(cum_i - cum_j) * dt_j
//     on the accumulators' layout (dt folded into the exponent, so x stays
//     exact bf16) is the register A operand of Y += P x (wgmma m64n64k16,
//     the x key tile as an MN-major B operand); P of the next key tile is
//     computed while the product of this one runs. P goes in as two bf16
//     terms, its rounding and the rounding of the remainder (two products
//     per k-step): P rounded once to bf16 misses the bf16 tolerance
//     (3e-2, 3e-2) on y where y is small, as tests/test_torch_ssm.py
//     shows.
//   * The state on the tensor cores too: D[p][d] += x~^T[p][j] B[j][d] for
//     pieces of 32 state dims, with x~ = x dt w rounded to bf16 once
//     (w_j = exp(cum_last - cum_j)). x~^T comes from the x tile by
//     ldmatrix.trans into the A-fragment layout and is scaled in registers;
//     B is the key tile as an MN-major operand, and two adjacent pieces are
//     one n64 pass. The pieces go out in pairs to the warpgroups with the
//     least work (the same on every block): at cl = 256, ds = 128 the row
//     tiles 0 and 1 take one pair each, next to 1 and 2 key tiles of Y, and
//     the row tiles 2 and 3 take none.
//   * TMA with a producer thread: 4-D descriptors over the tensors' own
//     strides ((hd, heads, cl, N) for x, (ds, G, cl, N) for B and C). TMA
//     zero-fills what lies outside: rows past cl (the ragged chunk needs no
//     mask on its loads), head dims past hd (every x tile is 64 wide, so
//     one instantiation serves hd 16, 32 and 64) and state dims past ds (B
//     and C come in boxes of 32 dims). x tiles stream through a ring of
//     eight, two heads' worth at cl = 256, so the next head's tiles land
//     while this one's products run; C shares the ring's upper half until
//     S is computed.
//   * Outputs leave as 16-byte stores: two lanes trade half their
//     accumulator pairs, so that each lane holds four consecutive f32 of
//     one row, and a warp's store covers whole 32-byte sectors.
//   * Every wgmma group is committed and waited in the same basic block,
//     under no condition (loops of runtime length around whole groups):
//     a group issued under a condition that ptxas cannot pair with its
//     wait makes it serialise every wgmma of the kernel. The producer
//     warpgroup keeps 56 registers, since ptxas holds the code after
//     setmaxnreg.dec to its count and spills the scan warp at 40.
//
// What bounds it now is latency: each warpgroup's chain of P (exp2 and the
// bf16 conversions of two terms on the CUDA cores), its products and the
// state's fragments, at about half the byte bound's rate at the training
// shape; the tensor cores and the memory are far from busy.
//
// f32 (the `--precision f32` comparison path): f32 FMAs on the CUDA cores
// (no TF32). One block of 256 threads per (row tile of 64 positions, head,
// chunk), walking the key tiles j0 <= i0 like a causal attention without
// softmax, plus one block per (head, chunk) for the chunk state and decay;
// C.B^T is recomputed for every head there.
//
// Left for later: a backward kernel (the backward differentiates the plain
// ssd_chunked in torch, as the JAX package differentiates its reference).
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int CL_MAX = 256;       // longest chunk; also the scan's width
constexpr int BT = 64;            // positions per row tile and per key tile

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;      // 16 x 16
constexpr int TLD = BT + 4;       // floats per row of a transposed tile

struct Args {
  const void *x, *B, *C;
  const float *dt, *A;
  long long sx[3], sb[3], sc[3], sd[3];   // outer strides; the last axis is unit
  float *y, *states, *decays;
  int N, cl, nh, G, ds, hd;
};

// Inclusive scan of dt * A over the chunk into cum[0..CL_MAX) (0 past cl);
// dt itself into dts. Ends with a barrier.
__device__ void chunk_cumsum(const Args& a, int n, int h, float* cum, float* dts) {
  __shared__ float warp_tot[THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float dtv = 0.f;
  if (tid < a.cl) dtv = a.dt[n * a.sd[0] + tid * a.sd[1] + h * a.sd[2]];
  float v = dtv * a.A[h];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_tot[w];
  cum[tid] = tid < a.cl ? v : 0.f;
  dts[tid] = dtv;
  __syncthreads();
}

// y for rows i0 .. i0+63 of chunk n, head h.
template <int HD>
__device__ void diag_tile(const Args& a, int n, int h, int i0, float* smem) {
  const int ds = a.ds, DS4 = (ds + 3) & ~3, cl = a.cl;
  float* cum = smem;
  float* dts = cum + CL_MAX;
  float* Ct = dts + CL_MAX;          // [DS4][TLD]: C rows of this tile, transposed
  float* Bt = Ct + DS4 * TLD;        // [DS4][TLD]: B rows of the key tile, transposed
  float* Xs = Bt + DS4 * TLD;        // [BT][HD]:   x * dt of the key tile
  float* Pt = Xs + BT * HD;          // [BT][TLD]:  P transposed, Pt[j][i]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = h / (a.nh / a.G);
  const float* xb = static_cast<const float*>(a.x) + n * a.sx[0] + h * a.sx[2];
  const float* Bb = static_cast<const float*>(a.B) + n * a.sb[0] + g * a.sb[2];
  const float* Cb = static_cast<const float*>(a.C) + n * a.sc[0] + g * a.sc[2];

  chunk_cumsum(a, n, h, cum, dts);
  for (int e = tid; e < BT * DS4; e += THREADS) {
    const int i = e / DS4, d = e % DS4;
    Ct[d * TLD + i] = (i0 + i < cl && d < ds) ? Cb[(i0 + i) * a.sc[1] + d] : 0.f;
  }

  constexpr int PPT = HD / 16;       // output columns per thread
  float acc[4][PPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < PPT; ++q) acc[r][q] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += BT) {
    __syncthreads();                 // the last tile's readers are done
    for (int e = tid; e < BT * DS4; e += THREADS) {
      const int j = e / DS4, d = e % DS4;
      Bt[d * TLD + j] = (j0 + j < cl && d < ds) ? Bb[(j0 + j) * a.sb[1] + d] : 0.f;
    }
    for (int e = tid; e < BT * HD; e += THREADS) {
      const int j = e / HD, p = e % HD;
      Xs[e] = j0 + j < cl ? xb[(j0 + j) * a.sx[1] + p] * dts[j0 + j] : 0.f;
    }
    __syncthreads();

    // S = C B^T: rows ty*4 + r, key columns tx*4 + c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < DS4; ++d) {
      const float4 cv = *reinterpret_cast<const float4*>(Ct + d * TLD + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bt + d * TLD + tx * 4);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cr[r], bc[c], s[r][c]);
    }
    // P = S * exp(cum_i - cum_j) where j <= i < cl; zero selected elsewhere
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        pr[r] = (j <= i && i < cl) ? s[r][c] * expf(cum[i] - cum[j]) : 0.f;
      }
      *reinterpret_cast<float4*>(Pt + (tx * 4 + c) * TLD + ty * 4) =
          make_float4(pr[0], pr[1], pr[2], pr[3]);
    }
    __syncthreads();

    // Y += P X: rows ty*4 + r, columns tx + 16q
    for (int j = 0; j < BT; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + j * TLD + ty * 4);
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const float xv = Xs[j * HD + tx + 16 * q];
        acc[0][q] = fmaf(pv.x, xv, acc[0][q]);
        acc[1][q] = fmaf(pv.y, xv, acc[1][q]);
        acc[2][q] = fmaf(pv.z, xv, acc[2][q]);
        acc[3][q] = fmaf(pv.w, xv, acc[3][q]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= cl) continue;
    float* yr = a.y + ((static_cast<long long>(n) * cl + i) * a.nh + h) * HD;
#pragma unroll
    for (int q = 0; q < PPT; ++q) yr[tx + 16 * q] = acc[r][q];
  }
}

// states[n,h] (HD x ds) and decays[n,h] of chunk n, head h.
template <int HD>
__device__ void state_tile(const Args& a, int n, int h, float* smem) {
  const int ds = a.ds, DS4 = (ds + 3) & ~3, cl = a.cl;
  float* cum = smem;
  float* dts = cum + CL_MAX;
  float* Xw = dts + CL_MAX;          // [BT][HD]:  x * dt * exp(cum_last - cum_j)
  float* Bs = Xw + BT * HD;          // [BT][DS4]: B rows of the tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = h / (a.nh / a.G);
  const float* xb = static_cast<const float*>(a.x) + n * a.sx[0] + h * a.sx[2];
  const float* Bb = static_cast<const float*>(a.B) + n * a.sb[0] + g * a.sb[2];

  chunk_cumsum(a, n, h, cum, dts);
  const float last = cum[cl - 1];

  constexpr int PP = HD / 16;        // state rows per thread: ty*PP + r
  float acc[PP][8];                  // state columns tx*4 + c + 64k
#pragma unroll
  for (int r = 0; r < PP; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < cl; j0 += BT) {
    __syncthreads();
    for (int e = tid; e < BT * HD; e += THREADS) {
      const int j = e / HD, p = e % HD;
      Xw[e] = j0 + j < cl ? xb[(j0 + j) * a.sx[1] + p] * dts[j0 + j] * expf(last - cum[j0 + j])
                          : 0.f;
    }
    for (int e = tid; e < BT * DS4; e += THREADS) {
      const int j = e / DS4, d = e % DS4;
      Bs[e] = (j0 + j < cl && d < ds) ? Bb[(j0 + j) * a.sb[1] + d] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < BT; ++j) {
      float xv[PP];
#pragma unroll
      for (int r = 0; r < PP; ++r) xv[r] = Xw[j * HD + ty * PP + r];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (tx * 4 + 64 * k >= DS4) continue;
        const float4 bv = *reinterpret_cast<const float4*>(Bs + j * DS4 + tx * 4 + 64 * k);
#pragma unroll
        for (int r = 0; r < PP; ++r) {
          acc[r][4 * k + 0] = fmaf(xv[r], bv.x, acc[r][4 * k + 0]);
          acc[r][4 * k + 1] = fmaf(xv[r], bv.y, acc[r][4 * k + 1]);
          acc[r][4 * k + 2] = fmaf(xv[r], bv.z, acc[r][4 * k + 2]);
          acc[r][4 * k + 3] = fmaf(xv[r], bv.w, acc[r][4 * k + 3]);
        }
      }
    }
  }

  float* st = a.states + (static_cast<long long>(n) * a.nh + h) * HD * ds;
#pragma unroll
  for (int r = 0; r < PP; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tx * 4 + (c % 4) + 64 * (c / 4);
      if (d < ds) st[(ty * PP + r) * ds + d] = acc[r][c];
    }
  if (tid == 0) a.decays[static_cast<long long>(n) * a.nh + h] = expf(last);
}

// grid (N * (row tiles + 1), nh): the last block of each chunk computes the
// state, the others one row tile each.
template <int HD>
__global__ void __launch_bounds__(THREADS) ssd_chunk_f32(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = (a.cl + BT - 1) / BT;
  const int n = blockIdx.x / (tiles + 1);
  const int t = blockIdx.x % (tiles + 1);
  const int h = blockIdx.y;
  if (t == tiles)
    state_tile<HD>(a, n, h, smem);
  else
    diag_tile<HD>(a, n, h, t * BT, smem);
}

template <int HD>
int launch_f32_hd(const Args& a, cudaStream_t st) {
  const int DS4 = (a.ds + 3) & ~3;
  const int diag = (2 * CL_MAX + 2 * DS4 * TLD + BT * HD + BT * TLD) * (int)sizeof(float);
  const int state = (2 * CL_MAX + BT * HD + BT * DS4) * (int)sizeof(float);
  const int smem = diag > state ? diag : state;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.cl + BT - 1) / BT;
  dim3 grid(a.N * (tiles + 1), a.nh);
  ssd_chunk_f32<HD><<<grid, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 16: return launch_f32_hd<16>(a, st);
    case 32: return launch_f32_hd<32>(a, st);
    case 64: return launch_f32_hd<64>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int TMAX = CL_MAX / BT;             // row (and key) tiles of a chunk, at most
constexpr int NPC_MAX = 4;                    // boxes of 32 state dims, at most (ds <= 128)
constexpr int STAGES = 8;                     // x tiles in the ring
constexpr int X_BYTES = BT * 64 * 2;          // an x tile: 64 positions x 64 head dims (8 KB)
constexpr int BOX_BYTES = BT * 32 * 2;        // a B or C box: 64 positions x 32 dims (4 KB)
constexpr int S_TILE = BT * BT * 4;           // an S tile in f32 (16 KB)
constexpr int S_OFF = 0;                      // both warpgroups' S tiles: T + 1 at most
constexpr int B_OFF = S_OFF + (TMAX + 1) * S_TILE;
constexpr int RING_OFF = B_OFF + TMAX * NPC_MAX * BOX_BYTES;
constexpr int C_OFF = RING_OFF + (STAGES / 2) * X_BYTES;   // C shares ring stages 4..7
constexpr int SCAN_STAGES = 3;                // heads whose scan is ready ahead
constexpr int SCAN_OFF = RING_OFF + STAGES * X_BYTES;
constexpr int SCAN_FLOATS = 3 * CL_MAX;       // one head's cum2, cjd, sc
constexpr int BAR_OFF = SCAN_OFF + SCAN_STAGES * SCAN_FLOATS * 4;
constexpr int SMEM_BF16 = BAR_OFF + (2 * STAGES + 2 + 2 * SCAN_STAGES) * 8 + 1024;  // + slack
static_assert(C_OFF + 2 * NPC_MAX * BOX_BYTES <= SCAN_OFF, "C fits in the ring's upper half");
static_assert(SMEM_BF16 <= 232448, "one block per SM");
constexpr float LOG2E = 1.4426950408889634f;

// The row tile of warpgroup w in the block of pair p: p and T-1-p; -1 when
// the pair is the middle tile of an odd T (warpgroup 1 has none).
__device__ __forceinline__ int row_tile(int p, int w, int T) {
  const int t = w == 0 ? p : T - 1 - p;
  return (w == 1 && t == p) ? -1 : t;
}

// The state pieces (32 state dims each) of slot `me` = 2 p + w, as a bit
// mask. They go out in adjacent pairs (one n64 pass; an odd last piece goes
// alone), each to the slot with the least work so far, ties to the lowest
// slot. The weights are relative per-head costs: 15 per live key tile of
// the slot's row tile (P and the two-term product), 8 per key tile of a
// pair's pass, 7 of a single piece's. At cl = 256, ds = 128 the pairs go
// to the row tiles 0 and 1. Every block computes the same assignment.
__device__ __forceinline__ unsigned piece_mask(int me, int T, int npairs, int npc) {
  int load[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int t = row_tile(s / 2, s % 2, T);
    load[s] = s >= 2 * npairs ? INT_MAX : (t < 0 ? 0 : 15 * (t + 1));
  }
  unsigned mask = 0;
  for (int q = 0; q < npc; q += 2) {
    const bool two = q + 1 < npc;
    int best = 0, bv = load[0];
#pragma unroll
    for (int s = 1; s < 4; ++s)
      if (load[s] < bv) {
        best = s;
        bv = load[s];
      }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s == best) load[s] += (two ? 8 : 7) * T;
    if (best == me) mask |= (two ? 3u : 1u) << q;
  }
  return mask;
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo, float hi) {
  return hopper::pack_bf16(__uint_as_float(v << 16) * lo, __uint_as_float(v & 0xffff0000u) * hi);
}

// Four f32 of one row from the accumulator pairs of n-block nb: lanes with
// an even lane % 4 take row r and columns 2(lane%4) .. +3 of the block, odd
// ones row r + 8 and columns 2(lane%4) - 2 .. +1. -> (column offset, row
// offset 0 or 8) and the values.
template <int R>
__device__ __forceinline__ float4 quad(const float (&d)[R], int nb, int lane, int& col, int& roff) {
  const bool odd = lane & 1;
  const float v0 = odd ? d[4 * nb] : d[4 * nb + 2];
  const float v1 = odd ? d[4 * nb + 1] : d[4 * nb + 3];
  const float u0 = __shfl_xor_sync(0xffffffffu, v0, 1);
  const float u1 = __shfl_xor_sync(0xffffffffu, v1, 1);
  col = 8 * nb + 2 * (lane % 4) - (odd ? 2 : 0);
  roff = odd ? 8 : 0;
  return odd ? make_float4(u0, u1, d[4 * nb + 2], d[4 * nb + 3])
             : make_float4(d[4 * nb], d[4 * nb + 1], u0, u1);
}

// One block per (chunk n, group g, head slice, pair p of row tiles), 384
// threads: a producer warpgroup (one thread issues TMA, one warp scans dt)
// and two consumer warpgroups, one row tile each. `tx`, `tb`, `tc` are the
// TMA maps of x, B and C; y, states and decays are contiguous f32.
__global__ void __launch_bounds__(384, 1)
ssd_chunk_bf16(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const float* __restrict__ dt,
               long long sd0, long long sd1, long long sd2, const float* __restrict__ A,
               float* __restrict__ y, float* __restrict__ states, float* __restrict__ decays,
               int cl, int nh, int hd, int G, int ds, int slices) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = base + BAR_OFF;              // STAGES barriers: x tile landed
  const uint32_t empty = full + 8 * STAGES;          // STAGES barriers: x tile consumed
  const uint32_t bc_full = empty + 8 * STAGES;       // B and C landed
  const uint32_t c_free = bc_full + 8;               // S computed: C's space is free
  const uint32_t scan_full = c_free + 8;             // SCAN_STAGES barriers: a head's scan is in
  const uint32_t scan_empty = scan_full + 8 * SCAN_STAGES;   // ... and has been read
  float* scan_buf = reinterpret_cast<float*>(gbase + SCAN_OFF);

  const int T = (cl + BT - 1) / BT, npairs = (T + 1) / 2, npc = (ds + 31) / 32;
  const int rep = nh / G;
  int bid = blockIdx.x;
  const int p = bid % npairs;
  bid /= npairs;
  const int slice = bid % slices;
  bid /= slices;
  const int g = bid % G;
  const int n = bid / G;
  const int h_lo = g * rep + slice * rep / slices;
  const int nheads = g * rep + (slice + 1) * rep / slices - h_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);
    }
    hopper::mbar_init(bc_full, 1);
    hopper::mbar_init(c_free, 8);
    for (int k = 0; k < SCAN_STAGES; ++k) {
      hopper::mbar_init(scan_full + 8 * k, 32);
      hopper::mbar_init(scan_empty + 8 * k, 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ----- producer: B (every key tile), C (the two row tiles), the x ring;
    // warp 1 scans dt A of each head into a ring of SCAN_STAGES buffers -----
    hopper::setmaxnreg_dec<56>();               // 128 x 56 + 256 x 224 <= 65536
    if (threadIdx.x == 0) {
      const int nrt = 1 + (row_tile(p, 1, T) >= 0);
      hopper::mbar_expect_tx(bc_full, (T + nrt) * npc * BOX_BYTES);
      for (int kt = 0; kt < T; ++kt)
        for (int q = 0; q < npc; ++q)
          hopper::tma_load_4d(base + B_OFF + (kt * NPC_MAX + q) * BOX_BYTES, &tb, bc_full,
                              32 * q, g, BT * kt, n);
      for (int w = 0; w < 2; ++w) {
        const int t = row_tile(p, w, T);
        if (t < 0) continue;
        for (int q = 0; q < npc; ++q)
          hopper::tma_load_4d(base + C_OFF + (w * NPC_MAX + q) * BOX_BYTES, &tc, bc_full,
                              32 * q, g, BT * t, n);
      }
      for (int u = 0; u < nheads * T; ++u) {
        const int s = u % STAGES;
        hopper::mbar_wait(empty + 8 * s, ((u / STAGES) & 1) ^ 1);
        if (u < STAGES && s >= STAGES / 2) hopper::mbar_wait(c_free, 0);
        hopper::mbar_expect_tx(full + 8 * s, X_BYTES);
        hopper::tma_load_4d(base + RING_OFF + s * X_BYTES, &tx, full + 8 * s, 0, h_lo + u / T,
                            BT * (u % T), n);
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // lane l takes positions 8l .. 8l+7 (dt = 0 past cl, so cum stays at
      // cum_last there). Per head: cum2 = cum log2(e) (the rows' side of the
      // decay), cjd = cum2 - log2(dt) (the columns' side, dt folded in:
      // exp2(cum2_i - cjd_j) = exp(cum_i - cum_j) dt_j, 0 where dt_j = 0) and
      // sc = dt exp(cum_last - cum) (the state's scale).
      const int lane = threadIdx.x - 32;
      const float* dtn = dt + n * sd0;
      for (int hi = 0; hi < nheads; ++hi) {
        const int h = h_lo + hi, k = hi % SCAN_STAGES;
        float d[8], c[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int j = 8 * lane + m;
          d[m] = j < cl ? __ldg(dtn + j * sd1 + h * sd2) : 0.f;
        }
        const float a = __ldg(A + h);
        float run = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          run += d[m] * a;
          c[m] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += o;
        }
        const float pre = incl - run;
        const float tot = __shfl_sync(0xffffffffu, incl, 31);
        hopper::mbar_wait(scan_empty + 8 * k, ((hi / SCAN_STAGES) & 1) ^ 1);
        float* buf = scan_buf + k * SCAN_FLOATS + 8 * lane;
#pragma unroll
        for (int m = 0; m < 8; m += 4) {          // four positions at a time
          float c2[4], cd[4], sc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c2[e] = (pre + c[m + e]) * LOG2E;
            cd[e] = c2[e] - __log2f(d[m + e]);
            sc[e] = d[m + e] * hopper::exp2_approx(tot * LOG2E - c2[e]);
          }
          *reinterpret_cast<float4*>(buf + m) = make_float4(c2[0], c2[1], c2[2], c2[3]);
          *reinterpret_cast<float4*>(buf + CL_MAX + m) = make_float4(cd[0], cd[1], cd[2], cd[3]);
          *reinterpret_cast<float4*>(buf + 2 * CL_MAX + m) = make_float4(sc[0], sc[1], sc[2], sc[3]);
        }
        if (p == 0 && lane == 0) decays[static_cast<long long>(n) * nh + h] = expf(tot);
        hopper::mbar_arrive(scan_full + 8 * k);
      }
    }
    return;
  }

  // ----- consumers: one row tile each, and their pieces of the state -----
  hopper::setmaxnreg_inc<224>();
  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int t = row_tile(p, w, T);
  const unsigned pieces = piece_mask(2 * p + w, T, npairs, npc);
  const int s_first = w == 0 ? 0 : row_tile(p, 0, T) + 1;     // this warpgroup's S tiles
  const float4* s_tiles = reinterpret_cast<const float4*>(gbase + S_OFF + s_first * S_TILE);
  const int r0 = 16 * warp + lane / 4;                         // accumulator rows r0, r0 + 8

  // S = C[row tile] B[key tile]^T for key tiles 0..t, stored as f32 in the
  // accumulators' order (float4 e4 of thread tid at [kt][e4][tid])
  hopper::mbar_wait(bc_full, 0);
  if (t >= 0) {
    for (int kt = 0; kt <= t; ++kt) {
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      for (int q = 0; q < npc; ++q) {
        hopper::fence_regs(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const uint64_t da = hopper::make_desc(
              base + C_OFF + (w * NPC_MAX + q) * BOX_BYTES + 32 * k2, 16, 512, 2);
          const uint64_t db = hopper::make_desc(
              base + B_OFF + (kt * NPC_MAX + q) * BOX_BYTES + 32 * k2, 16, 512, 2);
          hopper::wgmma_ss_n64<0>(s, da, db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
      }
      float4* dst = const_cast<float4*>(s_tiles) + kt * 8 * 128 + tid;
#pragma unroll
      for (int e4 = 0; e4 < 8; ++e4)
        dst[e4 * 128] = make_float4(s[4 * e4], s[4 * e4 + 1], s[4 * e4 + 2], s[4 * e4 + 3]);
    }
  }
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(c_free);

  auto x_tile = [&](int u) { return base + RING_OFF + (u % STAGES) * X_BYTES; };
  auto wait_x = [&](int u) { hopper::mbar_wait(full + 8 * (u % STAGES), (u / STAGES) & 1); };

  for (int hi = 0; hi < nheads; ++hi) {
    const int h = h_lo + hi;
    const int u0 = hi * T;                       // ring position of the head's key tile 0
    const int k = hi % SCAN_STAGES;              // the head's scan buffer
    hopper::mbar_wait(scan_full + 8 * k, (hi / SCAN_STAGES) & 1);
    const float* cum2 = scan_buf + k * SCAN_FLOATS;
    const float* cjd = cum2 + CL_MAX;
    const float* sc = cjd + CL_MAX;

    // ---- y of the row tile: Y = sum over key tiles kt <= t of P_kt x_kt ----
    if (t >= 0) {
      const int i0 = BT * t;
      const float ci0 = cum2[i0 + r0], ci1 = cum2[i0 + r0 + 8];
      float acc[32], pf[32];
      uint32_t ph[4][4], pl[4][4];          // P = ph + pl, each bf16
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;

      // P of key tile kt into pf: S * exp2(cum2_i - cjd_j) = S * exp(cum_i -
      // cum_j) * dt_j, the exponent replaced by -inf (so P = 0) above the
      // diagonal
      auto compute_p = [&](int kt) {
        const float4* src = s_tiles + kt * 8 * 128 + tid;
#pragma unroll
        for (int e4 = 0; e4 < 8; ++e4) {
          const float4 v = src[e4 * 128];
          pf[4 * e4] = v.x;
          pf[4 * e4 + 1] = v.y;
          pf[4 * e4 + 2] = v.z;
          pf[4 * e4 + 3] = v.w;
        }
        const bool diag = kt == t;
        const int j0 = BT * kt;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int jl = 8 * nb + 2 * (lane % 4);
          const float2 cj = *reinterpret_cast<const float2*>(cjd + j0 + jl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = (e >> 1) & 1, bb = e & 1;
            float x = (ri ? ci1 : ci0) - (bb ? cj.y : cj.x);
            if (diag && jl + bb > r0 + 8 * ri) x = __int_as_float(0xff800000);
            pf[4 * nb + e] *= hopper::exp2_approx(x);
          }
        }
      };
      // P in two bf16 terms: its rounding and the rounding of what that left
      auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float lo = pf[8 * kk + 2 * r], hi = pf[8 * kk + 2 * r + 1];
            const uint32_t v = hopper::pack_bf16(lo, hi);
            ph[kk][r] = v;
            pl[kk][r] = hopper::pack_bf16(lo - __uint_as_float(v << 16),
                                          hi - __uint_as_float(v & 0xffff0000u));
          }
      };
      // Y += (ph + pl) x of key tile kt (one product group)
      auto issue_px = [&](int kt) {
        const uint32_t xs = x_tile(u0 + kt);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = hopper::make_desc(xs + kk * 16 * 128, X_BYTES, 1024, 1);
          hopper::wgmma_rs_n64(acc, ph[kk], db);
          hopper::wgmma_rs_n64(acc, pl[kk], db);
        }
        hopper::wgmma_commit();
      };
      auto retire = [&]() {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(ph[kk]);
          hopper::fence_regs(pl[kk]);
        }
      };

      compute_p(0);
      pack_p();
      for (int kt = 0; kt < t; ++kt) {
        wait_x(u0 + kt);
        issue_px(kt);
        compute_p(kt + 1);                     // overlaps the product of tile kt
        retire();
        pack_p();
      }
      wait_x(u0 + t);
      issue_px(t);
      retire();

#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        int col, roff;
        const float4 v = quad(acc, nb, lane, col, roff);
        const int i = i0 + r0 + roff;
        if (i < cl && col < hd)
          *reinterpret_cast<float4*>(y + ((static_cast<long long>(n) * cl + i) * nh + h) * hd +
                                     col) = v;
      }
    }

    // ---- the state: D[p][d] = sum_j x~^T[p][j] B[j][d] over this warpgroup's
    // pieces of 32 state dims; two adjacent pieces make one n64 pass ----
    uint32_t xa[4][4], xr[4][4];
    // x^T of key tile kt in the A-fragment layout (rows = head dims p,
    // depth = positions j): ldmatrix.trans of the 128B-swizzled x tile;
    // lanes 8i..8i+7 address matrix i (p block 2 warp + (i & 1), j rows
    // 16 kk + 8 (i >> 1) + lane % 8)
    auto load_xt = [&](int kt) {
      const uint32_t xs = x_tile(u0 + kt);
      const int mi = lane >> 3, ch = 2 * warp + (mi & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int jl = 16 * kk + 8 * (mi >> 1) + (lane & 7);
        hopper::ldsm_x4_trans(xr[kk], xs + jl * 128 + ((ch ^ (jl & 7)) << 4));
      }
    };
    // x~ = x dt w in bf16: registers 0, 1 hold positions 2c, 2c + 1 of the
    // k-step, registers 2, 3 positions 2c + 8, 2c + 9
    auto scale_xt = [&](int kt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = BT * kt + 16 * kk + 2 * (lane % 4);
        const float2 s01 = *reinterpret_cast<const float2*>(sc + j);
        const float2 s89 = *reinterpret_cast<const float2*>(sc + j + 8);
        xa[kk][0] = scale_bf16x2(xr[kk][0], s01.x, s01.y);
        xa[kk][1] = scale_bf16x2(xr[kk][1], s01.x, s01.y);
        xa[kk][2] = scale_bf16x2(xr[kk][2], s89.x, s89.y);
        xa[kk][3] = scale_bf16x2(xr[kk][3], s89.x, s89.y);
      }
    };
    // state dims 32 q .. 32 q + W over the whole chunk (B boxes q, q + 1
    // lie BOX_BYTES apart, the descriptor's stride between 32-wide atoms)
    auto state_pass = [&](int q, auto width) {
      constexpr int W = decltype(width)::value;
      float sa[W / 2];
#pragma unroll
      for (int e = 0; e < W / 2; ++e) sa[e] = 0.f;
      auto issue_st = [&](int kt) {
        const uint32_t bs = base + B_OFF + (kt * NPC_MAX + q) * BOX_BYTES;
        hopper::fence_regs(sa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = hopper::make_desc(bs + kk * 16 * 64, BOX_BYTES, 512, 2);
          if constexpr (W == 64) hopper::wgmma_rs_n64(sa, xa[kk], db);
          else hopper::wgmma_rs_n32(sa, xa[kk], db);
        }
        hopper::wgmma_commit();
      };
      auto retire_st = [&]() {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sa);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(xa[kk]);
      };

      wait_x(u0);
      load_xt(0);
      scale_xt(0);
      for (int kt = 0; kt + 1 < T; ++kt) {
        issue_st(kt);
        wait_x(u0 + kt + 1);
        load_xt(kt + 1);                       // overlaps the product of tile kt
        retire_st();
        scale_xt(kt + 1);
      }
      issue_st(T - 1);
      retire_st();

#pragma unroll
      for (int nb = 0; nb < W / 8; ++nb) {
        int col, roff;
        const float4 v = quad(sa, nb, lane, col, roff);
        const int pr = r0 + roff, d = 32 * q + col;
        if (pr >= hd || d >= ds) continue;
        float* dst = states + ((static_cast<long long>(n) * nh + h) * hd + pr) * ds + d;
        if ((ds & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < ds) dst[e] = vv[e];
        }
      }
    };
    for (unsigned m = pieces; m != 0;) {
      const int q = __ffs(m) - 1;
      if ((m >> (q + 1)) & 1) {
        state_pass(q, std::integral_constant<int, 64>{});
        m &= ~(3u << q);
      } else {
        state_pass(q, std::integral_constant<int, 32>{});
        m &= ~(1u << q);
      }
    }

    // ---- release the head's x tiles and scan: each tile waited first (those
    // the products did not need too), so that the ring stays in order ----
    for (int kt = pieces != 0 ? T : t + 1; kt < T; ++kt) wait_x(u0 + kt);
    __syncwarp();
    if (lane < T) hopper::mbar_arrive(empty + 8 * ((u0 + lane) % STAGES));
    if (lane == 31) hopper::mbar_arrive(scan_empty + 8 * k);
  }
}

// A 4-D TMA map of a bf16 tensor (N, cl, heads, width) with outer strides
// s (elements), cut in boxes of `box` x 1 x 64 x 1. A stride of a dimension
// of size 1 is never used; it is replaced by one TMA takes.
bool map_4d(CUtensorMap* map, const void* ptr, const long long (&s)[3], int N, int cl, int heads,
            int width, int box) {
  const long long s2 = heads == 1 ? ((width + 7) & ~7) : s[2];
  const long long s1 = cl == 1 ? s2 * heads : s[1];
  const long long s0 = N == 1 ? s1 * cl : s[0];
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads, (cuuint64_t)cl,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)s2 * 2, (cuuint64_t)s1 * 2, (cuuint64_t)s0 * 2};
  const cuuint32_t boxd[4] = {(cuuint32_t)box, 1, (cuuint32_t)BT, 1};
  return hopper_host::encode_bf16(map, ptr, 4, dims, strides, boxd);
}

int launch_bf16(const Args& a, cudaStream_t st) {
  CUtensorMap tx, tb, tc;
  if (!map_4d(&tx, a.x, a.sx, a.N, a.cl, a.nh, a.hd, 64) ||
      !map_4d(&tb, a.B, a.sb, a.N, a.cl, a.G, a.ds, 32) ||
      !map_4d(&tc, a.C, a.sc, a.N, a.cl, a.G, a.ds, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // split each group's heads into as many slices as fill the SMs
  const int T = (a.cl + BT - 1) / BT, npairs = (T + 1) / 2, rep = a.nh / a.G;
  const long long blocks = static_cast<long long>(a.N) * a.G * npairs;
  long long slices = sms / blocks;
  slices = slices < 1 ? 1 : (slices > rep ? rep : slices);
  if (blocks * slices >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ssd_chunk_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BF16);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_bf16<<<static_cast<unsigned>(blocks * slices), 384, SMEM_BF16, st>>>(
      tx, tb, tc, a.dt, a.sd[0], a.sd[1], a.sd[2], a.A, a.y, a.states, a.decays, a.cl, a.nh,
      a.hd, a.G, a.ds, static_cast<int>(slices));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, cl, nh, hd); B, C: (N, cl, G, ds), each with unit stride on its
// last axis and the three outer strides given; dt: (N, cl, nh) f32 with its
// three strides; A: contiguous (nh,) f32. Outputs, contiguous f32: y (N, cl,
// nh, hd), states (N, nh, hd, ds), decays (N, nh). Requires 1 <= cl <= 256,
// hd in {16, 32, 64}, 1 <= ds <= 128 and nh % G == 0 (the wrapper checks).
// dtype (of x, B, C): 0 = float32, 1 = bfloat16 (whose pointers must be
// 16-byte aligned and strides of dimensions longer than 1 multiples of 8
// elements, as TMA takes them). Returns cudaGetLastError() after the launch.
extern "C" int repro_ssd_intra_chunk(const void* x, long long sx0, long long sx1, long long sx2,
                                     const float* dt, long long sd0, long long sd1,
                                     long long sd2, const float* A, const void* B,
                                     long long sb0, long long sb1, long long sb2,
                                     const void* C, long long sc0, long long sc1,
                                     long long sc2, float* y, float* states, float* decays,
                                     int N, int cl, int nh, int hd, int G, int ds, int dtype,
                                     void* stream) {
  if (cl < 1 || cl > CL_MAX || ds < 1 || ds > 128 || G < 1 || nh % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, B, C, dt, A, {sx0, sx1, sx2}, {sb0, sb1, sb2}, {sc0, sc1, sc2},
               {sd0, sd1, sd2}, y, states, decays, N, cl, nh, G, ds, hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, st);
  if (dtype == 1) {
    if (hd != 16 && hd != 32 && hd != 64) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
