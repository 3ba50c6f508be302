// Fused softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_xent/kernel.py
// (_xent_kernel, launched by fused_xent). Per token i:
//     nll[i] = logsumexp_j(h[i] . W[:, j]) - h[i] . W[:, label[i]]
// with the columns j >= vocab_size set to -1e30, WITHOUT writing the
// (N, Vp) logits to device memory: each block keeps an online
// (max, sumexp, gold) triple per token in registers while it sweeps its
// vocab tiles.
//
// Bound on the H100: 2*N*d*Vp operations against N*d + d*Vp input
// elements, so at the training shape (N=8192, d=1024, Vp=32768) it is
// compute-bound by a wide margin (about 6500 operations per byte in bf16).
//
// Both routes: a block owns BN=128 tokens and one contiguous range of vocab
// tiles of BV=128 columns. On the TPU one grid row sweeps the whole vocab
// in order; here the sweep is split over `nsplit` blocks per token tile so
// that the grid fills the 132 SMs (N=8192 gives only 64 token tiles; the
// wrapper chooses nsplit). Each block writes its partial (max, sumexp,
// gold) and a second, one-thread-per-token kernel folds the partials.
// Partials whose range held only masked columns carry max = -1e30 and are
// washed out by exp(-1e30 - max) = 0, the same finite-sentinel rule the
// TPU kernel relies on. The TPU kernel keeps the whole (bn, d) h tile
// resident in VMEM; at d = 1024 that does not fit in shared memory, so the
// depth is looped in chunks.
//
// bf16 (the training dtype): a Hopper GEMM mainloop whose epilogue is the
// online (max, sumexp, gold) update in place of a store.
//   * Three warpgroups: a producer (one thread issues TMA) and two
//     consumers of 64 tokens each. The depth goes in chunks of BKD=64
//     through a ring of XSTAGES buffers (h chunk 128x64, W chunk 64x128,
//     128B swizzle) guarded by full/empty mbarriers; the ring runs on
//     across vocab tiles, so the next tile's loads overlap this tile's
//     epilogue. Rows, depth and columns outside the tensors load as zeros.
//   * Each consumer accumulates its 64x128 logits tile with wgmma
//     m64n128k16 from shared memory, keeping one product group in flight.
//   * W in either layout without a copy: the untied (d, Vp) row-major head
//     is an MN-major B operand (two 64-column TMA boxes, the transpose
//     bit); the transposed view of a tied (Vp, d) embedding is a K-major B
//     operand (one 128x64 box). The kernel is instantiated for each.
//   * Epilogue: each thread tests its own accumulator columns against
//     vocab_size (-1e30) and the label, and folds them into its rows'
//     triples with exp2 (log2(e) folded into one FMA).
//   * f32: the same tiling on the CUDA cores (each of 256 threads holds an
//     8x8 block of the logits tile), depth chunks of BD=32 in shared
//     memory, through any strides, so that f32 is not rounded to TF32.
//
// Left for later: 128x256 tiles or a persistent grid, and a fused backward.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 128;      // tokens per block
constexpr int BV = 128;      // vocab columns per tile
constexpr int BD = 32;       // f32 route: depth chunk staged in shared memory
constexpr int THREADS = 256; // f32 route
constexpr float NEG = -1e30f;

__device__ __forceinline__ float max4(float v) {   // over the 4 lanes of a quad
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float max16(float v) {  // over 16 consecutive lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int BKD = 64;                   // depth per stage: one 128-byte row
constexpr int XSTAGES = 4;
constexpr int H_BYTES = BN * BKD * 2;     // 16 KB: h chunk [token][depth]
constexpr int W_BYTES = BKD * BV * 2;     // 16 KB: W chunk
constexpr int STAGE_BYTES = H_BYTES + W_BYTES;
constexpr int XSMEM = XSTAGES * STAGE_BYTES + 2 * XSTAGES * 8 + 1024;
constexpr float LOG2E = 1.4426950408889634f;

// grid (ceil(N/BN), nsplit), 384 threads; partial[3][nsplit][N] =
// (max, sumexp, gold). KMAJOR: W is the transposed view of a (Vp, d)
// embedding (th over (d, N), tw over (d, Vp)); else a (d, Vp) row-major
// head (tw over (Vp, d)).
template <bool KMAJOR>
__global__ void __launch_bounds__(384, 1)
xent_partial_bf16(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
                  const int* __restrict__ labels, float* __restrict__ partial, int N, int d,
                  int vocab, int n_vt, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + XSTAGES * STAGE_BYTES;
  const uint32_t empty = full + 8 * XSTAGES;

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_vt);
  const int nk = (d + BKD - 1) / BKD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < XSTAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ----- producer warpgroup -----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int vt = vt_begin; vt < vt_end; ++vt)
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % XSTAGES;
          const uint32_t hs = base + s * STAGE_BYTES, ws = hs + H_BYTES;
          hopper::mbar_wait(empty + 8 * s, ((it / XSTAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          hopper::tma_load_2d(hs, &th, full + 8 * s, kc * BKD, n0);
          if constexpr (KMAJOR) {
            hopper::tma_load_2d(ws, &tw, full + 8 * s, kc * BKD, vt * BV);
          } else {
            hopper::tma_load_2d(ws, &tw, full + 8 * s, vt * BV, kc * BKD);
            hopper::tma_load_2d(ws + W_BYTES / 2, &tw, full + 8 * s, vt * BV + 64, kc * BKD);
          }
        }
    }
    return;
  }

  // ----- consumer warpgroups: 64 tokens each -----
  hopper::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int r0 = n0 + wg * 64 + warp * 16 + lane / 4;   // rows r0, r0 + 8

  int lbl[2];
  float m[2], sum[2], gold[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lbl[i] = row < N ? labels[row] : -1;
    m[i] = NEG; sum[i] = 0.f; gold[i] = 0.f;
  }

  int it = 0;
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[BV / 2];
#pragma unroll
    for (int e = 0; e < BV / 2; ++e) acc[e] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % XSTAGES;
      const uint32_t hs = base + s * STAGE_BYTES + wg * (H_BYTES / 2), ws = base + s * STAGE_BYTES + H_BYTES;
      hopper::mbar_wait(full + 8 * s, (it / XSTAGES) & 1);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKD / 16; ++ks) {
        const uint64_t da = hopper::make_desc(hs + ks * 32, 16, 1024, 1);
        if constexpr (KMAJOR) {
          const uint64_t db = hopper::make_desc(ws + ks * 32, 16, 1024, 1);
          hopper::wgmma_ss_n128<0>(acc, da, db, kc > 0 || ks > 0);
        } else {
          const uint64_t db = hopper::make_desc(ws + ks * 2048, W_BYTES / 2, 1024, 1);
          hopper::wgmma_ss_n128<1>(acc, da, db, kc > 0 || ks > 0);
        }
      }
      hopper::wgmma_commit();
      // keep this chunk's products in flight; the previous chunk's are done
      hopper::wgmma_wait<1>();
      hopper::fence_regs(acc);
      if (kc > 0 && lane == 0) hopper::mbar_arrive(empty + 8 * ((it - 1) % XSTAGES));
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(empty + 8 * ((it - 1) % XSTAGES));

    // fold this 64x128 logits tile into the rows' online (max, sumexp, gold);
    // the four lanes of a quad share each row
    const bool edge = v0 + BV > vocab;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int n = 0; n < BV / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * i + j;
          const int col = v0 + 8 * n + 2 * q + j;
          float x = acc[e];
          if (edge && col >= vocab) x = NEG;
          acc[e] = x;
          if (col == lbl[i]) gold[i] += x;
          tmax = fmaxf(tmax, x);
        }
      const float m_new = fmaxf(m[i], max4(tmax));
      const float ml = m_new * LOG2E;
      float part = 0.f;
#pragma unroll
      for (int n = 0; n < BV / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) part += exp2f(fmaf(acc[4 * n + 2 * i + j], LOG2E, -ml));
      sum[i] = sum[i] * exp2f(fmaf(m[i], LOG2E, -ml)) + part;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float s = sum4(sum[i]), g = sum4(gold[i]);
    const int row = r0 + 8 * i;
    if (q == 0 && row < N) {
      partial[(0 * nsplit + split) * (long long)N + row] = m[i];
      partial[(1 * nsplit + split) * (long long)N + row] = s;
      partial[(2 * nsplit + split) * (long long)N + row] = g;
    }
  }
}

template <bool KMAJOR>
int launch_bf16(const void* h, long long sh0, const void* w, long long w_rows, const int* labels,
                float* partial, int N, int d, int Vp, int vocab, int n_vt, int tiles_per_split,
                int nsplit, cudaStream_t st) {
  CUtensorMap th, tw;
  const cuuint64_t h_dims[2] = {(cuuint64_t)d, (cuuint64_t)N};
  const cuuint64_t h_strides[1] = {(cuuint64_t)sh0 * 2};
  const cuuint32_t h_box[2] = {BKD, BN};
  const cuuint64_t w_dims[2] = {KMAJOR ? (cuuint64_t)d : (cuuint64_t)Vp,
                                KMAJOR ? (cuuint64_t)Vp : (cuuint64_t)d};
  const cuuint64_t w_strides[1] = {(cuuint64_t)w_rows * 2};
  const cuuint32_t w_box[2] = {KMAJOR ? (cuuint32_t)BKD : 64u,
                               KMAJOR ? (cuuint32_t)BV : (cuuint32_t)BKD};
  if (!hopper_host::encode_bf16(&th, h, 2, h_dims, h_strides, h_box) ||
      !hopper_host::encode_bf16(&tw, w, 2, w_dims, w_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(xent_partial_bf16<KMAJOR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, XSMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, nsplit);
  xent_partial_bf16<KMAJOR><<<grid, 384, XSMEM, st>>>(th, tw, labels, partial, N, d, vocab, n_vt,
                                                      tiles_per_split);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, any strides
// ---------------------------------------------------------------------------
constexpr int TM = 8;        // tokens per thread
constexpr int TV = 8;        // columns per thread

// dst[k][x] = src[(x0 + x) * sx + (k0 + k) * sk], zero outside the array.
template <int X>
__device__ __forceinline__ void stage(float (*dst)[X + 1], const float* __restrict__ src,
                                      long long sx, long long sk, int x0, int xmax,
                                      int k0, int kmax) {
  const bool k_fast = (sk == 1);
  for (int e = threadIdx.x; e < BD * X; e += THREADS) {
    int k, x;
    if (k_fast) { k = e % BD; x = e / BD; } else { x = e % X; k = e / X; }
    const int gx = x0 + x, gk = k0 + k;
    dst[k][x] = (gx < xmax && gk < kmax) ? src[gx * sx + gk * sk] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
xent_partial_f32(const float* __restrict__ h, long long sh0, long long sh1,
                 const float* __restrict__ w, long long sw0, long long sw1,
                 const int* __restrict__ labels, float* __restrict__ partial,
                 int N, int d, int Vp, int vocab, int tiles_per_split) {
  __shared__ float hs[BD][BN + 1];
  __shared__ float ws[BD][BV + 1];

  const int tx = threadIdx.x % (BV / TV);   // column group: cols tx + 16 j
  const int ty = threadIdx.x / (BV / TV);   // row group: rows ty + 16 i
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int n_vt = (Vp + BV - 1) / BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_vt);

  int lbl[TM];
  float m[TM], s[TM], g[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = n0 + ty + 16 * i;
    lbl[i] = row < N ? labels[row] : -1;
    m[i] = NEG; s[i] = 0.f; g[i] = 0.f;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[TM][TV];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TV; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BD) {
      __syncthreads();
      stage<BN>(hs, h, sh0, sh1, n0, N, k0, d);
      stage<BV>(ws, w, sw1, sw0, v0, Vp, k0, d);
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BD; ++k) {
        float a[TM], b[TV];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = hs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TV; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TV; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // fold this 128x128 logits tile into the online (max, sumexp, gold)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < TV; ++j) {
        const int col = v0 + tx + 16 * j;
        const float x = col < vocab ? acc[i][j] : NEG;
        acc[i][j] = x;
        tmax = fmaxf(tmax, x);
        if (col == lbl[i]) g[i] += x;
      }
      const float m_new = fmaxf(m[i], max16(tmax));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < TV; ++j) part += expf(acc[i][j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + sum16(part);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float gold = sum16(g[i]);
    const int row = n0 + ty + 16 * i;
    if (tx == 0 && row < N) {
      partial[(0 * nsplit + split) * (long long)N + row] = m[i];
      partial[(1 * nsplit + split) * (long long)N + row] = s[i];
      partial[(2 * nsplit + split) * (long long)N + row] = gold;
    }
  }
}

__global__ void xent_combine(const float* __restrict__ partial, float* __restrict__ out,
                             int N, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = NEG;
  for (int p = 0; p < nsplit; ++p) mx = fmaxf(mx, partial[(long long)p * N + row]);
  float s = 0.f, g = 0.f;
  for (int p = 0; p < nsplit; ++p) {
    s += partial[(long long)(nsplit + p) * N + row] *
         expf(partial[(long long)p * N + row] - mx);
    g += partial[(long long)(2 * nsplit + p) * N + row];
  }
  out[row] = logf(s) + mx - g;
}

}  // namespace

// h: (N, d) with strides (sh0, sh1); w: (d, Vp) with strides (sw0, sw1);
// labels (N,) int32; out (N,) f32; partial: 3 * nsplit * N f32 scratch.
// Block y of the grid sweeps vocab tiles [y * per, min((y + 1) * per,
// n_vt)) with per = ceil(n_vt / nsplit) and n_vt = ceil(Vp / 128).
// dtype 0 = float32 (any strides); dtype 1 = bfloat16, which needs
// sh1 == 1 and sw0 == 1 or sw1 == 1, with 16-byte aligned rows (the
// wrapper checks; TMA refuses anything else). Returns cudaGetLastError()
// after the launches.
extern "C" int repro_fused_xent_fwd(const void* h, long long sh0, long long sh1,
                                    const void* w, long long sw0, long long sw1,
                                    const int* labels, float* out, float* partial,
                                    int N, int d, int Vp, int vocab, int nsplit,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_vt = (Vp + BV - 1) / BV;
  const int tiles_per_split = (n_vt + nsplit - 1) / nsplit;
  int err;
  if (dtype == 0) {
    dim3 grid((N + BN - 1) / BN, nsplit);
    xent_partial_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(h), sh0, sh1, static_cast<const float*>(w), sw0, sw1, labels,
        partial, N, d, Vp, vocab, tiles_per_split);
    err = static_cast<int>(cudaGetLastError());
  } else if (dtype == 1) {
    if (sh1 != 1 || (sw0 != 1 && sw1 != 1)) return static_cast<int>(cudaErrorInvalidValue);
    err = sw0 == 1 ? launch_bf16<true>(h, sh0, w, sw1, labels, partial, N, d, Vp, vocab, n_vt,
                                       tiles_per_split, nsplit, st)
                   : launch_bf16<false>(h, sh0, w, sw0, labels, partial, N, d, Vp, vocab, n_vt,
                                        tiles_per_split, nsplit, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  xent_combine<<<(N + 255) / 256, 256, 0, st>>>(partial, out, N, nsplit);
  return static_cast<int>(cudaGetLastError());
}
