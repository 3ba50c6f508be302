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
// Design (simple first):
//   * A block owns BN=128 tokens and one contiguous range of vocab tiles
//     of BV=128 columns. On the TPU one grid row sweeps the whole vocab in
//     order; here the sweep is split over `nsplit` blocks per token tile so
//     that the grid fills the 132 SMs (N=8192 gives only 64 token tiles).
//     Each block writes its partial (max, sumexp, gold) and a second,
//     one-thread-per-token kernel folds the partials. Partials whose range
//     held only masked columns carry max = -1e30 and are washed out by
//     exp(-1e30 - max) = 0, the same finite-sentinel rule the TPU kernel
//     relies on.
//   * The TPU kernel keeps the whole (bn, d) h tile resident in VMEM. At
//     d = 1024 that does not fit in shared memory, so the depth is looped
//     in chunks of BD=32 staged in shared memory.
//   * bf16 (the training dtype): tensor cores through mma.sync m16n8k16
//     with f32 accumulation. 8 warps, each a 32x64 piece of the 128x128
//     logits tile. h must have unit stride along d; W is taken either as a
//     (d, Vp) row-major head or as the transposed view of a (Vp, d)
//     embedding (a tied head, no 64 MB copy per loss): the staging loop
//     writes both into one [vocab][depth] layout in shared memory.
//   * f32: the same tiling on the CUDA cores (each of 256 threads holds an
//     8x8 block of the logits tile), through any strides, so that f32 is
//     not rounded to TF32.
//
// Left for later: cp.async/TMA double buffering of the staged chunks,
// wgmma with a deeper pipeline, and a fused backward.
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BN = 128;      // tokens per block
constexpr int BV = 128;      // vocab columns per tile
constexpr int BD = 32;       // depth chunk staged in shared memory
constexpr int THREADS = 256;
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
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int LDS = BD + 8;  // bf16 per shared row: 80 bytes, 16-byte aligned, conflict-free

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid (ceil(N/BN), nsplit); partial[3][nsplit][N] = (max, sumexp, gold).
// h: unit stride on d, rows sh0 apart. W: w_kmajor ? element (k, v) at
// k + v*sw1 (transposed embedding) : at k*sw0 + v. 16-byte aligned rows.
__global__ void __launch_bounds__(THREADS)
xent_partial_bf16(const __nv_bfloat16* __restrict__ h, long long sh0,
                  const __nv_bfloat16* __restrict__ w, long long sw0, long long sw1,
                  int w_kmajor, const int* __restrict__ labels, float* __restrict__ partial,
                  int N, int d, int Vp, int vocab, int tiles_per_split) {
  __shared__ __align__(16) __nv_bfloat16 hs[BN * LDS];   // [token][depth]
  __shared__ __align__(16) __nv_bfloat16 ws[BV * LDS];   // [vocab][depth]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp % 4;                 // tokens wr*32 .. +31 of the tile
  const int wc = warp / 4;                 // columns wc*64 .. +63 of the tile
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int n_vt = (Vp + BV - 1) / BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_vt);

  // this thread's 4 token rows: wr*32 + mi*16 + hi*8 + g, r = 2*mi + hi
  int lbl[4];
  float m[4], s[4], gold[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = n0 + wr * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
    lbl[r] = row < N ? labels[row] : -1;
    m[r] = NEG; s[r] = 0.f; gold[r] = 0.f;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BD) {
      __syncthreads();
      for (int e = threadIdx.x; e < BN * (BD / 8); e += THREADS) {
        const int r = e / (BD / 8), c = (e % (BD / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (n0 + r < N && k0 + c < d)
          val = *reinterpret_cast<const uint4*>(h + (n0 + r) * sh0 + k0 + c);
        *reinterpret_cast<uint4*>(hs + r * LDS + c) = val;
      }
      if (w_kmajor) {              // W[:, v] contiguous along depth
        for (int e = threadIdx.x; e < BV * (BD / 8); e += THREADS) {
          const int v = e / (BD / 8), c = (e % (BD / 8)) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (v0 + v < Vp && k0 + c < d)
            val = *reinterpret_cast<const uint4*>(w + (v0 + v) * sw1 + k0 + c);
          *reinterpret_cast<uint4*>(ws + v * LDS + c) = val;
        }
      } else {                     // W[k, :] contiguous along vocab: transpose
        for (int e = threadIdx.x; e < BD * (BV / 8); e += THREADS) {
          const int k = e % BD, v = (e / BD) * 8;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (k0 + k < d && v0 + v < Vp)
            val = *reinterpret_cast<const uint4*>(w + (k0 + k) * sw0 + v0 + v);
          const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
          for (int i = 0; i < 8; ++i) ws[(v + i) * LDS + k] = p[i];
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BD / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* hp = hs + (wr * 32 + mi * 16 + g) * LDS + kk * 16 + 2 * t;
          a[mi][0] = lds32(hp);
          a[mi][1] = lds32(hp + 8 * LDS);
          a[mi][2] = lds32(hp + 8);
          a[mi][3] = lds32(hp + 8 * LDS + 8);
        }
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const __nv_bfloat16* wp = ws + (wc * 64 + nj * 8 + g) * LDS + kk * 16 + 2 * t;
          const uint32_t b0 = lds32(wp), b1 = lds32(wp + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][nj], a[mi], b0, b1);
        }
      }
    }

    // fold this warp's 32x64 piece of the logits tile into its online
    // (max, sumexp, gold); the four lanes of a quad share each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int mi = r >> 1, hi = r & 1;
      float tmax = NEG;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + wc * 64 + nj * 8 + 2 * t + e;
          const float x = col < vocab ? acc[mi][nj][2 * hi + e] : NEG;
          acc[mi][nj][2 * hi + e] = x;
          tmax = fmaxf(tmax, x);
          if (col == lbl[r]) gold[r] += x;
        }
      const float m_new = fmaxf(m[r], max4(tmax));
      float part = 0.f;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) part += expf(acc[mi][nj][2 * hi + e] - m_new);
      s[r] = s[r] * expf(m[r] - m_new) + part;
      m[r] = m_new;
    }
  }

  // quad sums, then the two column halves meet in shared memory
  float* red = reinterpret_cast<float*>(hs);     // BN x 3 floats
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s[r] = sum4(s[r]);
    gold[r] = sum4(gold[r]);
    const int lr = wr * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
    if (wc == 1 && t == 0) {
      red[lr * 3 + 0] = m[r];
      red[lr * 3 + 1] = s[r];
      red[lr * 3 + 2] = gold[r];
    }
  }
  __syncthreads();
  if (wc == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = wr * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
      const int row = n0 + lr;
      if (row >= N) continue;
      const float m1 = red[lr * 3 + 0];
      const float mx = fmaxf(m[r], m1);
      partial[(0 * nsplit + split) * (long long)N + row] = mx;
      partial[(1 * nsplit + split) * (long long)N + row] =
          s[r] * expf(m[r] - mx) + red[lr * 3 + 1] * expf(m1 - mx);
      partial[(2 * nsplit + split) * (long long)N + row] = gold[r] + red[lr * 3 + 2];
    }
  }
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
// dtype 0 = float32 (any strides); dtype 1 = bfloat16, which needs
// sh1 == 1 and sw0 == 1 or sw1 == 1, with 16-byte aligned rows (the
// wrapper checks). Returns cudaGetLastError() after the launches.
extern "C" int repro_fused_xent_fwd(const void* h, long long sh0, long long sh1,
                                    const void* w, long long sw0, long long sw1,
                                    const int* labels, float* out, float* partial,
                                    int N, int d, int Vp, int vocab, int nsplit,
                                    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_vt = (Vp + BV - 1) / BV;
  const int tiles_per_split = (n_vt + nsplit - 1) / nsplit;
  dim3 grid((N + BN - 1) / BN, nsplit);
  if (dtype == 0) {
    xent_partial_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(h), sh0, sh1, static_cast<const float*>(w), sw0, sw1, labels,
        partial, N, d, Vp, vocab, tiles_per_split);
  } else if (dtype == 1) {
    if (sh1 != 1 || (sw0 != 1 && sw1 != 1)) return static_cast<int>(cudaErrorInvalidValue);
    xent_partial_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), sh0, static_cast<const __nv_bfloat16*>(w), sw0,
        sw1, sw0 == 1 ? 1 : 0, labels, partial, N, d, Vp, vocab, tiles_per_split);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_combine<<<(N + 255) / 256, 256, 0, st>>>(partial, out, N, nsplit);
  return static_cast<int>(cudaGetLastError());
}
