// Mamba2 SSD intra-chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_intra_chunk). For every chunk n (one chunk
// of one sequence, cl <= 256 positions) and head h, with
// cum = cumsum_m(dt[m] * A[h]) over the chunk and g = h / (nh / G):
//     y[n,i,h,:]    = sum_{j <= i} (C[n,i,g,:] . B[n,j,g,:]) exp(cum_i - cum_j) x[n,j,h,:] dt[j]
//     states[n,h]   = sum_j exp(cum_last - cum_j) (x[n,j,h,:] dt[j]) (outer) B[n,j,g,:]
//     decays[n,h]   = exp(cum_last)
// x, B, C in f32 or bf16, dt and A in f32; everything is computed and
// written in f32. The decay exp(cum_i - cum_j) is evaluated only where
// j <= i and zero is SELECTED elsewhere: for j > i the exponent is positive
// and can overflow, and a 0/1 mask times inf would give NaN.
//
// Bound on the H100: per (chunk, head), cl(cl+1)/2 live (i, j) pairs of
// 2(ds + hd) operations each plus 2 cl hd ds for the state, against reading
// x, B, C, dt once and writing y, states, decays once. At the training shape
// (32 chunks of 256, 32 heads of 64, ds 128, one group) that is about 17.2
// GFLOP against 140 MB: bound by bytes in bf16 on the tensor cores' rate,
// by operations at the f32 rate this kernel runs at.
//
// Design (simple first):
//   * B and C are read in their own (N, cl, G, ds) layout through their
//     strides, head h mapping to group h / (nh / G): they are never repeated
//     to every head in memory (the JAX wrapper repeats them). C.B^T is still
//     recomputed for every head of a group.
//   * One block of 256 threads per (row tile of 64 positions, head, chunk),
//     plus one block per (head, chunk) for the chunk state and decay. Every
//     block first scans dt * A over the whole chunk in shared memory.
//   * A row-tile block keeps its C rows in shared memory, transposed, and
//     walks the key tiles j0 <= i0 like a causal attention without softmax:
//     S = C B^T (4 x 4 per thread from float4 reads of the transposed C and
//     B tiles), P = S * decay written transposed to shared memory, then
//     Y += P (x dt) with Y kept in registers.
//   * The state block walks the chunk in tiles of 64 positions and
//     accumulates (x dt w)^T B, hd x ds, in registers.
//   * f32 FMAs on the CUDA cores for both input types; bf16 inputs are
//     widened as they are staged.
//
// Left for later: tensor cores (mma.sync / wgmma) for the bf16 path, TMA
// staging and double buffering, C.B^T shared by the heads of a group, and a
// backward kernel (the backward differentiates the plain ssd_chunked in
// torch, as the JAX package differentiates its reference).
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CL_MAX = 256;       // longest chunk; also the scan's width
constexpr int BT = 64;            // positions per row tile and per key tile
constexpr int THREADS = 256;      // 16 x 16
constexpr int TLD = BT + 4;       // floats per row of a transposed tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void *x, *B, *C;
  const float *dt, *A;
  long long sx[3], sb[3], sc[3], sd[3];   // outer strides; the last axis is unit
  float *y, *states, *decays;
  int N, cl, nh, G, ds;
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
template <typename T, int HD>
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
  const T* xb = static_cast<const T*>(a.x) + n * a.sx[0] + h * a.sx[2];
  const T* Bb = static_cast<const T*>(a.B) + n * a.sb[0] + g * a.sb[2];
  const T* Cb = static_cast<const T*>(a.C) + n * a.sc[0] + g * a.sc[2];

  chunk_cumsum(a, n, h, cum, dts);
  for (int e = tid; e < BT * DS4; e += THREADS) {
    const int i = e / DS4, d = e % DS4;
    Ct[d * TLD + i] = (i0 + i < cl && d < ds) ? to_f(Cb[(i0 + i) * a.sc[1] + d]) : 0.f;
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
      Bt[d * TLD + j] = (j0 + j < cl && d < ds) ? to_f(Bb[(j0 + j) * a.sb[1] + d]) : 0.f;
    }
    for (int e = tid; e < BT * HD; e += THREADS) {
      const int j = e / HD, p = e % HD;
      Xs[e] = j0 + j < cl ? to_f(xb[(j0 + j) * a.sx[1] + p]) * dts[j0 + j] : 0.f;
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
template <typename T, int HD>
__device__ void state_tile(const Args& a, int n, int h, float* smem) {
  const int ds = a.ds, DS4 = (ds + 3) & ~3, cl = a.cl;
  float* cum = smem;
  float* dts = cum + CL_MAX;
  float* Xw = dts + CL_MAX;          // [BT][HD]:  x * dt * exp(cum_last - cum_j)
  float* Bs = Xw + BT * HD;          // [BT][DS4]: B rows of the tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int g = h / (a.nh / a.G);
  const T* xb = static_cast<const T*>(a.x) + n * a.sx[0] + h * a.sx[2];
  const T* Bb = static_cast<const T*>(a.B) + n * a.sb[0] + g * a.sb[2];

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
      Xw[e] = j0 + j < cl
                  ? to_f(xb[(j0 + j) * a.sx[1] + p]) * dts[j0 + j] * expf(last - cum[j0 + j])
                  : 0.f;
    }
    for (int e = tid; e < BT * DS4; e += THREADS) {
      const int j = e / DS4, d = e % DS4;
      Bs[e] = (j0 + j < cl && d < ds) ? to_f(Bb[(j0 + j) * a.sb[1] + d]) : 0.f;
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
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = (a.cl + BT - 1) / BT;
  const int n = blockIdx.x / (tiles + 1);
  const int t = blockIdx.x % (tiles + 1);
  const int h = blockIdx.y;
  if (t == tiles)
    state_tile<T, HD>(a, n, h, smem);
  else
    diag_tile<T, HD>(a, n, h, t * BT, smem);
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t st) {
  const int DS4 = (a.ds + 3) & ~3;
  const int diag = (2 * CL_MAX + 2 * DS4 * TLD + BT * HD + BT * TLD) * (int)sizeof(float);
  const int state = (2 * CL_MAX + BT * HD + BT * DS4) * (int)sizeof(float);
  const int smem = diag > state ? diag : state;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.cl + BT - 1) / BT;
  dim3 grid(a.N * (tiles + 1), a.nh);
  ssd_chunk_kernel<T, HD><<<grid, THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (N, cl, nh, hd); B, C: (N, cl, G, ds), each with unit stride on its
// last axis and the three outer strides given; dt: (N, cl, nh) f32 with its
// three strides; A: contiguous (nh,) f32. Outputs, contiguous f32: y (N, cl,
// nh, hd), states (N, nh, hd, ds), decays (N, nh). Requires 1 <= cl <= 256,
// hd in {16, 32, 64}, 1 <= ds <= 128 and nh % G == 0 (the wrapper checks).
// dtype (of x, B, C): 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch.
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
               {sd0, sd1, sd2}, y, states, decays, N, cl, nh, G, ds};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, hd, st);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
