// Blocked (flash-style) GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention). For every batch b, query
// head h and query position i:
//     o[b,i,h] = sum_j softmax_j(q[b,i,h] . k[b,j,h/(H/K)] / sqrt(hd)) v[b,j,h/(H/K)]
// over the keys j allowed by the mask: causal (j <= i), sliding window
// (j > i - window) or none. Masked scores are the FINITE -1e30, as on the
// TPU: a fully masked tile then gives exp(-1e30 - -1e30) = 1 terms that the
// next live tile washes out with corr = exp(-1e30 - m) = 0, where -inf
// would give NaN. A row with no live key at all outputs 0 (l == 0).
//
// Bound on the H100: 4*B*H*(live pairs)*hd operations, with live pairs =
// S(S+1)/2 under the causal mask, against reading q, k, v and writing o
// once. At the training shape (B=8, H=16, K=8, S=1024, hd=64) it is
// compute-bound (about 340 operations per byte in bf16).
//
// Design (simple first):
//   * One block per (query tile of BQ=64 rows, head, batch). It reads the
//     model's (B, S, H, hd) q and (B, S, K, hd) k/v in place through their
//     strides and maps query head h to KV head h / (H/K): K/V are never
//     repeated in memory (the JAX wrapper repeats them with jnp.repeat).
//     Key tiles of BK=64 wholly outside the causal or window band are not
//     visited.
//   * bf16 (the training dtype): tensor cores through mma.sync m16n8k16,
//     four warps of 16 query rows each. q stays in registers as A
//     fragments; K and V tiles are staged in shared memory as bf16 with
//     16-byte loads; S = q.k^T and O += P.V accumulate in f32, and P is
//     re-packed from the S accumulators into bf16 A fragments in registers.
//     Online softmax (m, l) in f32 per row, shared by the four lanes of a
//     quad.
//   * f32: the same tiling on the CUDA cores. hd/32 threads share a query
//     row (one for hd = 16), each owning min(hd, 32) of its dimensions;
//     K and V tiles staged in shared memory as f32.
//
// Left for later: wgmma and TMA, double-buffered K/V tiles, and a backward
// kernel (the backward recomputes the plain attention in torch).
#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int HD> struct MmaShape {
  static constexpr int LDS = HD + 8;                // bf16 per shared row (16-byte pad)
  static constexpr int SMEM = 2 * BK * LDS * 2;     // K and V tiles, bytes
};

// q (B,Sq,H,HD), k/v (B,Sk,KH,HD): unit stride on HD, other strides and the
// pointers 16-byte aligned (the wrapper checks). o contiguous (B,Sq,H,HD).
template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, long long sq0, long long sq1, long long sq2,
               const __nv_bfloat16* __restrict__ k, long long sk0, long long sk1, long long sk2,
               const __nv_bfloat16* __restrict__ v, long long sv0, long long sv1, long long sv2,
               __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KH, int causal,
               int window, float scale) {
  constexpr int LDS = MmaShape<HD>::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BK * LDS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int r0 = q0 + warp * 16 + g;     // this lane's two query rows
  const int r1 = r0 + 8;

  // q as A fragments, straight from device memory
  uint32_t qf[HD / 16][4];
  const __nv_bfloat16* qb = q + b * sq0 + h * sq2;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < Sq ? ld32(qb + r0 * sq1 + c) : 0u;
    qf[kk][1] = r1 < Sq ? ld32(qb + r1 * sq1 + c) : 0u;
    qf[kk][2] = r0 < Sq ? ld32(qb + r0 * sq1 + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ld32(qb + r1 * sq1 + c + 8) : 0u;
  }

  float of[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) of[dn][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;          // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const __nv_bfloat16* kb = k + b * sk0 + kvh * sk2;
  const __nv_bfloat16* vb = v + b * sv0 + kvh * sv2;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * (HD / 8); e += 128) {
      const int j = e / (HD / 8), c = (e % (HD / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + j < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + j) * sk1 + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + j) * sv1 + c);
      }
      *reinterpret_cast<uint4*>(ks + j * LDS + c) = kv;
      *reinterpret_cast<uint4*>(vs + j * LDS + c) = vv;
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows and the tile's 64 keys
    float sf[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[nt][e] = 0.f;
      const __nv_bfloat16* kp = ks + (nt * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_bf16(sf[nt], qf[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }

    // mask, scale and the online softmax; elements 0,1 are row r0, 2,3 row r1
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        bool live = col < Sk;
        if (causal) live = live && col <= row;
        if (window > 0) live = live && col > row - window;
        const float x = live ? sf[nt][e] * scale : NEG;
        sf[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      of[dn][0] *= c0; of[dn][1] *= c0;
      of[dn][2] *= c1; of[dn][3] *= c1;
    }
    m0 = mn0;
    m1 = mn1;

    // P, re-packed from the S accumulators as bf16 A fragments (keys 16kk..)
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = expf(sf[nt][0] - mn0), p1 = expf(sf[nt][1] - mn0);
      const float p2 = expf(sf[nt][2] - mn1), p3 = expf(sf[nt][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[nt / 2][(nt % 2) * 2 + 0] = pack2(p0, p1);
      pf[nt / 2][(nt % 2) * 2 + 1] = pack2(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const __nv_bfloat16* vp = vs + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        const uint32_t b0 = pack2(vp[dn * 8], vp[dn * 8 + LDS]);
        const uint32_t b1 = pack2(vp[dn * 8 + 8 * LDS], vp[dn * 8 + 9 * LDS]);
        mma_bf16(of[dn], pf[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o + (((long long)b * Sq + r0) * H + h) * HD + c) =
          pack2(of[dn][0] * inv0, of[dn][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(o + (((long long)b * Sq + r1) * H + h) * HD + c) =
          pack2(of[dn][2] * inv1, of[dn][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
template <int HD> struct Shape {
  static constexpr int DPT = HD < 32 ? HD : 32;     // dims per thread
  static constexpr int TPR = HD / DPT;              // threads per query row
  static constexpr int THREADS = BQ * TPR;
  static constexpr int LD = TPR * (DPT + 1);        // padded smem row
  static constexpr int SMEM = 2 * BK * LD * (int)sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
flash_fwd_f32(const float* __restrict__ q, long long sq0, long long sq1, long long sq2,
              const float* __restrict__ k, long long sk0, long long sk1, long long sk2,
              const float* __restrict__ v, long long sv0, long long sv1, long long sv2,
              float* __restrict__ o, int Sq, int Sk, int H, int KH, int causal,
              int window, float scale) {
  using S = Shape<HD>;
  constexpr int DPT = S::DPT, TPR = S::TPR, LD = S::LD;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qpos = q0 + row;
  const bool row_ok = qpos < Sq;

  float qr[DPT], acc[DPT];
  const float* qp = q + b * sq0 + (long long)(row_ok ? qpos : 0) * sq1 + h * sq2 + part * DPT;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = row_ok ? qp[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG, l = 0.f;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;          // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float* kb = k + b * sk0 + kvh * sk2;
  const float* vb = v + b * sv0 + kvh * sv2;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * HD; e += S::THREADS) {
      const int j = e / HD, dd = e % HD;
      const int at = j * LD + (dd / DPT) * (DPT + 1) + dd % DPT;
      const bool ok = k0 + j < Sk;
      ks[at] = ok ? kb[(long long)(k0 + j) * sk1 + dd] : 0.f;
      vs[at] = ok ? vb[(long long)(k0 + j) * sv1 + dd] : 0.f;
    }
    __syncthreads();

    float sc[BK];
    float tmax = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float* kr = ks + j * LD + part * (DPT + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) dot = fmaf(qr[d], kr[d], dot);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kpos = k0 + j;
      bool live = kpos < Sk;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && kpos > qpos - window;
      sc[j] = live ? dot * scale : NEG;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
      const float* vr = vs + j * LD + part * (DPT + 1);
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float safe = l > 0.f ? l : 1.f;
    float* op = o + (((long long)b * Sq + qpos) * H + h) * HD + part * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) op[d] = acc[d] / safe;
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  long long sq[3], sk[3], sv[3];
  int B, Sq, Sk, H, KH, causal, window;
};

template <int HD>
int launch_f32(const Args& a, cudaStream_t st) {
  using S = Shape<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_f32<HD><<<grid, S::THREADS, S::SMEM, st>>>(
      static_cast<const float*>(a.q), a.sq[0], a.sq[1], a.sq[2],
      static_cast<const float*>(a.k), a.sk[0], a.sk[1], a.sk[2],
      static_cast<const float*>(a.v), a.sv[0], a.sv[1], a.sv[2], static_cast<float*>(a.o),
      a.Sq, a.Sk, a.H, a.KH, a.causal, a.window, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t st) {
  constexpr int SMEM = MmaShape<HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  using bf = __nv_bfloat16;
  flash_fwd_bf16<HD><<<grid, 128, SMEM, st>>>(
      static_cast<const bf*>(a.q), a.sq[0], a.sq[1], a.sq[2],
      static_cast<const bf*>(a.k), a.sk[0], a.sk[1], a.sk[2],
      static_cast<const bf*>(a.v), a.sv[0], a.sv[1], a.sv[2], static_cast<bf*>(a.o),
      a.Sq, a.Sk, a.H, a.KH, a.causal, a.window, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const Args& a, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_f32<HD>(a, st);
  if (dtype == 1) return launch_bf16<HD>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Sk, KH, hd), each with unit stride on hd and
// the three outer strides given; o: contiguous (B, Sq, H, hd) of q's dtype.
// window <= 0 means no window. dtype: 0 = float32, 1 = bfloat16 (whose
// strides must be multiples of 8 elements and pointers 16-byte aligned).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(const void* q, long long sq0, long long sq1,
                                         long long sq2, const void* k, long long sk0,
                                         long long sk1, long long sk2, const void* v,
                                         long long sv0, long long sv1, long long sv2,
                                         void* o, int B, int Sq, int Sk, int H, int KH,
                                         int hd, int causal, int window, int dtype,
                                         void* stream) {
  const Args a{q, k, v, o, {sq0, sq1, sq2}, {sk0, sk1, sk2}, {sv0, sv1, sv2},
               B, Sq, Sk, H, KH, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, dtype, st);
    case 32: return launch<32>(a, dtype, st);
    case 64: return launch<64>(a, dtype, st);
    case 128: return launch<128>(a, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
