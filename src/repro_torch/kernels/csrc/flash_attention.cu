// Blocked (flash-style) GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention). For every batch b, query
// head h and query position i:
//     o[b,i,h] = sum_j softmax_j(q[b,i,h] . k[b,j,h/(H/K)] / sqrt(hd)) v[b,j,h/(H/K)]
// over the keys j allowed by the mask: causal (j <= i), sliding window
// (j > i - window) or none. Masked scores are the FINITE -1e30, as on the
// TPU, and a masked key adds nothing to its row; a row with no live key
// outputs 0 (l == 0).
//
// Bound on the H100: 4*B*H*(live pairs)*hd operations, with live pairs =
// S(S+1)/2 under the causal mask, against reading q, k, v and writing o
// once. At the training shape (B=8, H=16, K=8, S=1024, hd=64) it is
// compute-bound (about 340 operations per byte in bf16).
//
// Both routes read the model's (B, S, H, hd) q and (B, S, K, hd) k/v in
// place through their strides and map query head h to KV head h / (H/K):
// K/V are never repeated in memory (the JAX wrapper repeats them with
// jnp.repeat). Key tiles wholly outside the causal or window band are not
// visited.
//
// bf16 (the training dtype): wgmma + TMA, warp-specialised.
//   * Work items are (query tile of TQ=128 rows, head, batch). The grid is
//     persistent (one block per SM); the host gives each block its list of
//     items, longest first onto the least-loaded block, so that the causal
//     tiles' unequal work evens out. Three warpgroups: a producer (one
//     thread issues TMA) and two consumers of 64 query rows each.
//   * TMA descriptors are 4-D over (hd, heads, S, B) with the tensors' own
//     byte strides, built on the host per call. Q tiles go into two
//     buffers, so the next item's Q lands while this one runs; K and V
//     tiles of TK keys (128, or 64 for hd >= 128) stream through a ring of
//     STAGES buffers guarded by full (TMA bytes) and empty (8 consumer
//     warps) mbarriers, across items. Rows past S load as zeros; key
//     columns >= Sk are masked.
//   * S = Q.K^T by wgmma m64nTKk16 with both operands in shared memory
//     (K-major). The online softmax (base 2, the 1/sqrt(hd) scale folded
//     into one FMA, max and sum over four partial chains) runs on the f32
//     accumulators in registers; only tiles that cross the diagonal, the
//     window edge or Sk take the masked variant (on the causal diagonal
//     alone, one compare of a constant against a per-thread threshold per
//     score), and where the causal
//     diagonal leaves the tile's second half past every row of the
//     warpgroup, that half is set to 0 unread. P is converted to bf16 in
//     registers and is the register A operand of O += P.V (wgmma
//     m64nNk16, N = min(hd, 64), V MN-major through the transpose bit).
//   * Overlap: on its turn (named barriers, ping-pong between the two
//     consumers) a warpgroup issues S of tile t+1 and P.V of tile t as two
//     groups; the softmax of tile t+1 then runs while P.V of tile t and
//     the other warpgroup's products occupy the tensor cores. Every group
//     is issued unconditionally (the item's last tile is peeled): a group
//     issued under a condition that ptxas cannot match with its wait makes
//     it serialise every wgmma of the kernel.
//   * Swizzle: each TMA box is min(hd, 64) wide, so its rows are 128, 64
//     or 32 bytes and use the 128B, 64B or 32B swizzle, which the wgmma
//     descriptors name too; hd = 128 takes two 64-wide boxes per tile.
//   * Output: O / l in bf16 goes into the item's Q buffer in the TMA box
//     layout and leaves by one TMA store per warpgroup (rows past S are
//     dropped); the buffer is released once the store has read it.
//   * hd = 256 (Gemma3): a 64 x 256 f32 O would take 128 of the 168
//     registers a consumer thread has, and the kernel spills. So the host
//     launches the kernel twice, each time for one 128-wide half of V and
//     O (template DV = 128) with the whole 256-wide Q.K^T: S is computed
//     twice, O and its registers are those of hd = 128. Those launches
//     keep one Q buffer and three stages (208 KB of shared memory).
//   * f32: CUDA cores, no TF32 (the `--precision f32` comparison path).
//     hd/32 threads share a query row (one for hd = 16), each owning
//     min(hd, 32) of its dimensions; K and V tiles staged in shared memory.
//
// What bounds it now is the softmax (its exp, max and sum on the CUDA
// cores and SFU), not the products or the loads. Left for later: a
// cheaper softmax, crossing items without a pipeline drain, and a backward
// kernel (the backward recomputes the plain attention in torch).
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;       // f32 route: query rows per block
constexpr int BK = 64;       // f32 route: keys per tile
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int TQ = 128;      // query rows per work item (two consumer warpgroups)
constexpr float LOG2E = 1.4426950408889634f;

// HD: the width of q and k; DV: of v and o (DV < HD only for hd = 256,
// one half of v a launch).
template <int HD, int DV = HD> struct Tile {
  static constexpr int TK = HD >= 128 ? 64 : 128;     // keys per tile
  static constexpr int CW = HD < 64 ? HD : 64;        // columns of one TMA box
  static constexpr int NB = HD / CW;                  // Q and K boxes per tile row
  static constexpr int NBV = DV / CW;                 // V and O boxes per tile row
  static constexpr int ROWB = CW * 2;                 // bytes of a box row
  static constexpr int SW = hopper::Swizzle<ROWB>::code;
  // >= 3: a warpgroup may run a tile ahead of the other
  static constexpr int STAGES = DV < HD ? 3 : 4;
  static constexpr int NQ = DV < HD ? 1 : 2;          // Q buffers
  static constexpr int QBOX = TQ * ROWB;              // bytes of one Q box
  static constexpr int KBOX = TK * ROWB;              // bytes of one K or V box
  static constexpr int Q_BYTES = NB * QBOX;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NQ * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * NB * KBOX;
  static constexpr int BAR_OFF = V_OFF + STAGES * NBV * KBOX;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 2 * NQ) * 8 + 1024;   // + alignment slack
};

template <int N>
__device__ __forceinline__ void s_mma(float (&s)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) hopper::wgmma_ss_n128<0>(s, da, db, acc);
  else hopper::wgmma_ss_n64<0>(s, da, db, acc);
}

template <int N>
__device__ __forceinline__ void pv_mma(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) hopper::wgmma_rs_n64(o, a, db);
  else if constexpr (N == 32) hopper::wgmma_rs_n32(o, a, db);
  else hopper::wgmma_rs_n16(o, a, db);
}

// One work item: a query tile of one (head, batch) and its key tiles
// [kt0, kt0 + ntiles), at least one. Items run heaviest first: the query
// tile is the slowest index, from the last tile down.
struct Work {
  int q0, h, b, kt0, ntiles;
};

__device__ __forceinline__ Work work_item(int item, int n_qt, int H, int B, int Sq, int Sk,
                                          int causal, int window, int TK) {
  Work w;
  const int hb = item % (H * B);
  w.q0 = (n_qt - 1 - item / (H * B)) * TQ;
  w.h = hb % H;
  w.b = hb / H;
  const int q_last = min(w.q0 + TQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;           // exclusive
  const int k_lo = window > 0 ? max(0, w.q0 - window + 1) : 0;
  w.kt0 = k_lo / TK;
  w.ntiles = (k_hi + TK - 1) / TK - w.kt0;
  if (w.ntiles <= 0) {            // no live key (a window past Sk): one tile, all masked
    w.kt0 = 0;
    w.ntiles = 1;
  }
  return w;
}

// Persistent, 384 threads. Block i takes the items
// sched[grid + 1 + sched[i]] .. sched[grid + 1 + sched[i + 1] - 1], in
// that order (the host balances the blocks' lists). `to` maps the
// contiguous (B, Sq, H, HD) output.
template <int HD, int DV>
__global__ void __launch_bounds__(384, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
               const int* __restrict__ sched, int B, int Sq, int Sk, int H, int KH, int causal,
               int window, float scale_log2) {
  using T = Tile<HD, DV>;
  constexpr int TK = T::TK, CW = T::CW, NB = T::NB, NBV = T::NBV, ROWB = T::ROWB;
  constexpr int STAGES = T::STAGES, NQ = T::NQ;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + T::Q_OFF, k_s = base + T::K_OFF, v_s = base + T::V_OFF;
  const uint32_t full = base + T::BAR_OFF;             // STAGES barriers: K/V tile landed
  const uint32_t empty = full + 8 * STAGES;            // STAGES barriers: K/V tile consumed
  const uint32_t q_full = empty + 8 * STAGES;          // NQ barriers
  const uint32_t q_empty = q_full + 8 * NQ;            // NQ barriers
  const int n_qt = (Sq + TQ - 1) / TQ;
  const int* order = sched + gridDim.x + 1;            // this block's items: order[k0 .. k1)
  const int k0 = sched[blockIdx.x], k1 = sched[blockIdx.x + 1];

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);
    }
    for (int s = 0; s < NQ; ++s) {
      hopper::mbar_init(q_full + 8 * s, 1);
      hopper::mbar_init(q_empty + 8 * s, 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ----- producer warpgroup: one thread keeps Q and the K/V ring full -----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int ring = 0;
      for (int kk = k0, j = 0; kk < k1; ++kk, ++j) {
        const Work w = work_item(order[kk], n_qt, H, B, Sq, Sk, causal, window, TK);
        const int kvh = w.h / (H / KH);
        const int qb = j % NQ;
        hopper::mbar_wait(q_empty + 8 * qb, ((j / NQ) & 1) ^ 1);
        hopper::mbar_expect_tx(q_full + 8 * qb, TQ * HD * 2);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_4d(q_s + qb * T::Q_BYTES + nb * T::QBOX, &tq, q_full + 8 * qb,
                              nb * CW, w.h, w.q0, w.b);
        for (int t = 0; t < w.ntiles; ++t, ++ring) {
          const int s = ring % STAGES;
          const int k0 = (w.kt0 + t) * TK;
          hopper::mbar_wait(empty + 8 * s, ((ring / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(full + 8 * s, TK * (HD + DV) * 2);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            hopper::tma_load_4d(k_s + (s * NB + nb) * T::KBOX, &tk, full + 8 * s, nb * CW,
                                kvh, k0, w.b);
#pragma unroll
          for (int nb = 0; nb < NBV; ++nb)
            hopper::tma_load_4d(v_s + (s * NBV + nb) * T::KBOX, &tv, full + 8 * s, nb * CW,
                                kvh, k0, w.b);
        }
      }
    }
    return;
  }

  // ----- consumer warpgroups: 64 query rows each -----
  hopper::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  // ping-pong: a warpgroup issues its products only on its turn (named
  // barrier 1 + wg) and then hands the turn over, so that one warpgroup's
  // softmax runs while the other's products occupy the tensor cores
  if (wg == 1) hopper::bar_arrive(1, 256);

  // the state of the item in hand
  int kk = k0, j = 0, ring = 0;
  Work w = work_item(kk < k1 ? order[kk] : 0, n_qt, H, B, Sq, Sk, causal, window, TK);
  int qb = 0, qw0 = 0, r0 = 0;
  uint32_t q_wg = 0;
  int stored_qb = -1;              // Q buffer that thread 0's last O store reads

  float acc[NBV][CW / 2];
  float m[2], l[2], corr[2];
  float sc[TK / 2];                // S of a tile, then its P in f32
  uint32_t pa[TK / 16][4];         // P in bf16, the A operand of P.V

  // Q of this CTA's j-th item: wait for it; -> the warpgroup's rows in smem
  auto q_rows = [&](int jj) {
    hopper::mbar_wait(q_full + 8 * (jj % NQ), (jj / NQ) & 1);
    return q_s + (jj % NQ) * T::Q_BYTES + wg * 64 * ROWB;
  };
  auto start_item = [&]() {
    qb = j % NQ;
    qw0 = w.q0 + wg * 64;
    r0 = qw0 + warp * 16 + lane / 4;                   // this thread's rows r0, r0 + 8
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
      for (int e = 0; e < CW / 2; ++e) acc[nb][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG;
      l[i] = 0.f;
      corr[i] = 1.f;
    }
  };

  // K and V of ring position `pos` have landed (waited before the turn)
  auto wait_kv = [&](int pos) { hopper::mbar_wait(full + 8 * (pos % STAGES), (pos / STAGES) & 1); };

  // S = Q K^T of ring position `pos` into sc (one product group)
  auto issue_s = [&](int pos, uint32_t qa) {
    const int st = pos % STAGES;
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int nb = ks * 16 / CW, kofs = (ks * 16 % CW) * 2;
      const uint64_t da = hopper::make_desc(qa + nb * T::QBOX + kofs, 16, 8 * ROWB, T::SW);
      const uint64_t db = hopper::make_desc(k_s + (st * NB + nb) * T::KBOX + kofs, 16,
                                            8 * ROWB, T::SW);
      s_mma<TK>(sc, da, db, ks > 0);
    }
    hopper::wgmma_commit();
  };

  // Online softmax of the item's tile t (S landed in sc): scale (base 2,
  // folded into one FMA with the max), mask where the tile crosses an
  // edge; leaves P in sc, the rescale factor of O in corr, sums in l.
  // HALF: keys from TK/2 on lie past every row of this warpgroup (the
  // causal diagonal), so only the first half of the tile is live
  auto softmax_body = [&](auto edge_c, auto half_c) {
    constexpr bool EDGE = decltype(edge_c)::value;
    constexpr int LIVE = decltype(half_c)::value ? TK / 4 : TK / 2;
    float pm[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pm[i][c] = NEG;
#pragma unroll
    for (int e = 0; e < LIVE; ++e)
      pm[(e >> 1) & 1][(e >> 2) & 3] = fmaxf(pm[(e >> 1) & 1][(e >> 2) & 3], sc[e]);
    float mn[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(pm[i][0], pm[i][1]), fmaxf(pm[i][2], pm[i][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mn[i] = fmaxf(m[i], mx * scale_log2);
      corr[i] = hopper::exp2_approx(m[i] - mn[i]);
      m[i] = mn[i];
    }
    float ps[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int e = LIVE; e < TK / 2; ++e) sc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < LIVE; ++e) {
      const int i = (e >> 1) & 1;
      float p = hopper::exp2_approx(fmaf(sc[e], scale_log2, -mn[i]));
      if constexpr (EDGE) p = sc[e] == NEG ? 0.f : p;
      ps[i][(e >> 2) & 3] += p;
      sc[e] = p;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = l[i] * corr[i] + ((ps[i][0] + ps[i][1]) + (ps[i][2] + ps[i][3]));
  };

  auto softmax = [&](int t) {
    hopper::fence_regs(sc);
    const int k0 = (w.kt0 + t) * TK;
    const bool edge = (k0 + TK > Sk) || (causal && k0 + TK - 1 > qw0) ||
                      (window > 0 && k0 <= qw0 + 63 - window);
    if (edge) {
      if (window <= 0 && k0 + TK <= Sk) {
        // the causal diagonal alone: col - row is a constant of e minus thr
        const int thr = r0 - k0 - 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < TK / 2; ++e)
          if (8 * (e >> 2) + (e & 1) - 8 * ((e >> 1) & 1) > thr) sc[e] = NEG;
      } else {
#pragma unroll
        for (int e = 0; e < TK / 2; ++e) {
          const int row = r0 + 8 * ((e >> 1) & 1);
          const int col = k0 + 8 * (e >> 2) + 2 * (lane % 4) + (e & 1);
          bool live = col < Sk;
          if (causal) live = live && col <= row;
          if (window > 0) live = live && col > row - window;
          if (!live) sc[e] = NEG;
        }
      }
      if (causal && k0 + TK / 2 > qw0 + 63)
        softmax_body(std::true_type{}, std::true_type{});
      else
        softmax_body(std::true_type{}, std::false_type{});
    } else {
      softmax_body(std::false_type{}, std::false_type{});
    }
  };

  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  // O *= corr: O rescaled for the latest softmax, with no P.V in flight
  auto rescale = [&]() {
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
      for (int e = 0; e < CW / 2; ++e) acc[nb][e] *= corr[(e >> 1) & 1];
  };

  // O += P_t V_t (one product group)
  auto issue_pv = [&](int t) {
    const int st = (ring + t) % STAGES;
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) hopper::fence_regs(acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb) {
        const uint64_t db = hopper::make_desc(v_s + (st * NBV + nb) * T::KBOX + kk * 16 * ROWB,
                                              T::KBOX, 8 * ROWB, T::SW);
        pv_mma<CW>(acc[nb], pa[kk], db);
      }
    hopper::wgmma_commit();
  };

  // P_t V_t is done: free tile t's K/V stage
  auto retire_pv = [&](int t) {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) hopper::fence_regs(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) hopper::fence_regs(pa[kk]);
    if (lane == 0) hopper::mbar_arrive(empty + 8 * ((ring + t) % STAGES));
  };

  // O / l in bf16 into this warpgroup's rows of the item's Q buffer (its
  // last S is done), in the TMA box layout and swizzle, then one TMA store.
  // Warps 1-3 free the Q buffer at once, warp 0 once the store has read it.
  auto finish_item = [&]() {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
      for (int e = 0; e < CW / 2; e += 2) {
        const int i = (e >> 1) & 1;
        const uint32_t off =
            (warp * 16 + lane / 4 + 8 * i) * ROWB + (8 * (e >> 2) + 2 * (lane % 4)) * 2;
        hopper::st_shared_u32(q_wg + nb * T::QBOX + (off ^ (((off >> 7) & (ROWB / 16 - 1)) << 4)),
                              hopper::pack_bf16(acc[nb][e] * inv[i], acc[nb][e + 1] * inv[i]));
      }
    hopper::fence_async();
    hopper::bar_sync(3 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb)
        hopper::tma_store_4d(&to, q_wg + nb * T::QBOX, nb * CW, w.h, qw0, w.b);
      hopper::bulk_commit();
      stored_qb = qb;
    } else if (lane == 0) {
      hopper::mbar_arrive(q_empty + 8 * qb);
    }
  };

  // Per item: S of tile 0 and its softmax, then for each tile t, on this
  // warpgroup's turn, S of tile t+1 and P.V of tile t; the softmax of tile
  // t+1 overlaps P.V. The last tile is peeled, so that every product issue
  // is unconditional (a group issued under a condition that ptxas cannot
  // match with its wait makes it serialise all of them). O is rescaled
  // once P.V of the previous tile is done, outside the turn.
  while (kk < k1) {
    if (tid == 0 && stored_qb >= 0) {
      hopper::bulk_wait_read();
      hopper::mbar_arrive(q_empty + 8 * stored_qb);
      stored_qb = -1;
    }
    start_item();
    q_wg = q_rows(j);
    wait_kv(ring);
    hopper::bar_sync(1 + wg, 256);
    issue_s(ring, q_wg);
    hopper::bar_arrive(2 - wg, 256);
    hopper::wgmma_wait<0>();
    softmax(0);
    pack_p();
    for (int t = 0; t + 1 < w.ntiles; ++t) {
      wait_kv(ring + t + 1);
      hopper::bar_sync(1 + wg, 256);
      issue_s(ring + t + 1, q_wg);
      issue_pv(t);
      hopper::bar_arrive(2 - wg, 256);
      hopper::wgmma_wait<1>();
      softmax(t + 1);
      retire_pv(t);
      rescale();
      pack_p();
    }
    hopper::bar_sync(1 + wg, 256);
    issue_pv(w.ntiles - 1);
    hopper::bar_arrive(2 - wg, 256);
    retire_pv(w.ntiles - 1);
    finish_item();
    ring += w.ntiles;
    ++kk;
    ++j;
    if (kk < k1) w = work_item(order[kk], n_qt, H, B, Sq, Sk, causal, window, TK);
  }
  if (tid == 0) hopper::bulk_wait();
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
  const int* sched;   // bf16: the blocks' work lists, for a grid of `grid` blocks
  int grid;
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

// A 4-D TMA descriptor over (W, heads, S, B) of a bf16 tensor whose outer
// strides (elements) are s[0] (batch), s[1] (position), s[2] (head), from
// p + off elements: W columns of each row, in boxes min(W, 64) wide.
template <int W>
bool attn_map(CUtensorMap* map, const void* p, long long off, const long long (&s)[3], int S,
              int heads, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s[2] * 2, (cuuint64_t)s[1] * 2,
                                 (cuuint64_t)s[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(W < 64 ? W : 64), 1, (cuuint32_t)rows, 1};
  return hopper_host::encode_bf16(map, static_cast<const char*>(p) + off * 2, 4, dims, strides,
                                  box);
}

// One launch: o[..., off : off + DV] from q, k and v[..., off : off + DV].
template <int HD, int DV>
int launch_bf16(const Args& a, long long off, cudaStream_t st) {
  using T = Tile<HD, DV>;
  CUtensorMap tq, tk, tv, to;
  const long long so[3] = {(long long)a.Sq * a.H * HD, (long long)a.H * HD, HD};
  if (!attn_map<HD>(&tq, a.q, 0, a.sq, a.Sq, a.H, a.B, TQ) ||
      !attn_map<HD>(&tk, a.k, 0, a.sk, a.Sk, a.KH, a.B, T::TK) ||
      !attn_map<DV>(&tv, a.v, off, a.sv, a.Sk, a.KH, a.B, T::TK) ||
      !attn_map<DV>(&to, a.o, off, so, a.Sq, a.H, a.B, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<HD, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.sched == nullptr || a.grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = a.grid;
  flash_fwd_bf16<HD, DV><<<grid, 384, T::SMEM, st>>>(
      tq, tk, tv, to, a.sched, a.B, a.Sq, a.Sk, a.H, a.KH, a.causal, a.window,
      LOG2E / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const Args& a, int dtype, cudaStream_t st) {
  if (dtype == 0) return launch_f32<HD>(a, st);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (HD == 256) {       // two launches, one 128-wide half of v and o each
    const int err = launch_bf16<256, 128>(a, 0, st);
    return err != 0 ? err : launch_bf16<256, 128>(a, 128, st);
  } else {
    return launch_bf16<HD, HD>(a, 0, st);
  }
}

}  // namespace

// hd: 16, 32, 64, 128 or 256 (bf16: two launches, see above).
// q: (B, Sq, H, hd), k/v: (B, Sk, KH, hd), each with unit stride on hd and
// the three outer strides given; o: contiguous (B, Sq, H, hd) of q's dtype.
// window <= 0 means no window. dtype: 0 = float32, 1 = bfloat16 (whose
// strides must be multiples of 8 elements and pointers 16-byte aligned,
// as TMA takes them; `sched` is then the work lists of `grid` blocks:
// grid + 1 offsets, then the items; float32 ignores both).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_fwd(const void* q, long long sq0, long long sq1,
                                         long long sq2, const void* k, long long sk0,
                                         long long sk1, long long sk2, const void* v,
                                         long long sv0, long long sv1, long long sv2,
                                         void* o, int B, int Sq, int Sk, int H, int KH,
                                         int hd, int causal, int window, int dtype,
                                         const int* sched, int grid, void* stream) {
  const Args a{q, k, v, o, {sq0, sq1, sq2}, {sk0, sk1, sk2}, {sv0, sv1, sv2},
               B, Sq, Sk, H, KH, causal, window, sched, grid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, dtype, st);
    case 32: return launch<32>(a, dtype, st);
    case 64: return launch<64>(a, dtype, st);
    case 128: return launch<128>(a, dtype, st);
    case 256: return launch<256>(a, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
