// Dense policy/value tower forward inside the self-play search.
//
// Replaces: the in-kernel forward of alphazero_tpu/search/pallas_fused.py
// (_dense_forward / _dense_forward_2x / _leaf_eval, run inside
// _chunk_kernel for the root and every simulation's leaf, and inside
// _move_kernel).  Semantics are the Pallas kernel's: input = [obs,
// W_linesᵀ·mine / win_len, W_linesᵀ·theirs / win_len]; stem, fc1, fc2 and
// value_fc take bfloat16 operands with float32 accumulation; LayerNorm (eps
// 1e-6), ReLU, softmax and tanh in float32; the policy and value heads are
// float32 products.
//
// What bounded the first design (one CTA of 8 warps per 16 games, weights
// read by __ldg from L2 inside the k-loop, one dependent load per mma.sync):
// 135.54 µs per launch at B=512 and 132.92 µs at B=128 on an NVIDIA H100
// 80GB HBM3 at 700 W, against a 1.35 µs bound.  Only 32 CTAs ran at B=512
// (8 at B=128), each streaming all 2.52 MB of weights through its SM with
// no load in flight: latency of L2, not bytes or operations.
//
// Bound of the work on this card: at connect4's shapes (D=512, 2 blocks,
// Kp=272, value_fc 128) the forward is 1.29 GFLOP of bf16 products on 2.5
// MB of weights at B=512, so operations bound it (1.3 µs at 989 TFLOP/s),
// above the weight bytes (0.8 µs at 3.35 TB/s); at B=128 the bytes do.
//
// Design:
// - Layers split across a thread-block cluster.  A cluster of CS = D/64
//   CTAs (8 at D=512) shares one tile of TG = 16, 32 or 48 games; CTA
//   rank r computes output columns [64r, 64r+64) of the stem, fc1 and
//   fc2, and rows [r·NV, (r+1)·NV) of value_fc (NV = DV/CS), and keeps its
//   64 columns of the float32 residual stream.  LayerNorm: each CTA writes
//   the mean and squared deviation of its 64 columns per game into every
//   peer's shared memory (distributed shared memory), and after a cluster
//   barrier every CTA combines the CS partials (Chan's formula: M2 = Σ M2_r
//   + 64·Σ (m_r − μ)²).  Each layer's bf16 output slice goes into every
//   peer's input buffer as 16-byte stores, then a cluster barrier.  So each
//   weight byte is read once per tile of games (11 tiles at B=512: 28 MB of
//   L2 reads per launch, not 80 MB).
// - Tile size from the card: the wrapper (search/fused.py:dense_plan)
//   takes the smallest tile whose clusters all fit on the card at once
//   (cudaOccupancyMaxActiveClusters: 15 clusters of 8 on an H100 SXM at
//   these shared-memory sizes, one CTA per SM).  At B=128 that is 8 tiles
//   of 16 games (64 CTAs); at B=512, 11 tiles of 48 (88 CTAs), not 16
//   tiles of 32 (128 CTAs), which need a second wave (76.6 against 108.2
//   µs per launch in chip_smoke's sweep on an H100 80GB HBM3 at 700 W).
// - Weights staged in shared memory, two whole-layer stages: each CTA
//   issues cp.async for the next layer's slice (64 × K bf16, ≤ 65 KB) while
//   this layer's products, LayerNorm and barriers run.  cp.async rather than
//   TMA: the slices of the logical (out, in) row-major weights are
//   contiguous rows already, so there is no kernel-order packing and no
//   tensor map (no -lcuda).  No multicast: a cluster's CTAs read disjoint
//   slices.  Before the first product, stage 1 holds the tile's
//   observations and the line table, from which the input rows are built.
// - Tensor cores: mma.sync m16n8k16 with games as M, fragments by ldmatrix
//   from the staged weights and the bf16 activations, loaded one k-step
//   ahead, even and odd k-steps into two accumulators.  Not wgmma: with
//   16-48 games a tile is 16-48 rows, under wgmma's 64, and the products
//   are a small part of the time (below).
// - fc1's output has a buffer of its own where shared memory allows (16-
//   and 32-game tiles); at 48 games it overwrites its input, behind one
//   more cluster barrier.
// - Heads in the same launch: the policy logits are float32 dot products
//   over each CTA's 64 columns, the value head a float32 dot over its NV
//   value_fc outputs; the partials of game g go to rank g mod CS, which
//   adds them in rank order and computes the softmax (float32, a warp per
//   game) and tanh.
//
// What bounds it now: not bytes or operations but latency — nine or ten
// cluster barriers per launch (two per LayerNorm, one or two per block's
// fc1 output, one for the heads), each waiting for the distributed
// shared-memory stores before it, and per-row work that grows with the
// tile (chip_smoke's launch at 0, 1 and 2 blocks gives the fixed and the
// per-block cost).  The next step is point-to-point signalling (remote
// mbarrier arrivals instead of whole-cluster barriers).
//
// Widths: D a multiple of 64 up to 512 (8 CTAs per cluster, the portable
// limit), DV/CS a multiple of 8 up to 64, Kp a multiple of 16, A ≤ 128 (81
// for gomoku9: the heads' partials [rank][g/CS][A+1] grow with A, and at
// D=512, Kp=448 every tile still fits a CTA's shared memory); the wrapper
// raises for the rest.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NC = 64;        // output columns of each layer per CTA
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int PAD = 8;        // bf16 row padding against bank conflicts
constexpr int LDH = NC + 8;   // float32 row stride of the residual slice
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_A = 128;    // actions: ⌈A/32⌉ ≤ 4 per lane (softmax)
constexpr int APL = MAX_A / 32;
constexpr int SMEM_LIMIT = 232448;
constexpr float LN_EPS = 1e-6f;

struct Args {
  const float* obs;
  int B, FRC, RC;
  const int32_t* lines;
  int L, K;
  const __nv_bfloat16* stem_w;
  const float* stem_b;
  int Kp;
  const float* ln_s;
  const float* ln_b;
  const __nv_bfloat16* w1;
  const float* b1;
  const __nv_bfloat16* w2;
  const float* b2;
  int nblocks;
  const float* fln_s;
  const float* fln_b;
  const float* pol_w;
  const float* pol_b;
  int A;
  const __nv_bfloat16* vfc_w;
  const float* vfc_b;
  int DV;
  const float* vh_w;
  const float* vh_b;
  int D;
  float* probs;
  float* value;
  int TG;
};

// Shared memory of one CTA (byte offsets, each 16-aligned).  Before the
// first product, stage 1 holds the tile's observations and the line table
// (layer 1's weights are issued after the input rows are built).  ya, the
// bf16 output of fc1, exists where it fits (ya = 0 otherwise: fc1 then
// writes its output over its input xa, behind one more cluster barrier).
// pl holds the heads' partial sums of the games this CTA finishes (game g
// on rank g mod CS, at most PER = ⌈TG / CS⌉ of them, CS need not divide
// TG): [rank q][g / CS][A + 1] as written by CTA q.
struct Layout {
  int CS, NV, lda, per;
  size_t w0, w1, xa, ya, hs, st, pv, pl, total;
};

__host__ __device__ inline Layout layout(int TG, int D, int Kp, int DV,
                                         int A) {
  Layout L;
  L.CS = D / NC;
  L.NV = DV / L.CS;
  L.per = (TG + L.CS - 1) / L.CS;
  L.lda = (Kp > D ? Kp : D) + PAD;
  const size_t stage = (size_t)NC * L.lda * 2;
  const size_t ya = (size_t)TG * L.lda * 2;
  const size_t heads =
      ((size_t)L.CS * L.per * (A + 1) * 4 + 15) & ~(size_t)15;
  const size_t rest = (size_t)TG * LDH * 4 + (size_t)L.CS * TG * 8 +
                      (size_t)NWARP * TG * 4 + heads;
  const bool with_ya = 2 * stage + 2 * ya + rest <= (size_t)SMEM_LIMIT;
  L.w0 = 0;
  L.w1 = stage;
  L.xa = 2 * stage;                                  // TG × lda bf16
  L.ya = with_ya ? L.xa + ya : 0;                    // TG × lda bf16
  L.hs = L.xa + (with_ya ? 2 : 1) * ya;              // TG × LDH float32
  L.st = L.hs + (size_t)TG * LDH * 4;                // CS × TG × 2 float32
  L.pv = L.st + (size_t)L.CS * TG * 8;               // NWARP × TG float32
  L.pl = L.pv + (size_t)NWARP * TG * 4;              // CS × PER × (A+1)
  L.total = L.pl + heads;
  return L;
}

// Issue the cp.async copies of layer `layer`'s weight slice into `dst`
// and commit them as one group (an empty group past the last layer, so
// every layer is one group).  Layers: 0 stem, 1 + 2b fc1 of block b,
// 2 + 2b fc2, 1 + 2·nblocks value_fc.
__device__ void issue_layer(const Args& p, const Layout& L, int layer,
                            int rank, __nv_bfloat16* dst) {
  const int nb = p.nblocks, D = p.D;
  if (layer == 0) {
    az::cp_async_rows(dst, L.lda, p.stem_w + (size_t)rank * NC * p.Kp, p.Kp,
                      NC, p.Kp);
  } else if (layer <= 2 * nb) {
    const int b = (layer - 1) >> 1;
    const __nv_bfloat16* w = ((layer - 1) & 1) ? p.w2 : p.w1;
    az::cp_async_rows(dst, L.lda, w + ((size_t)b * D + rank * NC) * D, D,
                      NC, D);
  } else if (layer == 2 * nb + 1) {
    az::cp_async_rows(dst, L.lda, p.vfc_w + (size_t)rank * L.NV * D, D, L.NV,
                      D);
  }
  az::cp_async_commit();
}

// acc = Σ_k As[g][k] · Ws[n][k] for the tile's MT·16 games and n-tile
// `warp` of the `ntiles` ≤ 8 staged n-tiles of 8 rows of Ws (zeros for a
// warp past them).  The thread holds rows mt·16 + gid (acc[mt][0..1]) and
// mt·16 + gid + 8 (acc[mt][2..3]), columns 8·warp + 2·tig and + 1.
template <int MT>
__device__ __forceinline__ void gemm(const __nv_bfloat16* As, int lda,
                                     const __nv_bfloat16* Ws, int ldw, int K,
                                     int ntiles, float (&acc)[MT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;
  if (warp >= ntiles) return;
  uint32_t abase[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    abase[mt] = az::ldsm_a_addr(
        az::smem_addr(As + (mt * 16 + (lane & 15)) * lda), lane);
  const uint32_t wb =
      az::ldsm_b_addr(az::smem_addr(Ws), ldw, warp * 8, 0, lane);
  // fragments loaded one k-step ahead of their products (ldmatrix and
  // mma.sync are volatile asm and keep source order); even and odd k-steps
  // sum into two accumulators, halving the chain of dependent mma.sync
  uint32_t a0[MT][4], b0[2], a1[MT][4], b1[2];
  float odd[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) odd[mt][i] = 0.0f;
  auto load = [&](uint32_t (&a)[MT][4], uint32_t (&b)[2], int k0) {
    az::ldsm_x2(b, wb + k0 * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) az::ldsm_x4(a[mt], abase[mt] + k0 * 2);
  };
  load(a0, b0, 0);
  int k0 = 0;
  for (; k0 + 32 <= K; k0 += 32) {
    load(a1, b1, k0 + 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) az::mma_bf16(acc[mt], a0[mt], b0);
    if (k0 + 32 < K) load(a0, b0, k0 + 32);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) az::mma_bf16(odd[mt], a1[mt], b1);
  }
  if (k0 < K) {                 // an odd last k-step, loaded above
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) az::mma_bf16(acc[mt], a0[mt], b0);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] += odd[mt][i];
}

// epi(row, col, v0, v1) on each accumulator pair of the thread.
template <int MT, class Epi>
__device__ __forceinline__ void each_pair(const float (&acc)[MT][4],
                                          Epi epi) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, n = (threadIdx.x >> 5) * 8 + (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    epi(mt * 16 + gid, n, acc[mt][0], acc[mt][1]);
    epi(mt * 16 + gid + 8, n, acc[mt][2], acc[mt][3]);
  }
}

// The 16 bytes held as one 32-bit word by each of lanes base..base+3.
__device__ __forceinline__ uint4 lane_words(uint32_t w, int base) {
  return make_uint4(__shfl_sync(0xffffffffu, w, base),
                    __shfl_sync(0xffffffffu, w, base + 1),
                    __shfl_sync(0xffffffffu, w, base + 2),
                    __shfl_sync(0xffffffffu, w, base + 3));
}

// LayerNorm of the tile's rows over all D columns, from this CTA's 64
// columns hs (float32) and the peers' partial statistics; writes the bf16
// result of this CTA's columns into every peer's dst (row stride ldd) and,
// with out32, the float32 result back into hs.  Warp w takes rows w + 8i
// (MT·2 of them, unrolled so that their shuffles overlap); lane l holds
// columns 2l and 2l+1.
template <int MT>
__device__ void ln_gather(cg::cluster_group& cl, const Layout& L, int D,
                          int rank, float* hs, float* st, const float* s,
                          const float* b, __nv_bfloat16* dst, int ldd,
                          bool out32) {
  constexpr int TG = MT * 16, R = TG / NWARP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int CS = L.CS, col = rank * NC + 2 * lane;
  float2 v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = warp + NWARP * i;
    v[i] = *reinterpret_cast<const float2*>(hs + g * LDH + 2 * lane);
    const float m = az::warp_sum(v[i].x + v[i].y) * (1.0f / NC);
    const float d0 = v[i].x - m, d1 = v[i].y - m;
    const float m2 = az::warp_sum(d0 * d0 + d1 * d1);
    if (lane < CS) {
      float* peer = cl.map_shared_rank(st, lane) + (rank * TG + g) * 2;
      peer[0] = m;
      peer[1] = m2;
    }
  }
  cl.sync();
  const float s0 = __ldg(s + col), s1 = __ldg(s + col + 1);
  const float b0 = __ldg(b + col), b1 = __ldg(b + col + 1);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = warp + NWARP * i;
    float mu = 0.0f;
    for (int q = 0; q < CS; ++q) mu += st[(q * TG + g) * 2];
    mu /= (float)CS;
    float m2 = 0.0f;
    for (int q = 0; q < CS; ++q) {
      const float dm = st[(q * TG + g) * 2] - mu;
      m2 += st[(q * TG + g) * 2 + 1] + (float)NC * dm * dm;
    }
    const float r = rsqrtf(m2 / (float)D + LN_EPS);
    const float y0 = (v[i].x - mu) * r * s0 + b0;
    const float y1 = (v[i].y - mu) * r * s1 + b1;
    if (out32)
      *reinterpret_cast<float2*>(hs + g * LDH + 2 * lane) = make_float2(y0, y1);
    // lane l takes the 16-byte chunk l mod 8 of the row (lanes 4c..4c+3
    // hold chunk c) to peers l / 8, l / 8 + 4
    const uint4 v16 = lane_words(az::pack_bf16(y0, y1), 4 * (lane & 7));
    uint4* mine = reinterpret_cast<uint4*>(dst + g * ldd + rank * NC +
                                           8 * (lane & 7));
    for (int q = lane >> 3; q < CS; q += 4) *cl.map_shared_rank(mine, q) = v16;
  }
  cl.sync();
}

template <int MT>
__global__ void __launch_bounds__(NTHREAD) dense_forward_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int TG = MT * 16, D = p.D, A = p.A;
  const Layout L = layout(TG, D, p.Kp, p.DV, A);
  const int rank = (int)cl.block_rank();
  const int col0 = rank * NC;
  __nv_bfloat16* wst[2] = {reinterpret_cast<__nv_bfloat16*>(smem + L.w0),
                           reinterpret_cast<__nv_bfloat16*>(smem + L.w1)};
  __nv_bfloat16* xa = reinterpret_cast<__nv_bfloat16*>(smem + L.xa);
  __nv_bfloat16* ya =
      L.ya ? reinterpret_cast<__nv_bfloat16*>(smem + L.ya) : xa;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* st = reinterpret_cast<float*>(smem + L.st);
  float* pv = reinterpret_cast<float*>(smem + L.pv);
  float* pl = reinterpret_cast<float*>(smem + L.pl);
  const int g0 = (blockIdx.x / L.CS) * TG;
  const int ng = min(TG, p.B - g0);
  const int nb = p.nblocks;
  const int vlayer = 2 * nb + 1;
  float acc[MT][4];

  // every CTA of the cluster has started before any writes into a peer's
  // shared memory: arrive now, wait before the first LayerNorm
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  issue_layer(p, L, 0, rank, wst[0]);

  // input rows: [obs, line sums of planes 0 and 1 / win_len, zero pad],
  // from the tile's observations and the line table staged in stage 1
  float* ob = reinterpret_cast<float*>(wst[1]);
  int32_t* lt = reinterpret_cast<int32_t*>(ob + TG * p.FRC);
  for (int i = threadIdx.x; i < ng * p.FRC; i += NTHREAD)
    ob[i] = __ldg(p.obs + (size_t)g0 * p.FRC + i);
  for (int i = threadIdx.x; i < p.L * p.K; i += NTHREAD)
    lt[i] = __ldg(p.lines + i);
  __syncthreads();
  for (int i = threadIdx.x; i < TG * p.Kp; i += NTHREAD) {
    const int g = i / p.Kp, k = i - g * p.Kp;
    float x = 0.0f;
    if (g < ng) {
      const float* o = ob + g * p.FRC;
      if (k < p.FRC) {
        x = o[k];
      } else if (k < p.FRC + 2 * p.L) {
        int l = k - p.FRC;
        const int plane = l >= p.L ? 1 : 0;
        l -= plane * p.L;
        const int32_t* cells = lt + l * p.K;
        float s = 0.0f;
        for (int j = 0; j < p.K; ++j) s += o[plane * p.RC + cells[j]];
        x = s / (float)p.K;
      }
    }
    xa[g * L.lda + k] = __float2bfloat16_rn(x);
  }
  __syncthreads();
  issue_layer(p, L, 1, rank, wst[1]);
  az::cp_async_wait(1);
  __syncthreads();

  gemm<MT>(xa, L.lda, wst[0], L.lda, p.Kp, NC / 8, acc);
  each_pair<MT>(acc, [&](int g, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(hs + g * LDH + n) =
        make_float2(v0 + __ldg(p.stem_b + col0 + n),
                    v1 + __ldg(p.stem_b + col0 + n + 1));
  });
  __syncthreads();
  issue_layer(p, L, 2, rank, wst[0]);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  for (int blk = 0; blk < nb; ++blk) {
    const int l1 = 1 + 2 * blk;
    ln_gather<MT>(cl, L, D, rank, hs, st, p.ln_s + blk * D,
                  p.ln_b + blk * D, xa, L.lda, false);
    az::cp_async_wait(1);
    __syncthreads();
    gemm<MT>(xa, L.lda, wst[l1 & 1], L.lda, D, NC / 8, acc);
    if (ya == xa) {
      // fc1's output replaces its input: every CTA of the cluster is done
      // reading xa before any writes its slice of relu(fc1) into it
      cl.sync();
    } else {
      __syncthreads();
    }
    issue_layer(p, L, l1 + 2, rank, wst[l1 & 1]);
    const float* b1 = p.b1 + blk * D + col0;
    each_pair<MT>(acc, [&](int g, int n, float v0, float v1) {
      // a quad holds the 16 bytes of its row in this warp's n-tile; lane
      // tig takes them to peers tig, tig + 4
      const int lane = threadIdx.x & 31, tig = lane & 3;
      const uint4 v16 = lane_words(
          az::pack_bf16(fmaxf(v0 + __ldg(b1 + n), 0.0f),
                        fmaxf(v1 + __ldg(b1 + n + 1), 0.0f)),
          lane & ~3);
      uint4* mine = reinterpret_cast<uint4*>(ya + g * L.lda + col0 + n -
                                             2 * tig);
      for (int q = tig; q < L.CS; q += 4) *cl.map_shared_rank(mine, q) = v16;
    });
    az::cp_async_wait(1);
    cl.sync();
    gemm<MT>(ya, L.lda, wst[(l1 + 1) & 1], L.lda, D, NC / 8, acc);
    const float* b2 = p.b2 + blk * D + col0;
    each_pair<MT>(acc, [&](int g, int n, float v0, float v1) {
      float2* h = reinterpret_cast<float2*>(hs + g * LDH + n);
      const float2 o = *h;
      *h = make_float2(o.x + (v0 + __ldg(b2 + n)), o.y + (v1 + __ldg(b2 + n + 1)));
    });
    __syncthreads();
    issue_layer(p, L, l1 + 3, rank, wst[(l1 + 1) & 1]);
  }

  ln_gather<MT>(cl, L, D, rank, hs, st, p.fln_s, p.fln_b, xa, L.lda, true);
  az::cp_async_wait(0);
  __syncthreads();

  // value_fc rows [rank·NV, +NV): relu, then the float32 dot with the
  // value head's weights, partial per warp (8 columns) and game
  const int v0col = rank * L.NV;
  gemm<MT>(xa, L.lda, wst[vlayer & 1], L.lda, D, L.NV / 8, acc);
  if ((threadIdx.x >> 5) < L.NV / 8)
    each_pair<MT>(acc, [&](int g, int n, float v0, float v1) {
      const int c = v0col + n;
      const float a0 = fmaxf(v0 + __ldg(p.vfc_b + c), 0.0f);
      const float a1 = fmaxf(v1 + __ldg(p.vfc_b + c + 1), 0.0f);
      const float s = az::quad_sum(a0 * __ldg(p.vh_w + c) +
                                   a1 * __ldg(p.vh_w + c + 1));
      if ((threadIdx.x & 3) == 0) pv[(threadIdx.x >> 5) * TG + g] = s;
    });
  // policy logits over this CTA's 64 columns, float32, one thread per
  // (game, action), written into the slot [rank][g / CS] of the rank that
  // finishes game g (g mod CS)
  const int A1 = A + 1, CS = L.CS, per = L.per;
  for (int i = threadIdx.x; i < TG * A; i += NTHREAD) {
    const int g = i / A, a = i - g * A;
    const float* w = p.pol_w + (size_t)a * D + col0;
    const float* h = hs + g * LDH;
    float s = 0.0f;
#pragma unroll 8
    for (int c = 0; c < NC; ++c) s += h[c] * __ldg(w + c);
    *cl.map_shared_rank(pl + (rank * per + g / CS) * A1 + a, g % CS) = s;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < TG; g += NTHREAD) {
    float s = 0.0f;
    for (int w = 0; w < L.NV / 8; ++w) s += pv[w * TG + g];
    *cl.map_shared_rank(pl + (rank * per + g / CS) * A1 + A, g % CS) = s;
  }
  cl.sync();   // the last access to a peer's shared memory

  // this rank's games, one warp each: partials added in rank order, the
  // softmax over actions a = lane + 32j (j < APL), the warp's max and sum
  // taken over all of them, tanh of the value
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < per; i += NWARP) {
    const int g = i * CS + rank;
    if (g >= ng) continue;
    float lg[APL], vs = 0.0f, m = -INFINITY;
#pragma unroll
    for (int j = 0; j < APL; ++j) {
      const int a = lane + 32 * j;
      lg[j] = -INFINITY;
      if (a < A) {
        lg[j] = __ldg(p.pol_b + a);
        for (int q = 0; q < CS; ++q) lg[j] += pl[(q * per + i) * A1 + a];
      }
      m = fmaxf(m, lg[j]);
    }
    if (lane == 0)
      for (int q = 0; q < CS; ++q) vs += pl[(q * per + i) * A1 + A];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float e[APL], s = 0.0f;
#pragma unroll
    for (int j = 0; j < APL; ++j) {
      e[j] = lane + 32 * j < A ? expf(lg[j] - m) : 0.0f;
      s += e[j];
    }
    const float tot = az::warp_sum(s);
#pragma unroll
    for (int j = 0; j < APL; ++j)
      if (lane + 32 * j < A)
        p.probs[(size_t)(g0 + g) * A + lane + 32 * j] = e[j] / tot;
    if (lane == 0) p.value[g0 + g] = tanhf(vs + __ldg(p.vh_b));
  }
}

template <int MT>
int launch(const Args& a, const Layout& L, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      dense_forward_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.B + a.TG - 1) / a.TG * L.CS));
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dense_forward_kernel<MT>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool valid(int B, int TG, int D, int Kp, int DV, int A, int FRC, int L,
           int K) {
  if (B < 1 || (TG != 16 && TG != 32 && TG != 48) || D < NC || D % NC ||
      D / NC > MAX_CLUSTER || Kp % 16 || Kp < FRC + 2 * L || A < 1 ||
      A > MAX_A)
    return false;
  const int CS = D / NC;
  if (DV % CS || (DV / CS) % 8 || DV / CS > NC) return false;
  const Layout lay = layout(TG, D, Kp, DV, A);
  // the observations and the line table fit in stage 1
  return lay.total <= (size_t)SMEM_LIMIT &&
         ((size_t)TG * FRC + (size_t)L * K) * 4 <= lay.w1 - lay.w0;
}

}  // namespace

extern "C" {

const char* az_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Launch geometry of a forward with TG games per tile: out[0] shared
// memory bytes per CTA, out[1] CTAs per cluster, out[2] how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters).
int az_dense_geometry(int TG, int D, int Kp, int DV, int A, void* out) {
  if (!valid(1, TG, D, Kp, DV, A, 0, 0, 0))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(TG, D, Kp, DV, A);
  int* o = static_cast<int*>(out);
  o[0] = (int)L.total;
  o[1] = L.CS;
  auto kern = TG == 48   ? dense_forward_kernel<3>
              : TG == 32 ? dense_forward_kernel<2>
                         : dense_forward_kernel<1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(L.CS * 16));
  cfg.blockDim = dim3(NTHREAD);
  cfg.dynamicSmemBytes = L.total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&o[2], kern, &cfg);
}

int az_dense_forward(const void* obs, int B, int FRC, int RC,
                     const void* lines, int L, int K, const void* stem_w,
                     const void* stem_b, int Kp, const void* ln_s,
                     const void* ln_b, const void* w1, const void* b1,
                     const void* w2, const void* b2, int nblocks,
                     const void* fln_s, const void* fln_b, const void* pol_w,
                     const void* pol_b, int A, const void* vfc_w,
                     const void* vfc_b, int DV, const void* vh_w,
                     const void* vh_b, int D, void* probs, void* value,
                     int TG, void* stream) {
  if (!valid(B, TG, D, Kp, DV, A, FRC, L, K) || nblocks < 0)
    return (int)cudaErrorInvalidValue;
  Args a{(const float*)obs, B, FRC, RC, (const int32_t*)lines, L, K,
         (const __nv_bfloat16*)stem_w, (const float*)stem_b, Kp,
         (const float*)ln_s, (const float*)ln_b, (const __nv_bfloat16*)w1,
         (const float*)b1, (const __nv_bfloat16*)w2, (const float*)b2, nblocks,
         (const float*)fln_s, (const float*)fln_b, (const float*)pol_w,
         (const float*)pol_b, A, (const __nv_bfloat16*)vfc_w,
         (const float*)vfc_b, DV, (const float*)vh_w, (const float*)vh_b, D,
         (float*)probs, (float*)value, TG};
  const Layout lay = layout(TG, D, Kp, DV, A);
  if (TG == 48) return launch<3>(a, lay, (cudaStream_t)stream);
  if (TG == 32) return launch<2>(a, lay, (cudaStream_t)stream);
  return launch<1>(a, lay, (cudaStream_t)stream);
}

}  // extern "C"
