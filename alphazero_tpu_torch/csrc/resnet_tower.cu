// ResNet conv tower for inference: the stem and every residual block in one
// launch.
//
// Replaces: alphazero_tpu/ops/pallas_resnet.py:_kernel (the Pallas tower,
// pallas_call at :254).  Semantics are the Pallas kernel's: each 3×3 SAME
// conv reads its nine neighbours with a cell off the board as zero, the
// activation rounded to bf16 at the read, bf16 weights and float32 sums;
// LayerNorm over the channels of each cell in float32 (mean, mean of squared
// deviations, rsqrt(var + 1e-6), scale, bias); relu; the residual stream and
// the output stay float32.  The policy and value heads run outside.
//
// What bounded the first design (8 warps per CTA, 1-2 games per CTA, each
// conv's B fragments read by __ldg from L2 inside the k-loop with no load
// in flight, the float32 conv output round-tripped through shared memory):
// 441.20 µs per launch at connect4-resnet 64×4 B=512, 208.42 µs at B=128
// and 4.2921 ms per call at gomoku9 128×8 B=256 on an NVIDIA H100 80GB HBM3
// at 700 W, 34-43× the bound: the latency of dependent L2 loads, and every
// CTA re-reading every conv's weights (170 MB of L2 reads per launch at
// connect4 B=512, 1.3 GB at gomoku9 B=256).
//
// Bound of the work on this card: at connect4-resnet B=512 the tower is
// 12.8 GFLOP of bf16 products on ~6 MB of input, weights and output, so
// operations bound it (12.9 µs at 989 TFLOP/s); gomoku9 B=256 is 98 GFLOP
// (99 µs).
//
// Design:
// - Games in rows, channels in columns.  A CTA of 16 warps takes G whole
//   games (M = G·RC cells), G chosen by the wrapper (ops/resnet_tower.py:
//   plan) so that the grid is one wave of at most one CTA per SM where
//   shared memory allows: 4 games per CTA at connect4-resnet B=512, 1 at
//   B=128, 2 at gomoku9 B=256 (128 CTAs each on an H100 SXM's 132 SMs).
//   A batch that needs more waves (leaf-batched K·B = 4096) keeps
//   whole-conv stages (4 games per CTA, 1,024 CTAs) rather than more games
//   per CTA on single-tap stages.  Its float32 residual stream h (M × C),
//   a bf16 copy hb of the next conv's input (with one zero row for cells
//   off the board) and a table of each cell's nine neighbour rows live in
//   dynamic shared memory.
// - Weights staged in shared memory in a ring of cp.async stages of 9, 3
//   or 1 taps (C × cin bf16 each): all convs' taps form one stream, and
//   the next stage loads while this one's products run, across conv
//   boundaries.  Every stage costs a wait and a block barrier, which cost
//   more than the loads: at connect4-resnet B=512 a whole conv per stage
//   (2 × 73.7 KB, fits beside 4 games) takes 79.9 µs per launch, 3 taps
//   95.3 µs, single taps 131.3 µs (chip_smoke's sweep on an H100 80GB
//   HBM3 at 700 W).  gomoku9's 128 channels stage single taps (32 KB).
//   Rows are unpadded; row n keeps its 16-byte chunk c at c ^ (n & 7) (a
//   power of two of chunks; else c ^ (n & 1)), so ldmatrix's 8 rows hit
//   distinct banks.  Each CTA reads each conv's weights once per launch
//   (128 CTAs × 0.66 MB = 85 MB of L2 reads at connect4 B=512, not 170).
// - Tensor cores: mma.sync m16n8k16, bf16 in, float32 accumulators.  Warp w
//   owns MT m-tiles (16 rows each; MT = 2 only where 16 warps of one
//   m-tile do not cover the tile) and all C output channels for the whole
//   conv (≤ 64 accumulator registers).  A fragments by ldmatrix with one
//   neighbour-row address per lane (the zero row off the board), B
//   fragments by ldmatrix from the staged tap, loaded one step ahead of
//   their products (at C ≤ 64; at 128 channels the registers are full).
//   Not wgmma: a tap's shifted rows are gathered through the neighbour
//   table, so A would come from registers and B needs wgmma's swizzled
//   shared-memory descriptors; that is the next step.
// - No float32 conv output in shared memory: the LayerNorm, relu and
//   residual epilogue run on the accumulators.  A warp's accumulator tile
//   holds whole rows (all C channels), so each row's mean and squared
//   deviation are sums over the 4 lanes of a quad.  That freed 4·C bytes per
//   cell, which is what lets 4 games share one CTA at C=64.
//
// What bounds it now: the issue of mma.sync and its ldmatrix operands
// (every warp reads the whole staged tap for its 16 rows), with 3 warps of
// 16 rows per SM sub-partition at B=512 and 1 at B=128 — latency, not the
// tensor cores' rate (about 6× the operations bound at B=512).
//
// Shapes: C a multiple of 16 from 16 to 128, 1 to 16 input planes (the
// stem's padded to 16, one k-step), at most 16·MT·16 cells per CTA; the
// wrapper raises for the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int NWARP = 16;
constexpr int NTHREAD = NWARP * 32;
constexpr int PAD = 8;         // bf16 / float32 row padding (bank conflicts)
constexpr int CIN_STEM = 16;   // the stem's input channels, zero-padded
constexpr int MAX_C = 128;
constexpr int SMEM_LIMIT = 232448;
constexpr float LN_EPS = 1e-6f;

enum { MODE_STEM = 0, MODE_MID = 1, MODE_RESIDUAL = 2 };

struct Args {
  const float* x;               // (B, F, RC) observations
  int B, F, rows, cols, C, nblocks, G, stages, tps;
  const __nv_bfloat16* wstem;   // (C, 9·16)
  const __nv_bfloat16* wblk;    // (nblocks, 2, C, 9·C)
  const float* lns;             // (1 + 2·nblocks, 2, C): scale, bias
  float* out;                   // (B, RC, C)
};

// Rows of a tile of G games, padded to whole warp items of MT m-tiles.
__host__ __device__ inline int padded_rows(int G, int RC, int MT) {
  const int q = 16 * MT;
  return (G * RC + q - 1) / q * q;
}

struct Layout {
  size_t h, hb, nbr, ring, stage, total;
};

// Shared memory of a tile (offsets in bytes, each 16-aligned): h float32
// Mp × (C+8); hb bf16 (Mp+1) × (C+8), row Mp zero; the int16 neighbour
// table 9 × Mp; `stages` stages of `tps` taps of C × C bf16 each (rows
// unpadded, 16-byte chunks swizzled: see swz).
__host__ __device__ inline Layout layout(int Mp, int C, int stages,
                                         int tps) {
  Layout L;
  L.h = 0;
  L.hb = L.h + (size_t)Mp * (C + PAD) * 4;
  L.nbr = L.hb + (((size_t)(Mp + 1) * (C + PAD) * 2 + 15) & ~(size_t)15);
  L.ring = L.nbr + (((size_t)9 * Mp * 2 + 15) & ~(size_t)15);
  L.stage = (size_t)tps * C * C * 2;
  L.total = L.ring + stages * L.stage;
  return L;
}

// XOR mask of the 16-byte chunks of a staged weight row of `chunks`
// chunks: row n keeps chunk c at c ^ (n & mask), so the 8 rows that one
// ldmatrix matrix reads fall in distinct banks (a power of two of chunks;
// otherwise only pairs are swapped, which keeps every chunk in its row).
__host__ __device__ inline int swz_mask(int chunks) {
  if (chunks & (chunks - 1)) return 1;
  return (chunks < 8 ? chunks : 8) - 1;
}

// Chunk j of the weight stream (9 / tps chunks of tps taps per conv: the
// stem, then conv1 and conv2 of each block) into its ring stage, as one
// commit group (empty past the last chunk).  Tap tt of a stage holds
// W[n][t·cin + ci] as rows n of cin, swizzled.
__device__ __forceinline__ void issue_chunk(const Args& p, int j, int nchunks,
                                            unsigned char* ring,
                                            size_t stage_bytes) {
  if (j < nchunks) {
    const int per_conv = 9 / p.tps;
    const int conv = j / per_conv, t0 = (j - conv * per_conv) * p.tps;
    const int C = p.C, cin = conv == 0 ? CIN_STEM : C;
    const __nv_bfloat16* w =
        conv == 0 ? p.wstem : p.wblk + (size_t)(conv - 1) * C * 9 * C;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(
        ring + (size_t)(j % p.stages) * stage_bytes);
    const int chunks = cin >> 3, mask = swz_mask(chunks);
    for (int i = threadIdx.x; i < p.tps * C * chunks; i += blockDim.x) {
      const int row = i / chunks, c = i - row * chunks;   // row = tt·C + n
      const int tt = row / C, n = row - tt * C;
      az::cp_async16(dst + row * cin + ((c ^ (n & mask)) << 3),
                     w + (size_t)n * 9 * cin + (t0 + tt) * cin + (c << 3));
    }
  }
  az::cp_async_commit();
}

// acc += one tap's products: KS k-steps of 16 input channels × NT n-tiles
// of 8 output channels for the warp's MT m-tiles.  aa[mt] is the lane's
// ldmatrix address of its A row at channel 0; wrow the address of the
// lane's B row (row (lane & 7) + 8·(lane >> 4) of the staged tap, rows of
// KS·32 bytes, chunks swizzled by `sw` = (lane & 7) & mask).  The
// fragments of each step are loaded one step ahead of its products
// (ldmatrix and mma.sync are volatile asm and keep source order).
template <int KS, int NT, int MT>
__device__ __forceinline__ void tap_mma(float (&acc)[MT][NT][4],
                                        const uint32_t (&aa)[MT],
                                        uint32_t wrow, int sw, int lane) {
  constexpr int NP = NT / 2, STEPS = KS * NP;
  const int half = (lane >> 3) & 1;
  auto baddr = [&](int np, int ks) {
    return wrow + (uint32_t)(np * 16 * KS * 32) +
           (uint32_t)(((2 * ks + half) ^ sw) << 4);
  };
  if constexpr (NT > 8) {
    // 64 accumulators already: no registers for a second set of
    // fragments under the 128 a thread may hold (16 warps per CTA)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) az::ldsm_x4(a[mt], aa[mt] + ks * 32);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        az::ldsm_x4(b, baddr(np, ks));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          az::mma_bf16(acc[mt][2 * np], a[mt], b);
          az::mma_bf16(acc[mt][2 * np + 1], a[mt], b + 2);
        }
      }
    }
    return;
  }
  uint32_t a[2][MT][4], b[2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) az::ldsm_x4(a[0][mt], aa[mt]);
  az::ldsm_x4(b[0], baddr(0, 0));
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int ks = s / NP, np = s % NP;
    if (s + 1 < STEPS) {
      const int ks1 = (s + 1) / NP, np1 = (s + 1) % NP;
      az::ldsm_x4(b[(s + 1) & 1], baddr(np1, ks1));
      if (np1 == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          az::ldsm_x4(a[ks1 & 1][mt], aa[mt] + ks1 * 32);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      az::mma_bf16(acc[mt][2 * np], a[ks & 1][mt], b[s & 1]);
      az::mma_bf16(acc[mt][2 * np + 1], a[ks & 1][mt], b[s & 1] + 2);
    }
  }
}

template <int NT, int MT>
__global__ void __launch_bounds__(NTHREAD, 1) resnet_tower_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int C = NT * 8;
  constexpr int LDH = C + PAD;
  const int RC = p.rows * p.cols;
  const int g0 = blockIdx.x * p.G;
  const int ng = min(p.G, p.B - g0);
  const int M = ng * RC;
  const int Mp = padded_rows(p.G, RC, MT);
  const Layout L = layout(Mp, C, p.stages, p.tps);
  float* h = reinterpret_cast<float*>(smem + L.h);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + L.hb);
  int16_t* nbr = reinterpret_cast<int16_t*>(smem + L.nbr);
  unsigned char* ring = smem + L.ring;
  const int nchunks = (9 / p.tps) * (1 + 2 * p.nblocks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = warp * MT * 16;            // the warp's first row
  const bool active = row0 < Mp;

  for (int j = 0; j < p.stages - 1; ++j)
    issue_chunk(p, j, nchunks, ring, L.stage);

  // neighbour table: the row that tap t of cell m reads, Mp (the zero row)
  // off the board and for the padding rows
  for (int i = threadIdx.x; i < 9 * Mp; i += NTHREAD) {
    const int t = i / Mp, m = i - t * Mp;
    int src = Mp;
    if (m < M) {
      const int g = m / RC, cell = m - g * RC;
      const int r = cell / p.cols + t / 3 - 1;
      const int c = cell % p.cols + t % 3 - 1;
      if (r >= 0 && r < p.rows && c >= 0 && c < p.cols)
        src = g * RC + r * p.cols + c;
    }
    nbr[i] = (int16_t)src;
  }
  // the stem's input in bf16, channels zero-padded to 16; the zero row
  for (int i = threadIdx.x; i < Mp * CIN_STEM; i += NTHREAD) {
    const int m = i / CIN_STEM, ci = i - m * CIN_STEM;
    float v = 0.0f;
    if (m < M && ci < p.F) {
      const int g = m / RC, cell = m - g * RC;
      v = p.x[((size_t)(g0 + g) * p.F + ci) * RC + cell];
    }
    hb[m * LDH + ci] = __float2bfloat16_rn(v);
  }
  for (int c = threadIdx.x; c < C; c += NTHREAD)
    hb[Mp * LDH + c] = __float2bfloat16_rn(0.0f);

  const uint32_t hb_s = az::smem_addr(hb);
  const uint32_t ring_s = az::smem_addr(ring);
  int j = 0;                                 // chunk of the weight stream
  for (int conv = 0; conv < 1 + 2 * p.nblocks; ++conv) {
    const int cin = conv == 0 ? CIN_STEM : C;
    const int sw = (lane & 7) & swz_mask(cin >> 3);
    const int brow = ((lane >> 4) << 3) + (lane & 7);
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

    for (int t0 = 0; t0 < 9; t0 += p.tps, ++j) {
      az::cp_async_wait(p.stages - 2);         // chunk j has landed
      __syncthreads();                         // ... for every thread, and
      // every warp is done with chunk j-1, whose stage takes j+stages-1
      issue_chunk(p, j + p.stages - 1, nchunks, ring, L.stage);
      if (!active) continue;
      const uint32_t ws = ring_s + (uint32_t)((j % p.stages) * L.stage);
      for (int tt = 0; tt < p.tps; ++tt) {
        const int t = t0 + tt;
        const uint32_t wrow = ws + (uint32_t)((tt * C + brow) * cin * 2);
        uint32_t aa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int src = nbr[t * Mp + row0 + mt * 16 + (lane & 15)];
          aa[mt] = az::ldsm_a_addr(hb_s + (uint32_t)(src * LDH * 2), lane);
        }
        if (conv == 0)
          tap_mma<CIN_STEM / 16, NT, MT>(acc, aa, wrow, sw, lane);
        else
          tap_mma<C / 16, NT, MT>(acc, aa, wrow, sw, lane);
      }
    }
    __syncthreads();                           // every read of hb is done

    // epilogue on the accumulators: LayerNorm of each row over its C
    // channels (a quad of lanes holds a row), then by mode
    //   MODE_STEM:     h = relu(ln(y))
    //   MODE_MID:      (conv1 of a block) the next input relu(ln(y)) only
    //   MODE_RESIDUAL: h = relu(h + ln(y))
    // and the bf16 copy of the result into hb, the next conv's input
    const int mode = conv == 0 ? MODE_STEM
                               : ((conv & 1) ? MODE_MID : MODE_RESIDUAL);
    const float* scale = p.lns + (size_t)conv * 2 * C;
    const float* bias = scale + C;
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row0 + mt * 16 + gid + 8 * half;
          float s = 0.0f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            s += acc[mt][nt][2 * half] + acc[mt][nt][2 * half + 1];
          const float mu = az::quad_sum(s) / (float)C;
          float q = 0.0f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float d0 = acc[mt][nt][2 * half] - mu;
            const float d1 = acc[mt][nt][2 * half + 1] - mu;
            q += d0 * d0 + d1 * d1;
          }
          const float rs = rsqrtf(az::quad_sum(q) / (float)C + LN_EPS);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = nt * 8 + tig * 2;
            const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + n));
            const float2 bi = __ldg(reinterpret_cast<const float2*>(bias + n));
            float o0 = (acc[mt][nt][2 * half] - mu) * rs * sc.x + bi.x;
            float o1 = (acc[mt][nt][2 * half + 1] - mu) * rs * sc.y + bi.y;
            float2* hp = reinterpret_cast<float2*>(h + r * LDH + n);
            if (mode == MODE_RESIDUAL) {
              const float2 hv = *hp;
              o0 = hv.x + o0;
              o1 = hv.y + o1;
            }
            o0 = fmaxf(o0, 0.0f);
            o1 = fmaxf(o1, 0.0f);
            if (mode != MODE_MID) *hp = make_float2(o0, o1);
            *reinterpret_cast<uint32_t*>(hb + r * LDH + n) =
                az::pack_bf16(o0, o1);
          }
        }
      }
    }
  }
  __syncthreads();

  // the tile's rows are consecutive games: one contiguous run of out
  float4* o = reinterpret_cast<float4*>(p.out + (size_t)g0 * RC * C);
  for (int i = threadIdx.x; i < M * (C / 4); i += NTHREAD) {
    const int m = i / (C / 4), c = (i - m * (C / 4)) * 4;
    o[i] = *reinterpret_cast<const float4*>(h + m * LDH + c);
  }
}

using Kernel = void (*)(Args);

template <int NT>
Kernel pick_mt(int MT) {
  if (MT == 1) return resnet_tower_kernel<NT, 1>;
  if (NT <= 8 && MT == 2) return resnet_tower_kernel<NT, (NT <= 8 ? 2 : 1)>;
  return nullptr;
}

Kernel pick(int C, int MT) {
  switch (C / 8) {
    case 2: return pick_mt<2>(MT);
    case 4: return pick_mt<4>(MT);
    case 6: return pick_mt<6>(MT);
    case 8: return pick_mt<8>(MT);
    case 10: return pick_mt<10>(MT);
    case 12: return pick_mt<12>(MT);
    case 14: return pick_mt<14>(MT);
    case 16: return pick_mt<16>(MT);
  }
  return nullptr;
}

bool valid(int G, int RC, int C, int MT, int stages, int tps) {
  if (G < 1 || RC < 1 || C < 16 || C > MAX_C || C % 16 || stages < 2 ||
      (tps != 1 && tps != 3 && tps != 9) ||
      stages > 4 || (MT != 1 && MT != 2) || (MT == 2 && C > 64))
    return false;
  const int Mp = padded_rows(G, RC, MT);
  if (Mp > NWARP * MT * 16) return false;      // one warp item per warp
  return layout(Mp, C, stages, tps).total <= (size_t)SMEM_LIMIT;
}

}  // namespace

extern "C" {

const char* az_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Shared memory bytes of one CTA, or -1 for a geometry the kernel refuses.
int az_resnet_tower_smem(int G, int RC, int C, int MT, int stages, int tps) {
  if (!valid(G, RC, C, MT, stages, tps)) return -1;
  return (int)layout(padded_rows(G, RC, MT), C, stages, tps).total;
}

int az_resnet_tower(const void* x, int B, int F, int rows, int cols, int C,
                    int nblocks, const void* wstem, const void* wblk,
                    const void* lns, void* out, int G, int MT, int stages,
                    int tps, void* stream) {
  const int RC = rows * cols;
  if (B < 1 || F < 1 || F > CIN_STEM || nblocks < 0 ||
      !valid(G, RC, C, MT, stages, tps))
    return (int)cudaErrorInvalidValue;
  Kernel k = pick(C, MT);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(padded_rows(G, RC, MT), C, stages, tps).total;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Args a{(const float*)x, B, F, rows, cols, C, nblocks, G, stages, tps,
         (const __nv_bfloat16*)wstem, (const __nv_bfloat16*)wblk,
         (const float*)lns, (float*)out};
  k<<<(B + G - 1) / G, NTHREAD, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
