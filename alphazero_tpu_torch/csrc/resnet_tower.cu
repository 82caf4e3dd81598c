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
// Layout: games in rows, channels in columns.  A CTA takes a tile of G whole
// games, M = G·RC cells.  Its float32 residual stream h (M × C), the conv
// output y (M × C), a bf16 copy hb (M × (C+8)) of the next conv's input and
// a table of each cell's nine neighbour rows (-1 off the board) live in
// dynamic shared memory.  Each conv is an implicit GEMM of M cells × C
// outputs × K = 9·cin on bf16 mma.sync (m16n8k16) with float32
// accumulators: a warp takes a 16-row tile × 32 output channels, reads its A
// fragments from hb through the neighbour table (zero off the board) and its
// B fragments from the tap-major weights W[n][t·cin + ci] in device memory
// (L2).  The stem's F input channels are padded to 16 with zero weights.
// One warp per cell does the LayerNorm, the relu, the residual add and the
// bf16 copy for the next conv.
//
// Bound on this card: at connect4-resnet (64 channels, 4 blocks, 42 cells)
// and B=512 the tower is 12.8 GFLOP in bf16 on ~6 MB of input, weights and
// output, so the tensor cores bound it (12.9 µs at 989 TFLOP/s).  This first
// kernel is simple, not fast: every CTA streams each conv's weights from L2,
// mma.sync instead of wgmma, no overlap of loads and products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int PAD = 8;         // bf16 row padding of hb against bank conflicts
constexpr int CIN_STEM = 16;   // the stem's input channels, zero-padded
constexpr int MAX_C = 128;
constexpr int SMEM_LIMIT = 232448;
constexpr float LN_EPS = 1e-6f;

enum { MODE_STEM = 0, MODE_MID = 1, MODE_RESIDUAL = 2 };

struct Args {
  const float* x;               // (B, F, RC) observations
  int B, F, rows, cols, C, nblocks, G;
  const __nv_bfloat16* wstem;   // (C, 9·16)
  const __nv_bfloat16* wblk;    // (nblocks, 2, C, 9·C)
  const float* lns;             // (1 + 2·nblocks, 2, C): scale, bias
  float* out;                   // (B, RC, C)
};

__host__ __device__ inline int round16(int m) { return (m + 15) & ~15; }

struct Layout {
  size_t h, y, hb, nbr, total;
};

// Shared memory of a tile of G games (offsets in bytes, each 16-aligned).
__host__ __device__ inline Layout layout(int G, int RC, int C) {
  const size_t M16 = round16(G * RC);
  Layout L;
  L.h = 0;
  L.y = L.h + M16 * C * 4;
  L.hb = L.y + M16 * C * 4;
  L.nbr = L.hb + M16 * (C + PAD) * 2;
  L.total = L.nbr + 9 * M16 * 2;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// y[m][n] = sum over taps t and input channels ci of
//   hb[nbr[t][m]][ci] · W[n][t·cin + ci]   (0 where nbr is -1)
// for the M16 rows of the tile.  cin is a multiple of 16, so each k-step of
// 16 lies inside one tap.
__device__ void conv(const __nv_bfloat16* hb, int ldh, const int16_t* nbr,
                     int M16, int cin, const __nv_bfloat16* W, int C,
                     float* y) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int K = 9 * cin;
  const int ntiles = C / 8;
  const int ngroups = (ntiles + 3) / 4;
  const int items = (M16 / 16) * ngroups;
  for (int item = warp; item < items; item += NWARP) {
    const int mt = item / ngroups;
    const int nt0 = (item - mt * ngroups) * 4;
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    for (int t = 0; t < 9; ++t) {
      const int s0 = nbr[t * M16 + r0], s1 = nbr[t * M16 + r1];
      const __nv_bfloat16* a0 = hb + max(s0, 0) * ldh + tig * 2;
      const __nv_bfloat16* a1 = hb + max(s1, 0) * ldh + tig * 2;
      const __nv_bfloat16* wt = W + t * cin + tig * 2;
      for (int c0 = 0; c0 < cin; c0 += 16) {
        uint32_t a[4];
        a[0] = s0 >= 0 ? ld32(a0 + c0) : 0u;
        a[1] = s1 >= 0 ? ld32(a1 + c0) : 0u;
        a[2] = s0 >= 0 ? ld32(a0 + c0 + 8) : 0u;
        a[3] = s1 >= 0 ? ld32(a1 + c0 + 8) : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nt = nt0 + j;
          if (nt < ntiles) {
            const __nv_bfloat16* wr = wt + (size_t)(nt * 8 + gid) * K + c0;
            uint32_t b[2];
            b[0] = __ldg(reinterpret_cast<const unsigned int*>(wr));
            b[1] = __ldg(reinterpret_cast<const unsigned int*>(wr + 8));
            mma_bf16(acc[j], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nt = nt0 + j;
      if (nt < ntiles) {
        const int n = nt * 8 + tig * 2;
        *reinterpret_cast<float2*>(y + r0 * C + n) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(y + r1 * C + n) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// LayerNorm of each of the M rows of y (one warp per row), then by mode:
//   MODE_STEM:     h = relu(ln(y))
//   MODE_MID:      (conv1 of a block) the next input relu(ln(y)) only
//   MODE_RESIDUAL: h = relu(h + ln(y))
// and the bf16 copy of the result into hb, the next conv's input.
__device__ void layer_norm(const float* y, float* h, __nv_bfloat16* hb,
                           int ldh, int M, int C, const float* ln, int mode) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* scale = ln;
  const float* bias = ln + C;
  for (int m = warp; m < M; m += NWARP) {
    float v[MAX_C / 32];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j) {
      const int k = lane + 32 * j;
      v[j] = k < C ? y[m * C + k] : 0.0f;
      sum += v[j];
    }
    const float mu = warp_sum(sum) / (float)C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j) {
      const int k = lane + 32 * j;
      if (k < C) {
        const float d = v[j] - mu;
        sq += d * d;
      }
    }
    const float r = rsqrtf(warp_sum(sq) / (float)C + LN_EPS);
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j) {
      const int k = lane + 32 * j;
      if (k < C) {
        float o = (v[j] - mu) * r * scale[k] + bias[k];
        if (mode == MODE_RESIDUAL) o = h[m * C + k] + o;
        o = fmaxf(o, 0.0f);
        if (mode != MODE_MID) h[m * C + k] = o;
        hb[m * ldh + k] = __float2bfloat16_rn(o);
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREAD) resnet_tower_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RC = p.rows * p.cols, C = p.C, ldh = C + PAD;
  const Layout L = layout(p.G, RC, C);
  float* h = reinterpret_cast<float*>(smem + L.h);
  float* y = reinterpret_cast<float*>(smem + L.y);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + L.hb);
  int16_t* nbr = reinterpret_cast<int16_t*>(smem + L.nbr);
  const int g0 = blockIdx.x * p.G;
  const int ng = min(p.G, p.B - g0);
  const int M = ng * RC, M16 = round16(M);

  // neighbour table: row of the cell that tap t of cell m reads, -1 off the
  // board (and for the padding rows past M)
  for (int i = threadIdx.x; i < 9 * M16; i += NTHREAD) {
    const int t = i / M16, m = i - t * M16;
    int src = -1;
    if (m < M) {
      const int g = m / RC, cell = m - g * RC;
      const int r = cell / p.cols + t / 3 - 1;
      const int c = cell % p.cols + t % 3 - 1;
      if (r >= 0 && r < p.rows && c >= 0 && c < p.cols)
        src = g * RC + r * p.cols + c;
    }
    nbr[i] = (int16_t)src;
  }
  // the stem's input in bf16, channels zero-padded to 16
  for (int i = threadIdx.x; i < M * CIN_STEM; i += NTHREAD) {
    const int m = i / CIN_STEM, ci = i - m * CIN_STEM;
    const int g = m / RC, cell = m - g * RC;
    const float v =
        ci < p.F ? p.x[((size_t)(g0 + g) * p.F + ci) * RC + cell] : 0.0f;
    hb[m * ldh + ci] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  conv(hb, ldh, nbr, M16, CIN_STEM, p.wstem, C, y);
  __syncthreads();
  layer_norm(y, h, hb, ldh, M, C, p.lns, MODE_STEM);
  __syncthreads();
  for (int b = 0; b < p.nblocks; ++b) {
    const __nv_bfloat16* w1 = p.wblk + (size_t)b * 2 * C * 9 * C;
    const __nv_bfloat16* w2 = w1 + (size_t)C * 9 * C;
    const float* ln1 = p.lns + (size_t)(1 + 2 * b) * 2 * C;
    const float* ln2 = ln1 + 2 * C;
    conv(hb, ldh, nbr, M16, C, w1, C, y);
    __syncthreads();
    layer_norm(y, h, hb, ldh, M, C, ln1, MODE_MID);
    __syncthreads();
    conv(hb, ldh, nbr, M16, C, w2, C, y);
    __syncthreads();
    layer_norm(y, h, hb, ldh, M, C, ln2, MODE_RESIDUAL);
    __syncthreads();
  }

  // the tile's rows are consecutive games: one contiguous run of out
  float* o = p.out + (size_t)g0 * RC * C;
  for (int i = threadIdx.x; i < M * C; i += NTHREAD) o[i] = h[i];
}

}  // namespace

extern "C" {

const char* az_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int az_resnet_tower(const void* x, int B, int F, int rows, int cols, int C,
                    int nblocks, const void* wstem, const void* wblk,
                    const void* lns, void* out, int G, void* stream) {
  const int RC = rows * cols;
  if (B < 1 || G < 1 || F < 1 || F > CIN_STEM || C < 16 || C > MAX_C ||
      C % 16 || nblocks < 0 || RC < 1 || round16(G * RC) > 32767)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(G, RC, C);
  if (L.total > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      resnet_tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (e != cudaSuccess) return (int)e;
  Args a{(const float*)x, B, F, rows, cols, C, nblocks, G,
         (const __nv_bfloat16*)wstem, (const __nv_bfloat16*)wblk,
         (const float*)lns, (float*)out};
  resnet_tower_kernel<<<(B + G - 1) / G, NTHREAD, L.total,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
