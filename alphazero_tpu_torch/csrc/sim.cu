// The per-simulation search kernels (a group of lanes per game).
//
// Replaces: alphazero_tpu/search/pallas_mcts.py:_sim_kernel (:555, launched
// at :782) and _flush_kernel (:685, launched at :801), the Pallas kernels
// of the JAX package's per-simulation engine, which every network evaluator
// without the dense tower's whole-move search runs (the ResNet presets).
//   az_sim_step   the previous simulation's expansion and backup
//                 (_apply_update), then this simulation's PUCT descent with
//                 the leaf board built in the walk, the win-line terminal
//                 check, the legal mask (connect4 gravity, empty cells for
//                 tictactoe, gomoku's 8-neighbourhood with the centre as the
//                 only opening) and the canonical observation (B, F, R, C);
//   az_sim_flush  the update alone, for the last simulation.
// Both run the same __device__ group_update.  The network forward runs
// between launches, outside these kernels.
//
// Bound on this card: per game a launch reads a few hundred bytes to a few
// KB per walk step (the node's A edges and its children's stats) and
// writes the leaf's observation (F·RC floats): under a microsecond at HBM
// rate, with a few thousand float operations.  What bounds them is
// latency: a walk step is a chain of two dependent reads (the node's row
// of edges, then the children's stats) whose length is the tree depth,
// and the tree (≈ 67 MB at gomoku9 B=256, S=400, ≈ 185 MB at gomoku15)
// does not stay in the 50 MB L2.
//
// Layout (walk.cuh, shared with search.cu's az_descend_leaf/az_apply): a
// group of G lanes serves one game (8 for A ≤ 8, 16 for A ≤ 16, else 32),
// so a CTA of kThreads lanes holds kThreads/G games.  In order, per group:
//   1. the update of simulation prev_slot: lanes over actions write the
//      new row's priors (coalesced), one lane the parent's edge, lanes over
//      plies the backup; the nodes of one path are distinct, so each gets
//      its one __fadd_rn per channel, as in the serial loop;
//   2. __syncwarp: the walk reads the tree the update wrote (a game's
//      update and walk touch only its own rows, so no grid-wide sync);
//   3. the path reset, lanes over plies: ply d by lane d % G, the lane that
//      backed it up and that writes it in the walk;
//   4. the board: two planes per game in shared memory (and the column
//      heights under gravity), played on by lane 0 after each step;
//   5. the walk: each lane reads its E = ceil(A/G) edges (a ≡ lane mod G),
//      keeps its first maximum of the UCB as scalars, and the group's
//      butterfly (group_first_max) picks the first maximum of the row; the
//      winner's lane broadcasts child, visit count and expanded flag.  The
//      loop runs while __any_sync says a game of the warp walks;
//   6. the leaf finish: the win check (lanes over lines, a ballot over the
//      group), the legal mask (lanes over actions), the observation (lanes
//      over cells, coalesced) and the meta row (lanes over its columns).
// A stopped or idle group (past B on the last CTA) computes on in-range
// data, joins every shuffle and ballot and writes nothing.
//
// Numerics: built with -fmad=false; every float operation is a
// round-to-nearest intrinsic in the order of the plain PyTorch versions in
// search/sim.py and search/mcts.py (ucb, descend, expand_backup), so results
// agree bit for bit.  The tree layout is search/tree.py's: stats (B, N, 3)
// [visit, value sum, expanded], prior (B, N, A) float32 (NEG at illegal
// actions), children (B, N, A) int32 (-1 = no child).  Limits: boards of up
// to 256 cells, 32 columns under gravity, 256 actions.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "walk.cuh"

#define NEG (-1e30f)
#define MAX_A MAX_CELLS
#define META_COLS 8

constexpr int kThreads = 128;  // threads per CTA

namespace {

// edges a lane reads per walk step at A actions (a multiple of its group's
// G up to A): 1 for G < 32, else 4 up to A=128 and 8 up to 256
inline int edges_per_lane(int A) {
  const int g = group_size(A);
  return g < 32 ? 1 : (A <= 128 ? 4 : 8);
}

// expansion into slot ``slot`` and backup of the simulation recorded in
// path/meta/valid with its network output probs/value (game b), by the G
// lanes of its group
template <int G>
__device__ __forceinline__ void group_update(
    int b, int lane, float* stats, float* prior, int32_t* children,
    const int32_t* path, const int32_t* meta, const uint8_t* valid,
    const float* probs, const float* value, int slot, int N, int A,
    int dcap) {
  const int32_t* m = meta + (size_t)b * META_COLS;
  const int depth = m[0], parent = m[1], action = m[2], leaf = m[4];
  const bool alloc = m[3] != 0, terminal = m[5] != 0, won = m[6] != 0;
  const bool do_expand = alloc && !terminal;
  float* pr = prior + ((size_t)b * N + slot) * A;
  for (int a = lane; a < A; a += G)
    pr[a] = (do_expand && valid[(size_t)b * A + a]) ? probs[(size_t)b * A + a]
                                                     : NEG;
  if (alloc && lane == 0)
    children[((size_t)b * N + parent) * A + action] = slot;
  const float lv = terminal ? (won ? 1.0f : 0.0f) : -value[b];
  const int32_t* pa = path + (size_t)b * dcap;
  float* st = stats + (size_t)b * N * 3;
  // the plies of one path hold distinct nodes: one addition each
  for (int d = lane; d <= depth; d += G) {
    const int nd = d == depth ? leaf : pa[d];
    float* s = st + (size_t)nd * 3;
    s[0] = __fadd_rn(s[0], 1.0f);
    s[1] = __fadd_rn(s[1], ((depth - d) % 2 == 0) ? lv : -lv);
    s[2] = __fadd_rn(s[2], (d == depth && do_expand) ? 1.0f : 0.0f);
  }
}

template <int RULES, int G, int E>
__global__ void __launch_bounds__(kThreads) sim_step_kernel(
    float* stats, float* prior, int32_t* children, const int8_t* board,
    const int32_t* player, const int32_t* mc, const int32_t* lines,
    int32_t* path, int32_t* apath, int32_t* meta, uint8_t* valid, float* obs,
    const float* probs, const float* value, int prev_slot, int slot, int B,
    int N, int A, int R, int C, int F, int L, int K, int dcap, int max_moves,
    int az, float c_puct) {
  constexpr int kGames = kThreads / G;
  __shared__ uint8_t s_planes[kGames][2 * MAX_CELLS];
  __shared__ int s_h[RULES == RULES_GRAVITY ? kGames : 1][MAX_COLS];
  const int gi = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * kGames + gi;
  const bool active = b < B;
  const int bc = active ? b : B - 1;  // an idle group reads in range
  const unsigned gmask = group_mask<G>();
  const int RC = R * C;

  // ---- 1. the previous simulation's update (reads the previous
  // path/meta/valid)
  if (active && prev_slot >= 1)
    group_update<G>(b, lane, stats, prior, children, path, meta, valid,
                    probs, value, prev_slot, N, A, dcap);

  // ---- 3-4. the path reset (ply d by lane d % G, as in the backup) and
  // the walk's board
  int32_t* pa = path + (size_t)b * dcap;
  int32_t* ap = apath + (size_t)b * dcap;
  if (active)
    for (int d = lane; d < dcap; d += G) {
      pa[d] = N;
      ap[d] = 0;
    }
  uint8_t* pl = s_planes[gi];
  int* h = s_h[RULES == RULES_GRAVITY ? gi : 0];
  const int8_t* bd = board + (size_t)bc * 2 * RC;
  for (int c = lane; c < 2 * RC; c += G) pl[c] = (uint8_t)bd[c];
  if (RULES == RULES_GRAVITY)
    for (int c = lane; c < C; c += G) {
      int s = 0;
      for (int r = 0; r < R; ++r) s += bd[r * C + c] + bd[RC + r * C + c];
      h[c] = s;
    }
  // ---- 2. the walk reads the tree the update wrote, lane 0 plays on the
  // board the group loaded
  __syncwarp();

  // ---- 5. this simulation's descent, the leaf board built in the walk
  const float* st = stats + (size_t)bc * N * 3;
  const int rootp = player[bc];
  int node = 0, depth = 0, parent = -1, action = 0, chsel = 0;
  float pv = st[0];
  bool stop = !active || st[2] == 0.0f;  // an unexpanded (finished) root
  for (int d = 0; d < dcap && __any_sync(kFull, !stop); ++d) {
    // this lane's edges: its first maximum in ascending action order
    float best = -INFINITY, v_best = 0.0f, e_best = 0.0f;
    int act = INT_MAX, c_best = 0;
    if (!stop) {
      const int32_t* ch = children + ((size_t)bc * N + node) * A;
      const float* pr = prior + ((size_t)bc * N + node) * A;
      const float sq = __fsqrt_rn(pv);
      int cs[E];
      float ps[E], cvs[E], cls[E], ces[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {  // the edges, then their children
        const int a = lane + k * G;
        cs[k] = a < A ? ch[a] : -1;
        ps[k] = a < A ? pr[a] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float* cst = st + (size_t)(cs[k] >= 0 ? cs[k] : 0) * 3;
        cvs[k] = cs[k] >= 0 ? cst[0] : 0.0f;
        cls[k] = cs[k] >= 0 ? cst[1] : 0.0f;
        ces[k] = cs[k] >= 0 ? cst[2] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int a = lane + k * G;
        const float cv = cvs[k];
        const float q = cv > 0.0f ? __fdiv_rn(cls[k], fmaxf(cv, 1.0f)) : 0.0f;
        float ex = __fmul_rn(ps[k], __fdiv_rn(sq, __fadd_rn(cv, 1.0f)));
        if (az) ex = __fmul_rn(c_puct, ex);
        const float u = __fadd_rn(q, ex);
        if (a < A && u > best) {
          best = u;
          act = a;
          c_best = cs[k];
          v_best = cv;
          e_best = ces[k];
        }
      }
    }
    group_first_max<G>(best, act);
    // no u above -inf in the row: the serial loop keeps action 0 and zeros
    if (act == INT_MAX) act = 0;
    const int src = act & (G - 1);  // the lane that read the winning edge
    const int c_sel = __shfl_sync(kFull, c_best, src, G);
    const float v_sel = __shfl_sync(kFull, v_best, src, G);
    const float e_sel = __shfl_sync(kFull, e_best, src, G);
    if (!stop) {
      const bool now_stop = c_sel < 0 || e_sel == 0.0f;
      if (lane == d % G) {
        pa[d] = node;
        ap[d] = act;
      }
      parent = node;
      action = act;
      chsel = c_sel;
      depth = d + 1;
      if (!now_stop) node = c_sel;
      pv = v_sel;
      // play the selected move on the walk's board
      if (lane == 0) {
        const int mover = (rootp + d) & 1;
        if (RULES == RULES_GRAVITY) {
          if (h[act] < R) pl[mover * RC + (R - 1 - h[act]) * C + act] = 1;
          h[act] += 1;
        } else {
          pl[mover * RC + act] = 1;
        }
      }
      stop = now_stop;
    }
  }
  __syncwarp();

  // ---- 6. the leaf: terminal check, meta row, legal mask, observation
  const bool root_case = parent < 0;
  const bool alloc = parent >= 0 && chsel < 0;
  const int leaf_player = (rootp + depth) & 1;
  // the win check: lanes over lines, a ballot over the group
  const uint8_t* last = pl + (1 - leaf_player) * RC;
  bool line = false;
  for (int l = lane; l < L; l += G) {
    bool all = true;
    for (int k = 0; k < K && all; ++k) all = last[lines[l * K + k]] != 0;
    line = line || all;
  }
  const bool won = (__ballot_sync(kFull, line) & gmask) != 0;
  bool any = false;
  if (RULES == RULES_NEIGHBOURHOOD) {
    bool stone = false;
    for (int c = lane; c < RC; c += G) stone = stone || pl[c] || pl[RC + c];
    any = (__ballot_sync(kFull, stone) & gmask) != 0;
  }
  if (!active) return;
  const bool terminal = root_case || won || mc[b] + depth >= max_moves;
  if (lane < META_COLS)
    meta[(size_t)b * META_COLS + lane] =
        lane == 0 ? depth : lane == 1 ? parent : lane == 2 ? action
        : lane == 3 ? (int)alloc
        : lane == 4 ? (root_case ? 0 : (alloc ? slot : chsel))
        : lane == 5 ? (int)terminal : lane == 6 ? (int)won : leaf_player;
  for (int a = lane; a < A; a += G)
    valid[(size_t)b * A + a] = legal<RULES>(pl, pl + RC, h, any, a, R, C);
  const uint8_t* mine = pl + leaf_player * RC;
  float* o = obs + (size_t)b * F * RC;
  for (int c = lane; c < RC; c += G) {
    o[c] = (float)mine[c];
    o[RC + c] = (float)last[c];
    if (F == 3) o[2 * RC + c] = (float)leaf_player;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads) sim_flush_kernel(
    float* stats, float* prior, int32_t* children, const int32_t* path,
    const int32_t* meta, const uint8_t* valid, const float* probs,
    const float* value, int slot, int B, int N, int A, int dcap) {
  const int lane = threadIdx.x % G;
  const int b = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (b >= B || slot < 1) return;  // the update has no warp-wide step
  group_update<G>(b, lane, stats, prior, children, path, meta, valid, probs,
                  value, slot, N, A, dcap);
}

// launch(std::integral_constant<int, G>, std::integral_constant<int, E>)
// for the group size and the edges per lane of A actions
template <class Launch>
void with_layout(int A, Launch launch) {
  with_group(A, [&](auto gl) {
    if constexpr (decltype(gl)::value == 32) {
      if (A > 128)
        launch(gl, std::integral_constant<int, 8>());
      else
        launch(gl, std::integral_constant<int, 4>());
    } else {
      launch(gl, std::integral_constant<int, 1>());
    }
  });
}

// CTAs for B games of A actions
inline int group_blocks(int B, int A) {
  const int games = kThreads / group_size(A);
  return (B + games - 1) / games;
}

}  // namespace

extern "C" {

const char* az_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Launch geometry of az_sim_step and az_sim_flush for B games of A
// actions: out = {lanes per game, games per CTA, CTAs, threads per CTA,
// edges a lane reads per walk step}.
int az_sim_geometry(int B, int A, int* out) {
  if (A < 1 || A > MAX_A || B < 1) return (int)cudaErrorInvalidValue;
  out[0] = group_size(A);
  out[1] = kThreads / out[0];
  out[2] = group_blocks(B, A);
  out[3] = kThreads;
  out[4] = edges_per_lane(A);
  return 0;
}

int az_sim_step(void* stats, void* prior, void* children, const void* board,
                const void* player, const void* mc, const void* lines,
                void* path, void* apath, void* meta, void* valid, void* obs,
                const void* probs, const void* value, int prev_slot, int slot,
                int B, int N, int A, int R, int C, int F, int L, int K,
                int dcap, int max_moves, int rules, int az, float c_puct,
                void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  return with_rules<MAX_A>(A, R, C, rules, [&](auto rl) {
    with_layout(A, [&](auto gl, auto el) {
      sim_step_kernel<decltype(rl)::value, decltype(gl)::value,
                      decltype(el)::value>
          <<<group_blocks(B, A), kThreads, 0, (cudaStream_t)stream>>>(
              (float*)stats, (float*)prior, (int32_t*)children,
              (const int8_t*)board, (const int32_t*)player,
              (const int32_t*)mc, (const int32_t*)lines, (int32_t*)path,
              (int32_t*)apath, (int32_t*)meta, (uint8_t*)valid, (float*)obs,
              (const float*)probs, (const float*)value, prev_slot, slot, B,
              N, A, R, C, F, L, K, dcap, max_moves, az, c_puct);
    });
  });
}

int az_sim_flush(void* stats, void* prior, void* children, const void* path,
                 const void* meta, const void* valid, const void* probs,
                 const void* value, int slot, int B, int N, int A, int dcap,
                 void* stream) {
  if (A < 1 || A > MAX_A || B < 1) return (int)cudaErrorInvalidValue;
  with_group(A, [&](auto gl) {
    sim_flush_kernel<decltype(gl)::value>
        <<<group_blocks(B, A), kThreads, 0, (cudaStream_t)stream>>>(
            (float*)stats, (float*)prior, (int32_t*)children,
            (const int32_t*)path, (const int32_t*)meta, (const uint8_t*)valid,
            (const float*)probs, (const float*)value, slot, B, N, A, dcap);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
