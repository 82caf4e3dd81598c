// Search kernels of the whole-chunk self-play and of the move search.
//
// Replaces: alphazero_tpu/search/pallas_fused.py:_chunk_kernel (the Pallas
// kernel that plays M whole self-play moves per launch) and _move_kernel
// (one move's simulations from a host-evaluated root, which the arena and
// the gate run), except their dense forward, which is csrc/dense_forward.cu.
// The chunk's stages:
//   az_root_obs      canonical root observation (+ its int8 record) of
//                    the chunk's first move; az_move_tail writes those of
//                    every later move
//   az_root_init     Dirichlet mix, legal mask, root edges, tree init
//   az_descend_leaf  PUCT walk with the leaf board built in the walk, leaf
//                    terminal check, legal mask and canonical observation
//                    (pallas_mcts._descend + _leaf_finish)
//   az_apply         expansion into the simulation's slot and backup
//                    (pallas_fused._apply_sim)
//   az_move_tail     root counts and root Q, inverse-CDF / argmax action,
//                    env step, records, reset, and the next move's root
//                    observation and its record (pallas_fused._root_counts,
//                    _sample_from_counts, the end of _chunk_kernel and the
//                    root observation at its start, :866-874)
// The move search runs az_move_root_init (root from the host's prior, value
// and live flag: a finished game's root stays unexpanded, so every
// simulation ends at the root as a terminal leaf), then az_descend_leaf /
// the forward / az_apply per simulation as above, then az_root_counts
// (counts, policy and root Q; pallas_fused._root_counts).
//
// Bound on this card: none of them moves more than a few hundred KB or does
// more than a few thousand operations per game (bounds well under 1 µs at
// B=512), so what bounds them is latency.  In the walk it is a chain of
// dependent reads per step: the node's A edges (child, prior), then the
// children's visit and value; the tree (≈ 67 MB at gomoku9, B=256, S=400)
// does not all stay in the 50 MB L2.
//
// Layout of the group kernels (az_root_init, az_descend_leaf, az_apply,
// az_move_tail, az_root_counts; walk.cuh, shared with sim.cu): a group of G
// lanes serves one game, G a power of two from the action count
// (group_size: 8 up to A=8, 16 up to 16, else 32, the most a warp shuffle
// spans), so a warp holds 32/G games and a CTA of kThreads lanes
// kThreads/G.  A walk step reads the node's A edges spread over the lanes
// (coalesced, at most MAX_A/32 a lane), each lane keeps its first maximum
// of the UCB in ascending action order, and a butterfly of shuffles over
// the group reduces (u, action) to the larger u, on a tie the lower action:
// the serial loop's first maximum.  The winner's lane broadcasts its child,
// visit count and expanded bit.  Games of one warp stop at different
// depths, so the loop runs while any game of the warp walks (__any_sync)
// and a stopped or idle group (past B on the last CTA) runs on and writes
// nothing.  The walk's board is two planes per game in shared memory (and
// the column heights under gravity), played on by lane 0; the leaf finish
// spreads the path reset (lanes over plies), the win check (lanes over
// lines, then a ballot over the group), the legal mask (lanes over actions)
// and the observation (lanes over cells, coalesced) over the group.
// az_apply writes the new row's edges with lanes over actions and backs up
// with lanes over plies: the nodes of one path are distinct, so each gets
// its one addition as in the serial loop.  az_root_init and az_move_tail,
// once per move, spread the root's edges, the tree rows, the board's cells
// and lines and the records over the group the same way; the tail's one
// serial stage is the inverse-CDF running sum.  The tail and az_root_counts
// share the root's counting stage (root_edges, group_root_counts: lanes
// over the root's edges, one round of dependent visit loads, counts in
// registers, a shuffle sum).  az_move_root_init is elementwise: 16-byte
// stores of the tree rows and lanes over the root's edges (its note below).
// The tail also writes the next move's root observation, lanes over cells
// from stones kept in registers, so the chunk's az_root_obs (a thread per
// element) runs for its first move alone.
//
// Games: the move rules (envs/core.py: Env.rules) are a template parameter
// of the kernels that place a stone or build a legal mask (az_root_init,
// az_descend_leaf, az_move_tail), so each game's walk is compiled on its
// own: gravity (a move drops down its column, a column with room is legal),
// cells (a move fills its cell, an empty cell is legal: tictactoe),
// neighbourhood (as cells, but an empty cell is legal only next to a stone,
// and the centre alone on an empty board: gomoku).  Limits: boards of up to
// 256 cells, 32 columns under gravity, 128 actions (the cap of the dense
// forward's softmax, checked here too).
//
// Numerics: this file is built with -fmad=false and writes the float32
// operations with round-to-nearest intrinsics, in the order of the plain
// PyTorch versions in search/fused.py, so that results agree bit for bit; a
// shuffle moves a value without changing it.  The tree layout is described
// in search/fused.py.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "walk.cuh"

#define NO_CHILD (-1)
#define ILLEGAL (-2)
#define NEG_UCB (-1e30f)
// the most actions these kernels take (search/fused.py:supports_chunk
// mirrors the games they take)
#define MAX_A 128
#define PEND_COLS 7

constexpr int kThreads = 128;  // threads per CTA
// the most bytes of the (L, K) line table az_move_tail stages in shared
// memory: 4096 entries, above the ≈ 3,700 of the largest table a game the
// kernels take can have (256 cells, 32 columns under gravity)
constexpr size_t kLineBytes = 16384;

namespace {

__device__ __forceinline__ float qprior(float p) {
  return __fmul_rn(floorf(__fadd_rn(__fmul_rn(p, 16384.0f), 0.5f)),
                   1.0f / 16384.0f);
}

__global__ void root_obs_kernel(const int8_t* board, const int32_t* player,
                                float* obs, int8_t* rec_obs, int B, int RC,
                                int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * RC) return;
  const int b = i / RC, c = i % RC;
  const int p = player[b];
  const int8_t* bd = board + (size_t)b * 2 * RC;
  const int8_t mine = bd[p * RC + c], theirs = bd[(1 - p) * RC + c];
  float* o = obs + (size_t)b * F * RC;
  int8_t* ro = rec_obs + (size_t)b * F * RC;
  o[c] = (float)mine;
  o[RC + c] = (float)theirs;
  ro[c] = mine;
  ro[RC + c] = theirs;
  if (F == 3) {
    o[2 * RC + c] = (float)p;
    ro[2 * RC + c] = (int8_t)p;
  }
}

// ---- the per-simulation kernels: a group of G lanes per game (walk.cuh)

template <int RULES, int G>
__global__ void __launch_bounds__(kThreads) descend_leaf_kernel(
    const float* visit, const float* val, const int32_t* child,
    const float* prior, const int8_t* board, const int32_t* player,
    const int32_t* mc, const int32_t* lines, int32_t* path, int32_t* apath,
    int32_t* pend, uint8_t* valid, float* obs, int B, int N, int A, int R,
    int C, int F, int L, int K, int dcap, int max_moves, int slot, int az,
    float c_puct) {
  constexpr int kGames = kThreads / G;
  constexpr int kEdges = G == 32 ? MAX_A / 32 : 1;  // edges a lane reads
  __shared__ uint8_t s_planes[kGames][2 * MAX_CELLS];
  __shared__ int s_h[RULES == RULES_GRAVITY ? kGames : 1][MAX_COLS];
  const int gi = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * kGames + gi;
  const bool active = b < B;
  const int bc = active ? b : B - 1;  // an idle group reads in range
  const unsigned gmask = group_mask<G>();
  const int RC = R * C;
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
  // ply d of the path is reset, then written by lane d % G
  int32_t* pa = path + (size_t)b * dcap;
  int32_t* ap = apath + (size_t)b * dcap;
  if (active)
    for (int d = lane; d < dcap; d += G) {
      pa[d] = N;
      ap[d] = 0;
    }
  __syncwarp();
  const float* vs = visit + (size_t)bc * N;
  const float* vl = val + (size_t)bc * N;
  const int rootp = player[bc];

  int node = 0, depth = 0, parent = -1, action = 0, chsel = 0;
  float pv = floorf(vs[0]);
  bool stop = !active || vs[0] == pv;  // root not expanded
  for (int d = 0; d < dcap && __any_sync(kFull, !stop); ++d) {
    // this lane's edges: its first maximum in ascending action order
    float best = -INFINITY, v_best = 0.0f, e_best = 0.0f;
    int act = INT_MAX, c_best = 0;
    if (!stop) {
      const int32_t* ch = child + ((size_t)bc * N + node) * A;
      const float* pr = prior + ((size_t)bc * N + node) * A;
      const float sq = __fsqrt_rn(pv);
      int cs[kEdges];
      float ps[kEdges], cvs[kEdges], cls[kEdges];
#pragma unroll
      for (int k = 0; k < kEdges; ++k) {  // the edges, then their children
        const int a = lane + k * G;
        cs[k] = a < A ? ch[a] : ILLEGAL;
        ps[k] = a < A ? pr[a] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kEdges; ++k) {
        cvs[k] = cs[k] >= 0 ? vs[cs[k]] : 0.0f;
        cls[k] = cs[k] >= 0 ? vl[cs[k]] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kEdges; ++k) {
        const int a = lane + k * G;
        const float cf = floorf(cvs[k]);
        const float ce = __fmul_rn(__fsub_rn(cvs[k], cf), 2.0f);
        const float q =
            cf > 0.0f ? __fdiv_rn(cls[k], fmaxf(cf, 1.0f)) : 0.0f;
        float ex = __fmul_rn(ps[k], __fdiv_rn(sq, __fadd_rn(cf, 1.0f)));
        if (az) ex = __fmul_rn(c_puct, ex);
        const float u = cs[k] == ILLEGAL ? NEG_UCB : __fadd_rn(q, ex);
        if (a < A && u > best) {
          best = u;
          act = a;
          c_best = cs[k];
          v_best = cf;
          e_best = ce;
        }
      }
    }
    // the group's maximum of (u, -action): the first maximum of the row
    group_first_max<G>(best, act);
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
  const bool root_case = parent < 0;
  const bool alloc = parent >= 0 && chsel < 0;
  const int leaf_player = (rootp + depth) & 1;
  // the win check: lanes over lines, a ballot over the group
  const uint8_t* last = pl + (1 - leaf_player) * RC;
  bool line = false;
  for (int l = lane; l < L; l += G) {
    bool all = true;
    for (int k = 0; k < K; ++k) all = all && last[lines[l * K + k]];
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
  const int leaf = root_case ? 0 : (alloc ? slot : chsel);
  if (lane < PEND_COLS)
    pend[(size_t)b * PEND_COLS + lane] =
        lane == 0 ? depth : lane == 1 ? parent : lane == 2 ? action
        : lane == 3 ? (int)alloc : lane == 4 ? leaf
        : lane == 5 ? (int)terminal : (int)won;
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
__global__ void __launch_bounds__(kThreads) apply_kernel(
    float* visit, float* val, int32_t* child, float* prior,
    const int32_t* path, const int32_t* pend, const uint8_t* valid,
    const float* probs, const float* value, int B, int N, int A, int dcap,
    int slot) {
  const int lane = threadIdx.x % G;
  const int b = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (b >= B) return;
  const int32_t* pd = pend + (size_t)b * PEND_COLS;
  const int depth = pd[0], parent = pd[1], action = pd[2];
  const bool alloc = pd[3] != 0, terminal = pd[5] != 0, won = pd[6] != 0;
  const int leaf = pd[4];
  const bool do_expand = alloc && !terminal;
  int32_t* ch = child + (size_t)b * N * A;
  float* pr = prior + (size_t)b * N * A;
  for (int a = lane; a < A; a += G) {
    const bool e = do_expand && valid[(size_t)b * A + a];
    ch[(size_t)slot * A + a] = e ? NO_CHILD : ILLEGAL;
    pr[(size_t)slot * A + a] = e ? qprior(probs[(size_t)b * A + a]) : 0.0f;
  }
  if (alloc && lane == 0) ch[(size_t)parent * A + action] = slot;
  const float lv = terminal ? (won ? 1.0f : 0.0f) : -value[b];
  float* vs = visit + (size_t)b * N;
  float* vl = val + (size_t)b * N;
  const int32_t* pa = path + (size_t)b * dcap;
  // the plies of one path hold distinct nodes: one addition each
  for (int d = lane; d <= depth; d += G) {
    const int nd = d == depth ? leaf : pa[d];
    vs[nd] = __fadd_rn(vs[nd], (d == depth && do_expand) ? 1.5f : 1.0f);
    vl[nd] = __fadd_rn(vl[nd], ((depth - d) % 2 == 0) ? lv : -lv);
  }
}

// ---- the two ends of a chunk move: a group of G lanes per game (walk.cuh)
//
// Both are latency-bound (a few KB per game): each issues every load that
// depends on nothing else first, so that they share one trip to memory, and
// loops of a fixed trip count (kEdges actions a lane) unroll.

// Whether a stone lies in the 3x3 block around cell a of the occupancy
// plane occ: the nine reads go out together (walk.cuh's legal, which the
// walk calls on two planes, stops at the first stone it meets: a chain of
// dependent reads that took most of the root's time at gomoku's A=81).
__device__ __forceinline__ bool near_stone(const uint8_t* occ, int a, int R,
                                           int C) {
  const int r = a / C, k = a - r * C;
  bool near = false;
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
    for (int dk = -1; dk <= 1; ++dk) {
      const int rr = r + dr, kk = k + dk;
      const bool in = rr >= 0 && rr < R && kk >= 0 && kk < C;
      near |= in & (occ[in ? rr * C + kk : a] != 0);
    }
  return near;
}

// The root of a move.  Lanes over actions read the priors and the noise,
// lanes over cells stage the board's occupancy in shared memory (under
// gravity lanes over columns count the heights instead) and a ballot over
// the group says whether a stone is down; lanes over actions then mix in
// the noise, check legality (the rule of walk.cuh's legal) and write the
// root's edges (row 0 of child and prior: the rows below stay as they
// are); lanes over nodes zero the game's visit and val rows, coalesced,
// the lane of node 0 writing the root's 1.5 and -value.  The noise (A, B)
// is read strided by B, a lane an action row: at most 83 KB per launch at
// the presets.
template <int RULES, int G>
__global__ void __launch_bounds__(kThreads) root_init_kernel(
    float* visit, float* val, int32_t* child, float* prior,
    const float* probs, const float* value, const float* noise,
    const int8_t* board, int B, int N, int A, int R, int C, float eps) {
  constexpr int kGames = kThreads / G;
  constexpr int kEdges = G == 32 ? MAX_A / 32 : 1;  // actions a lane takes
  constexpr bool kGravity = RULES == RULES_GRAVITY;
  __shared__ uint8_t s_occ[kGravity ? 1 : kGames][MAX_CELLS];
  __shared__ int s_h[kGravity ? kGames : 1][MAX_COLS];
  const int gi = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * kGames + gi;
  const bool active = b < B;
  const int bc = active ? b : B - 1;  // an idle group reads in range
  const int RC = R * C;
  const float v0 = -value[bc];
  float pin[kEdges], nz[kEdges];
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    const int a = lane + k * G;
    pin[k] = a < A ? probs[(size_t)bc * A + a] : 0.0f;
    nz[k] = noise != nullptr && a < A ? noise[(size_t)a * B + bc] : 0.0f;
  }
  const int8_t* bd = board + (size_t)bc * 2 * RC;
  uint8_t* occ = s_occ[kGravity ? 0 : gi];
  int* h = s_h[kGravity ? gi : 0];
  bool stone = false;
  if (kGravity) {
#pragma unroll
    for (int k = 0; k < kEdges; ++k) {  // C = A columns
      const int c = lane + k * G;
      if (c < C) {
        int s = 0;
        for (int r = 0; r < R; ++r) s += bd[r * C + c] + bd[RC + r * C + c];
        h[c] = s;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kEdges; ++k) {  // RC = A cells
      const int c = lane + k * G;
      if (c < RC) {
        const bool v = (bd[c] | bd[RC + c]) != 0;  // both reads go out
        occ[c] = v;
        stone = stone || v;
      }
    }
  }
  const bool any = RULES == RULES_NEIGHBOURHOOD &&
                   (__ballot_sync(kFull, stone) & group_mask<G>()) != 0;
  __syncwarp();
  if (!active) return;
  const float one_m = __fsub_rn(1.0f, eps);
  int32_t* ch = child + (size_t)b * N * A;
  float* pr = prior + (size_t)b * N * A;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    const int a = lane + k * G;
    if (a < A) {
      const float p = noise != nullptr
          ? __fadd_rn(__fmul_rn(one_m, pin[k]), __fmul_rn(eps, nz[k]))
          : pin[k];
      bool ok;
      if (kGravity) {
        ok = h[a] < R;
      } else {
        ok = !occ[a];
        if (RULES == RULES_NEIGHBOURHOOD)
          ok = ok && (any ? near_stone(occ, a, R, C)
                          : a == (R / 2) * C + C / 2);
      }
      ch[a] = ok ? NO_CHILD : ILLEGAL;
      pr[a] = ok ? qprior(p) : 0.0f;
    }
  }
  float* vs = visit + (size_t)b * N;
  float* vl = val + (size_t)b * N;
  for (int n = lane; n < N; n += G) {
    vs[n] = n == 0 ? 1.5f : 0.0f;
    vl[n] = n == 0 ? v0 : 0.0f;
  }
}

// The root's counting stage of the tail and of az_root_counts.  Lane
// `lane` of a game's group takes the root edges a = lane + k·G (k < E):
// root_edges loads them (coalesced, independent: they go out together, an
// edge past A is ILLEGAL), group_root_counts then loads their children's
// visits in one round, keeps floor(visit) of each edge with a child (0
// otherwise) in registers and sums the counts over the group by shuffles
// (integer counts far below 2^24: exact in any order).  It returns the
// policy's divisor, max(Σ counts, 1) as float32.
template <int G, int E>
__device__ __forceinline__ void root_edges(const int32_t* ch0, int A,
                                           int lane, int32_t (&cs)[E]) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int a = lane + k * G;
    cs[k] = a < A ? ch0[a] : ILLEGAL;
  }
}

template <int G, int E>
__device__ __forceinline__ float group_root_counts(const float* vs,
                                                   const int32_t (&cs)[E],
                                                   float (&cnt)[E]) {
#pragma unroll
  for (int k = 0; k < E; ++k) cnt[k] = cs[k] >= 0 ? floorf(vs[cs[k]]) : 0.0f;
  int tot = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) tot += (int)cnt[k];
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    tot += __shfl_xor_sync(kFull, tot, off, G);
  return fmaxf((float)tot, 1.0f);
}

// root Q: the root's value over its visits, floor(visit) at least 1
__device__ __forceinline__ float root_q_of(float root_l, float root_v) {
  return __fdiv_rn(root_l, fmaxf(floorf(root_v), 1.0f));
}

// The end of a move.  The counting stage above (the root's children's
// counts in registers, their total by a shuffle sum), then group_first_max
// gives the greedy action and a group max the last visited one.  Lanes
// over actions write the policy and keep it in shared memory, lanes over
// cells stage the board, lanes over columns count the heights under
// gravity, and the CTA copies the game's lines into shared memory.  Every
// lane then adds p_0 ... p_{A-1} in ascending action order from shared
// memory: the plain version's float32 running sum, whose bits depend on
// the order (no parallel scan), for the inverse-CDF sample.  Lane 0 plays
// the move on the staged plane (under gravity only into a column with
// room: the fallback with no visits may name a full one), lanes over lines
// check for a win (a ballot over the group), one lane writes each record,
// and a finished game's board is zeroed with lanes over cells, where an
// unfinished one gains its stone.  Unless obs_next is null (the chunk's
// last move), lanes over cells then write the next move's root
// observation (B, F·RC) and its int8 record: the new mover 1 − p's plane,
// p's plane with the new stone and, at F = 3, a plane of 1 − p; a finished
// game's is an empty board with player 0.  Each lane keeps the stones of
// the cells it staged as bits of a register (2·RC/G ≤ 64 of them), and
// the lane of the new stone's cell sets its bit, so the stores read
// nothing (a loop that read each cell back from shared memory before its
// stores added 1.2-1.3 µs to the tail at connect4 B=512 on an H100).
template <int RULES, int G>
__global__ void __launch_bounds__(kThreads) move_tail_kernel(
    const float* visit, const float* val, const int32_t* child,
    const float* unif, int8_t* board, int32_t* player, int32_t* mc,
    const int32_t* lines, float* r_policy, int32_t* r_player, int32_t* r_t,
    int32_t* r_action, uint8_t* r_done, int32_t* r_winner, float* r_rootq,
    float* obs_next, int8_t* rec_obs_next, int B, int N, int A, int R, int C,
    int F, int L, int K, int max_moves, int temperature_moves) {
  constexpr int kGames = kThreads / G;
  constexpr int kEdges = G == 32 ? MAX_A / 32 : 1;  // edges a lane reads
  extern __shared__ int32_t s_lines[];  // (L, K): the game's lines
  // padded rows: the groups of a warp read the board and the policy in
  // other banks
  __shared__ uint8_t s_planes[kGames][2 * MAX_CELLS + 4];
  __shared__ float s_pol[kGames][MAX_A + 1];
  __shared__ int s_h[RULES == RULES_GRAVITY ? kGames : 1][MAX_COLS];
  const int gi = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * kGames + gi;
  const bool active = b < B;
  const int bc = active ? b : B - 1;  // an idle group reads in range
  const int RC = R * C;
  // the CTA's copy of the lines, copied without a trip through registers
  for (int i = threadIdx.x; i < L * K; i += kThreads)
    __pipeline_memcpy_async(s_lines + i, lines + i, sizeof(int32_t));
  __pipeline_commit();
  const float* vs = visit + (size_t)bc * N;
  const int32_t* ch0 = child + (size_t)bc * N * A;
  const int p = player[bc], m = mc[bc];
  const float u = unif[bc];
  const float root_v = vs[0], root_l = val[(size_t)bc * N];
  int32_t cs[kEdges];
  root_edges<G>(ch0, A, lane, cs);
  // both planes, so that the reads need not wait for the player; bit k of
  // `stones` is the stone on cell lane + k·G of the two planes
  int8_t* bd = board + (size_t)bc * 2 * RC;
  uint64_t stones = 0;
#pragma unroll 4
  for (int c = lane, k = 0; c < 2 * RC; c += G, ++k) {
    const int8_t v = bd[c];
    s_planes[gi][c] = (uint8_t)v;
    stones |= (uint64_t)(v != 0) << k;
  }
  uint8_t* pl = s_planes[gi] + p * RC;  // the mover's plane
  int* h = s_h[RULES == RULES_GRAVITY ? gi : 0];
  if (RULES == RULES_GRAVITY) {
#pragma unroll
    for (int k = 0; k < kEdges; ++k) {  // C = A columns
      const int c = lane + k * G;
      if (c < C) {
        int s = 0;
        for (int r = 0; r < R; ++r) s += bd[r * C + c] + bd[RC + r * C + c];
        h[c] = s;
      }
    }
  }
  float cnt[kEdges];
  const float total = group_root_counts<G>(vs, cs, cnt);
  // this lane's first maximum in ascending action order (counts are >= 0)
  // and its last visited action
  int greedy = INT_MAX, last = -1;
  float best = -1.0f;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    const int a = lane + k * G;
    if (a < A) {
      if (cnt[k] > best) {
        best = cnt[k];
        greedy = a;
      }
      if (cnt[k] > 0.0f) last = a;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, off, G));
  group_first_max<G>(best, greedy);
  float* pol = s_pol[gi];
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    const int a = lane + k * G;
    if (a < A) {
      const float q = __fdiv_rn(cnt[k], total);
      pol[a] = q;
      if (active) r_policy[(size_t)b * A + a] = q;
    }
  }
  __syncwarp();
  int act = greedy;
  if (m < temperature_moves) {
    // no early exit, so that the reads of the row run ahead of the sum's
    // chain
    float acc = 0.0f;
    int sampled = A;
#pragma unroll 8
    for (int a = 0; a < A; ++a) {
      acc = __fadd_rn(acc, pol[a]);
      if (sampled == A && acc > u) sampled = a;
    }
    act = sampled < A ? sampled : (last >= 0 ? last : greedy);
  }
  // the env step for the player to move: the new stone's cell in its
  // plane, or -1 when a full column takes none
  int cell = act;
  if (RULES == RULES_GRAVITY)
    cell = h[act] < R ? (R - 1 - h[act]) * C + act : -1;
  if (lane == 0 && cell >= 0) pl[cell] = 1;
  __pipeline_wait_prior(0);
  __syncthreads();  // the stone and the CTA's copy of the lines
  // the win check: lanes over lines, a ballot over the group (a line's
  // cells read without a branch, so that the reads overlap)
  bool line = false;
  for (int l = lane; l < L; l += G) {
    const int32_t* cells = s_lines + l * K;
    bool all = true;
#pragma unroll 4
    for (int k = 0; k < K; ++k) all &= pl[cells[k]] != 0;
    line |= all;
  }
  const bool won = (__ballot_sync(kFull, line) & group_mask<G>()) != 0;
  if (!active) return;
  const bool done = won || m + 1 >= max_moves;
  switch (lane) {
    case 0: r_player[b] = p; break;
    case 1: r_t[b] = m; break;
    case 2: r_action[b] = act; break;
    case 3: r_done[b] = done; break;
    case 4: r_winner[b] = won ? p : -1; break;
    case 5: r_rootq[b] = root_q_of(root_l, root_v); break;
    case 6: player[b] = done ? 0 : 1 - p; break;
    case 7: mc[b] = done ? 0 : m + 1; break;
  }
  if (done)
    for (int c = lane; c < 2 * RC; c += G) bd[c] = 0;
  else if (lane == 0 && cell >= 0)
    bd[p * RC + cell] = 1;
  if (obs_next == nullptr) return;
  // the next root: plane 1 - p to row 0, plane p with the stone to row 1
  const int sc = p * RC + cell;  // the new stone's cell in the two planes
  if (!done && cell >= 0 && sc % G == lane) stones |= 1ull << (sc / G);
  float* o = obs_next + (size_t)b * F * RC;
  int8_t* ro = rec_obs_next + (size_t)b * F * RC;
  for (int c = lane, k = 0; c < 2 * RC; c += G, ++k) {
    const int plane = c >= RC;
    const int e = (plane == p ? RC : 0) + c - plane * RC;
    const int x = done ? 0 : (int)((stones >> k) & 1);
    o[e] = (float)x;
    ro[e] = (int8_t)x;
  }
  const int q = done ? 0 : 1 - p;
  if (F == 3)
    for (int c = 2 * RC + lane; c < 3 * RC; c += G) {
      o[c] = (float)q;
      ro[c] = (int8_t)q;
    }
}

// ---- the move search (pallas_fused._move_kernel): the root comes from the
// host, then the sims above, then the root counts.

// The tree init from the host's root.  Its bound is some 0.5 MB of stores
// (≈ 0.16 µs): what costs is the launch and the work per element, so each
// thread writes four elements of both tree rows, visit and val (B·N
// contiguous floats, zero but at each row's node 0), as one 16-byte store
// each.  The game and node of the first element come from a float
// reciprocal of N corrected to the exact quotient (no divide), those of
// the next three from a running count; live and value are read only for an
// element at a row's node 0.  The threads past the rows write the roots'
// edges (row 0 of child and prior, the rows below stay as they are), a
// span of 2^shift ≥ A lanes per game (shift and mask, no divide),
// coalesced within a game.  The grid is at most one wave on the card (a
// grid-stride loop beyond that).
__global__ void __launch_bounds__(kThreads) move_root_init_kernel(
    float* visit, float* val, int32_t* child, float* prior,
    const float* root_prior, const float* value, const uint8_t* live, int B,
    int N, int A, int shift, float inv_n) {
  const int n = B * N;              // elements of a tree row array
  const int n4 = (n + 3) / 4;       // their 16-byte groups
  const int work = n4 + (B << shift);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < work;
       i += gridDim.x * kThreads) {
    if (i < n4) {
      const int e = 4 * i;
      int b = (int)((float)e * inv_n);  // floor(e / N), give or take one
      while (b * N > e) --b;
      while ((b + 1) * N <= e) ++b;
      int node = e - b * N;
      float vi[4], vl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool root = node == 0 && e + j < n;
        // both loads go out together: one trip to memory
        const bool lv = root && live[b] != 0;
        const float v = root ? value[b] : 0.0f;
        vi[j] = root ? (lv ? 1.5f : 1.0f) : 0.0f;
        vl[j] = lv ? -v : 0.0f;
        if (++node == N) {
          node = 0;
          ++b;
        }
      }
      if (e + 4 <= n) {
        reinterpret_cast<float4*>(visit)[i] =
            make_float4(vi[0], vi[1], vi[2], vi[3]);
        reinterpret_cast<float4*>(val)[i] =
            make_float4(vl[0], vl[1], vl[2], vl[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e + j < n) {
            visit[e + j] = vi[j];
            val[e + j] = vl[j];
          }
      }
    } else {
      const int u = i - n4;
      const int b = u >> shift, a = u & ((1 << shift) - 1);
      if (a < A) {
        const float rp = root_prior[(size_t)b * A + a];
        const bool ok = rp > -1e29f;
        child[(size_t)b * N * A + a] = ok ? NO_CHILD : ILLEGAL;
        prior[(size_t)b * N * A + a] = ok ? qprior(rp) : 0.0f;
      }
    }
  }
}

// The move search's root counts, policy and root Q: the tail's counting
// stage (root_edges, group_root_counts) in the group layout, the root's
// visit and value loaded with the edges; lanes over actions write the
// counts and the policy count / max(Σ, 1), coalesced, lane 0 the root Q.
template <int G>
__global__ void __launch_bounds__(kThreads) root_counts_kernel(
    const float* visit, const float* val, const int32_t* child,
    int32_t* counts, float* policy, float* root_q, int B, int N, int A) {
  constexpr int kGames = kThreads / G;
  constexpr int kEdges = G == 32 ? MAX_A / 32 : 1;  // edges a lane reads
  const int gi = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * kGames + gi;
  const bool active = b < B;
  const int bc = active ? b : B - 1;  // an idle group reads in range
  const float* vs = visit + (size_t)bc * N;
  const float root_v = vs[0], root_l = val[(size_t)bc * N];
  int32_t cs[kEdges];
  root_edges<G>(child + (size_t)bc * N * A, A, lane, cs);
  float cnt[kEdges];
  const float total = group_root_counts<G>(vs, cs, cnt);
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kEdges; ++k) {
    const int a = lane + k * G;
    if (a < A) {
      counts[(size_t)b * A + a] = (int32_t)cnt[k];
      policy[(size_t)b * A + a] = __fdiv_rn(cnt[k], total);
    }
  }
  if (lane == 0) root_q[b] = root_q_of(root_l, root_v);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// CTAs of the group kernels for B games
inline int group_blocks(int B, int A) {
  const int games = kThreads / group_size(A);
  return (B + games - 1) / games;
}

}  // namespace

extern "C" {

const char* az_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int az_root_obs(const void* board, const void* player, void* obs,
                void* rec_obs, int B, int RC, int F, void* stream) {
  root_obs_kernel<<<blocks_for(B * RC), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)board, (const int32_t*)player, (float*)obs,
      (int8_t*)rec_obs, B, RC, F);
  return (int)cudaGetLastError();
}

int az_root_init(void* visit, void* val, void* child, void* prior,
                 const void* probs, const void* value, const void* noise,
                 const void* board, int B, int N, int A, int R, int C,
                 int rules, float eps, void* stream) {
  return with_rules<MAX_A>(A, R, C, rules, [&](auto rl) {
    with_group(A, [&](auto gl) {
      root_init_kernel<decltype(rl)::value, decltype(gl)::value>
          <<<group_blocks(B, A), kThreads, 0, (cudaStream_t)stream>>>(
              (float*)visit, (float*)val, (int32_t*)child, (float*)prior,
              (const float*)probs, (const float*)value, (const float*)noise,
              (const int8_t*)board, B, N, A, R, C, eps);
    });
  });
}

// Launch geometry of the group kernels (az_root_init, az_descend_leaf,
// az_apply, az_move_tail, az_root_counts) for B games of A actions: out =
// {lanes per game, games per CTA, CTAs, threads per CTA}.
int az_search_geometry(int B, int A, int* out) {
  if (A < 1 || A > MAX_A || B < 1) return (int)cudaErrorInvalidValue;
  out[0] = group_size(A);
  out[1] = kThreads / out[0];
  out[2] = group_blocks(B, A);
  out[3] = kThreads;
  return 0;
}

int az_descend_leaf(const void* visit, const void* val, const void* child,
                    const void* prior, const void* board, const void* player,
                    const void* mc, const void* lines, void* path, void* apath,
                    void* pend, void* valid, void* obs, int B, int N, int A,
                    int R, int C, int F, int L, int K, int dcap, int max_moves,
                    int rules, int slot, int az, float c_puct, void* stream) {
  return with_rules<MAX_A>(A, R, C, rules, [&](auto rl) {
    with_group(A, [&](auto gl) {
      descend_leaf_kernel<decltype(rl)::value, decltype(gl)::value>
          <<<group_blocks(B, A), kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)visit, (const float*)val, (const int32_t*)child,
              (const float*)prior, (const int8_t*)board,
              (const int32_t*)player, (const int32_t*)mc,
              (const int32_t*)lines, (int32_t*)path, (int32_t*)apath,
              (int32_t*)pend, (uint8_t*)valid, (float*)obs, B, N, A, R, C, F,
              L, K, dcap, max_moves, slot, az, c_puct);
    });
  });
}

int az_apply(void* visit, void* val, void* child, void* prior,
             const void* path, const void* pend, const void* valid,
             const void* probs, const void* value, int B, int N, int A,
             int dcap, int slot, void* stream) {
  if (A < 1 || A > MAX_A) return (int)cudaErrorInvalidValue;
  with_group(A, [&](auto gl) {
    apply_kernel<decltype(gl)::value>
        <<<group_blocks(B, A), kThreads, 0, (cudaStream_t)stream>>>(
            (float*)visit, (float*)val, (int32_t*)child, (float*)prior,
            (const int32_t*)path, (const int32_t*)pend, (const uint8_t*)valid,
            (const float*)probs, (const float*)value, B, N, A, dcap, slot);
  });
  return (int)cudaGetLastError();
}

int az_move_tail(const void* visit, const void* val, const void* child,
                 const void* unif, void* board, void* player, void* mc,
                 const void* lines, void* r_policy, void* r_player, void* r_t,
                 void* r_action, void* r_done, void* r_winner, void* r_rootq,
                 void* obs_next, void* rec_obs_next, int B, int N, int A,
                 int R, int C, int F, int L, int K, int max_moves, int rules,
                 int temperature_moves, void* stream) {
  const size_t line_bytes = (size_t)L * K * sizeof(int32_t);
  if (L < 0 || K < 1 || line_bytes > kLineBytes ||
      (obs_next == nullptr) != (rec_obs_next == nullptr) ||
      (obs_next != nullptr && F != 2 && F != 3))
    return (int)cudaErrorInvalidValue;
  return with_rules<MAX_A>(A, R, C, rules, [&](auto rl) {
    with_group(A, [&](auto gl) {
      move_tail_kernel<decltype(rl)::value, decltype(gl)::value>
          <<<group_blocks(B, A), kThreads, line_bytes,
             (cudaStream_t)stream>>>(
              (const float*)visit, (const float*)val, (const int32_t*)child,
              (const float*)unif, (int8_t*)board, (int32_t*)player,
              (int32_t*)mc, (const int32_t*)lines, (float*)r_policy,
              (int32_t*)r_player, (int32_t*)r_t, (int32_t*)r_action,
              (uint8_t*)r_done, (int32_t*)r_winner, (float*)r_rootq,
              (float*)obs_next, (int8_t*)rec_obs_next, B, N, A, R, C, F, L, K,
              max_moves, temperature_moves);
    });
  });
}

int az_move_root_init(void* visit, void* val, void* child, void* prior,
                      const void* root_prior, const void* value,
                      const void* live, int B, int N, int A, void* stream) {
  if (B < 1 || N < 1 || A < 1 || A > MAX_A || (long long)B * N > (1 << 28) ||
      (((uintptr_t)visit | (uintptr_t)val) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < A) ++shift;
  // one wave: the CTAs the card holds at once (read once per device)
  static int wave_dev = -1, wave = 0;
  int d = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err == cudaSuccess && d != wave_dev) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, d);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, move_root_init_kernel, kThreads, 0);
    if (err == cudaSuccess && sms * per_sm < 1) err = cudaErrorInvalidValue;
    if (err == cudaSuccess) {
      wave = sms * per_sm;
      wave_dev = d;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int work = (B * N + 3) / 4 + (B << shift);
  const int blocks = blocks_for(work);
  move_root_init_kernel<<<blocks < wave ? blocks : wave, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (float*)visit, (float*)val, (int32_t*)child, (float*)prior,
      (const float*)root_prior, (const float*)value, (const uint8_t*)live, B,
      N, A, shift, 1.0f / (float)N);
  return (int)cudaGetLastError();
}

int az_root_counts(const void* visit, const void* val, const void* child,
                   void* counts, void* policy, void* root_q, int B, int N,
                   int A, void* stream) {
  if (B < 1 || A < 1 || A > MAX_A) return (int)cudaErrorInvalidValue;
  with_group(A, [&](auto gl) {
    root_counts_kernel<decltype(gl)::value>
        <<<group_blocks(B, A), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)visit, (const float*)val, (const int32_t*)child,
            (int32_t*)counts, (float*)policy, (float*)root_q, B, N, A);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
