// The per-simulation search kernels (one thread per game).
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
// Both run the same __device__ apply_update.  The network forward runs
// between launches, outside these kernels.
//
// Bound on this card: per game a launch reads a few hundred bytes per walk
// step (the node's A edges and its children's stats) and writes the leaf's
// observation (F·RC floats) — tens of KB per launch in all at B=512, far
// under a microsecond at HBM rate, with a few thousand float operations.
// What bounds them is latency: B threads (4 CTAs at B=512) each walk a chain
// of dependent L2 reads whose length is the tree depth, and a warp runs
// until its deepest game stops.  The design keeps each game in one thread
// so the walk needs no synchronisation and no one-hot gathers (the TPU
// kernel's games-in-lanes layout, with its O(A·N) contractions per step);
// the tree (~7 MB at B=512, S=200 for connect4) stays in device memory and
// in L2.  The leaf board lives in local memory (RC ≤ 256 cells).
//
// Numerics: built with -fmad=false; every float operation is a
// round-to-nearest intrinsic in the order of the plain PyTorch versions in
// search/sim.py and search/mcts.py (ucb, descend, expand_backup), so results
// agree bit for bit.  The tree layout is search/tree.py's: stats (B, N, 3)
// [visit, value sum, expanded], prior (B, N, A) float32 (NEG at illegal
// actions), children (B, N, A) int32 (-1 = no child).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NEG (-1e30f)
#define MAX_CELLS 256
#define MAX_COLS 32
#define META_COLS 8
// a game's move rules (envs/core.py: Env.rules); 0 = a move fills its cell
#define RULES_GRAVITY 1
#define RULES_NEIGHBOURHOOD 2

namespace {

// expansion into slot ``slot`` and backup of the simulation recorded in
// path/meta/valid with its network output probs/value (game b)
__device__ void apply_update(int b, float* stats, float* prior,
                             int32_t* children, const int32_t* path,
                             const int32_t* meta, const uint8_t* valid,
                             const float* probs, const float* value, int slot,
                             int N, int A, int dcap) {
  if (slot < 1) return;  // the first launch has nothing to flush
  const int32_t* m = meta + (size_t)b * META_COLS;
  const int depth = m[0], parent = m[1], action = m[2], leaf = m[4];
  const bool alloc = m[3] != 0, terminal = m[5] != 0, won = m[6] != 0;
  const bool do_expand = alloc && !terminal;
  float* pr = prior + ((size_t)b * N + slot) * A;
  for (int a = 0; a < A; ++a)
    pr[a] = (do_expand && valid[(size_t)b * A + a]) ? probs[(size_t)b * A + a]
                                                     : NEG;
  if (alloc) children[((size_t)b * N + parent) * A + action] = slot;
  const float lv = terminal ? (won ? 1.0f : 0.0f) : -value[b];
  const int32_t* pa = path + (size_t)b * dcap;
  float* st = stats + (size_t)b * N * 3;
  for (int d = 0; d <= depth; ++d) {
    const int nd = d == depth ? leaf : pa[d];
    float* s = st + (size_t)nd * 3;
    s[0] = __fadd_rn(s[0], 1.0f);
    s[1] = __fadd_rn(s[1], ((depth - d) % 2 == 0) ? lv : -lv);
    s[2] = __fadd_rn(s[2], (d == depth && do_expand) ? 1.0f : 0.0f);
  }
}

__device__ __forceinline__ bool any_line(const uint8_t* plane,
                                         const int32_t* lines, int L, int K) {
  for (int l = 0; l < L; ++l) {
    bool all = true;
    for (int k = 0; k < K && all; ++k) all = plane[lines[l * K + k]] != 0;
    if (all) return true;
  }
  return false;
}

__global__ void sim_step_kernel(
    float* stats, float* prior, int32_t* children, const int8_t* board,
    const int32_t* player, const int32_t* mc, const int32_t* lines,
    int32_t* path, int32_t* apath, int32_t* meta, uint8_t* valid, float* obs,
    const float* probs, const float* value, int prev_slot, int slot, int B,
    int N, int A, int R, int C, int F, int L, int K, int dcap, int max_moves,
    int rules, int az, float c_puct) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int RC = R * C;
  // ---- the previous simulation's update (reads the previous path/meta/valid)
  apply_update(b, stats, prior, children, path, meta, valid, probs, value,
               prev_slot, N, A, dcap);

  // ---- this simulation's descent, the leaf board built in the walk
  const float* st = stats + (size_t)b * N * 3;
  int32_t* pa = path + (size_t)b * dcap;
  int32_t* ap = apath + (size_t)b * dcap;
  for (int d = 0; d < dcap; ++d) {
    pa[d] = N;
    ap[d] = 0;
  }
  uint8_t planes[2][MAX_CELLS];
  const int8_t* bd = board + (size_t)b * 2 * RC;
  for (int c = 0; c < RC; ++c) {
    planes[0][c] = (uint8_t)bd[c];
    planes[1][c] = (uint8_t)bd[RC + c];
  }
  int h[MAX_COLS];
  if (rules == RULES_GRAVITY) {
    for (int c = 0; c < C; ++c) {
      int s = 0;
      for (int r = 0; r < R; ++r) s += planes[0][r * C + c] + planes[1][r * C + c];
      h[c] = s;
    }
  }
  const int rootp = player[b];
  int node = 0, depth = 0, parent = -1, action = 0, chsel = 0;
  float pv = st[0];
  bool stop = st[2] == 0.0f;  // an unexpanded (finished) root is the leaf
  for (int d = 0; d < dcap && !stop; ++d) {
    const int32_t* ch = children + ((size_t)b * N + node) * A;
    const float* pr = prior + ((size_t)b * N + node) * A;
    const float sq = __fsqrt_rn(pv);
    float best = -INFINITY, v_sel = 0.0f, e_sel = 0.0f;
    int act = 0, c_sel = 0;
    for (int a = 0; a < A; ++a) {
      const int c = ch[a];
      float cv = 0.0f, cl = 0.0f, ce = 0.0f;
      if (c >= 0) {
        cv = st[(size_t)c * 3];
        cl = st[(size_t)c * 3 + 1];
        ce = st[(size_t)c * 3 + 2];
      }
      const float q = cv > 0.0f ? __fdiv_rn(cl, fmaxf(cv, 1.0f)) : 0.0f;
      float ex = __fmul_rn(pr[a], __fdiv_rn(sq, __fadd_rn(cv, 1.0f)));
      if (az) ex = __fmul_rn(c_puct, ex);
      const float u = __fadd_rn(q, ex);
      if (u > best) {  // first maximum in ascending action order
        best = u;
        act = a;
        c_sel = c;
        v_sel = cv;
        e_sel = ce;
      }
    }
    const bool now_stop = c_sel < 0 || e_sel == 0.0f;
    pa[d] = node;
    ap[d] = act;
    parent = node;
    action = act;
    chsel = c_sel;
    depth = d + 1;
    if (!now_stop) node = c_sel;
    pv = v_sel;
    // play the selected move on the walk's board
    const int mover = (rootp + d) & 1;
    if (rules == RULES_GRAVITY) {
      if (h[act] < R) planes[mover][(R - 1 - h[act]) * C + act] = 1;
      h[act] += 1;
    } else {
      planes[mover][act] = 1;
    }
    stop = now_stop;
  }

  // ---- the leaf: terminal check, node, legal mask, observation
  const bool root_case = parent < 0;
  const bool alloc = parent >= 0 && chsel < 0;
  const int leaf_player = (rootp + depth) & 1;
  const bool won = any_line(planes[1 - leaf_player], lines, L, K);
  const bool terminal = root_case || won || mc[b] + depth >= max_moves;
  int32_t* md = meta + (size_t)b * META_COLS;
  md[0] = depth;
  md[1] = parent;
  md[2] = action;
  md[3] = alloc;
  md[4] = root_case ? 0 : (alloc ? slot : chsel);
  md[5] = terminal;
  md[6] = won;
  md[7] = leaf_player;
  uint8_t* vd = valid + (size_t)b * A;
  if (rules == RULES_GRAVITY) {
    for (int a = 0; a < A; ++a) vd[a] = h[a] < R;
  } else if (rules == RULES_NEIGHBOURHOOD) {
    bool any = false;
    for (int c = 0; c < RC; ++c) any = any || planes[0][c] || planes[1][c];
    for (int c = 0; c < RC; ++c) {
      const int r = c / C, k = c % C;
      bool near = false;
      for (int dr = -1; dr <= 1; ++dr)
        for (int dk = -1; dk <= 1; ++dk) {
          const int rr = r + dr, kk = k + dk;
          if (rr >= 0 && rr < R && kk >= 0 && kk < C)
            near = near || planes[0][rr * C + kk] || planes[1][rr * C + kk];
        }
      const bool empty = !planes[0][c] && !planes[1][c];
      vd[c] = any ? (near && empty) : (c == (R / 2) * C + C / 2);
    }
  } else {
    for (int c = 0; c < RC; ++c) vd[c] = !planes[0][c] && !planes[1][c];
  }
  float* o = obs + (size_t)b * F * RC;
  for (int c = 0; c < RC; ++c) {
    o[c] = (float)planes[leaf_player][c];
    o[RC + c] = (float)planes[1 - leaf_player][c];
    if (F == 3) o[2 * RC + c] = (float)leaf_player;
  }
}

__global__ void sim_flush_kernel(float* stats, float* prior,
                                 int32_t* children, const int32_t* path,
                                 const int32_t* meta, const uint8_t* valid,
                                 const float* probs, const float* value,
                                 int slot, int B, int N, int A, int dcap) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  apply_update(b, stats, prior, children, path, meta, valid, probs, value,
               slot, N, A, dcap);
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

const char* az_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int az_sim_step(void* stats, void* prior, void* children, const void* board,
                const void* player, const void* mc, const void* lines,
                void* path, void* apath, void* meta, void* valid, void* obs,
                const void* probs, const void* value, int prev_slot, int slot,
                int B, int N, int A, int R, int C, int F, int L, int K,
                int dcap, int max_moves, int rules, int az, float c_puct,
                void* stream) {
  if (R * C > MAX_CELLS || (rules == RULES_GRAVITY && C > MAX_COLS))
    return (int)cudaErrorInvalidValue;
  sim_step_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)stats, (float*)prior, (int32_t*)children, (const int8_t*)board,
      (const int32_t*)player, (const int32_t*)mc, (const int32_t*)lines,
      (int32_t*)path, (int32_t*)apath, (int32_t*)meta, (uint8_t*)valid,
      (float*)obs, (const float*)probs, (const float*)value, prev_slot, slot,
      B, N, A, R, C, F, L, K, dcap, max_moves, rules, az, c_puct);
  return (int)cudaGetLastError();
}

int az_sim_flush(void* stats, void* prior, void* children, const void* path,
                 const void* meta, const void* valid, const void* probs,
                 const void* value, int slot, int B, int N, int A, int dcap,
                 void* stream) {
  sim_flush_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)stats, (float*)prior, (int32_t*)children, (const int32_t*)path,
      (const int32_t*)meta, (const uint8_t*)valid, (const float*)probs,
      (const float*)value, slot, B, N, A, dcap);
  return (int)cudaGetLastError();
}

}  // extern "C"
