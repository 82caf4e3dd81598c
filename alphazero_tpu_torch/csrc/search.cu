// Search kernels of the whole-chunk self-play and of the move search (one
// thread per game).
//
// Replaces: alphazero_tpu/search/pallas_fused.py:_chunk_kernel (the Pallas
// kernel that plays M whole self-play moves per launch) and _move_kernel
// (one move's simulations from a host-evaluated root, which the arena and
// the gate run), except their dense forward, which is csrc/dense_forward.cu.
// The chunk's stages:
//   az_root_obs      canonical root observation (+ its int8 record)
//   az_root_init     Dirichlet mix, legal mask, root edges, tree init
//   az_descend_leaf  PUCT walk with the leaf board built in the walk, leaf
//                    terminal check, legal mask and canonical observation
//                    (pallas_mcts._descend + _leaf_finish)
//   az_apply         expansion into the simulation's slot and backup
//                    (pallas_fused._apply_sim)
//   az_move_tail     root counts and root Q, inverse-CDF / argmax action,
//                    env step, records, reset (pallas_fused._root_counts,
//                    _sample_from_counts and the end of _chunk_kernel)
// The move search runs az_move_root_init (root from the host's prior, value
// and live flag: a finished game's root stays unexpanded, so every
// simulation ends at the root as a terminal leaf), then az_descend_leaf /
// the forward / az_apply per simulation as above, then az_root_counts
// (counts, policy and root Q; pallas_fused._root_counts).
//
// Bound on this card: none of them moves more than a few hundred KB or does
// more than a few thousand operations per game (bounds well under 1 µs at
// B=512), so what bounds them is latency: one thread per game, B=512
// threads on a handful of SMs, and in the walk a chain of dependent L2
// reads per step (the node's A edges, then its children's stats) that a
// warp repeats until its deepest game stops.  The design keeps each game's
// work in one thread so the walk needs no synchronisation and no one-hot
// gathers (the TPU kernel's games-in-lanes layout); the tree stays in
// device memory, ~6.6 MB at B=512, S=200, which lives in L2.  More games or
// lanes per walk step is the way to a shorter chain, later.
//
// Games: the move rules (envs/core.py: Env.rules) are a template parameter
// of the kernels that place a stone or build a legal mask (az_root_init,
// az_descend_leaf, az_move_tail), so each game's walk is compiled on its
// own and connect4's keeps its code: gravity (a move drops down its column,
// a column with room is legal), cells (a move fills its cell, an empty cell
// is legal: tictactoe), neighbourhood (as cells, but an empty cell is legal
// only next to a stone, and the centre alone on an empty board: gomoku).
// Limits: boards of up to 256 cells (the walk's two planes are per-thread
// arrays), 32 columns under gravity, 128 actions (the cap of the dense
// forward's softmax, checked here too); no per-thread array is sized by the
// actions, so A=81 (gomoku9) spills nothing beyond the planes.
//
// Numerics: this file is built with -fmad=false and writes the float32
// operations with round-to-nearest intrinsics, in the order of the plain
// PyTorch versions in search/fused.py, so that results agree bit for bit.
// The tree layout is described in search/fused.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define NO_CHILD (-1)
#define ILLEGAL (-2)
#define NEG_UCB (-1e30f)
#define MAX_CELLS 256
#define MAX_COLS 32
#define MAX_A 128
#define PEND_COLS 7
// a game's move rules (envs/core.py: Env.rules)
#define RULES_CELLS 0
#define RULES_GRAVITY 1
#define RULES_NEIGHBOURHOOD 2

namespace {

__device__ __forceinline__ float qprior(float p) {
  return __fmul_rn(floorf(__fadd_rn(__fmul_rn(p, 16384.0f), 0.5f)),
                   1.0f / 16384.0f);
}

__device__ __forceinline__ void column_heights(const int8_t* bd, int R, int C,
                                               int* h) {
  const int RC = R * C;
  for (int c = 0; c < C; ++c) {
    int s = 0;
    for (int r = 0; r < R; ++r) s += bd[r * C + c] + bd[RC + r * C + c];
    h[c] = s;
  }
}

__device__ __forceinline__ bool any_line(const uint8_t* plane,
                                         const int32_t* lines, int L, int K) {
  for (int l = 0; l < L; ++l) {
    bool all = true;
    for (int k = 0; k < K; ++k) all = all && plane[lines[l * K + k]];
    if (all) return true;
  }
  return false;
}

// Whether action a is legal on the board of planes p0/p1 (0/1 per cell)
// under the rules (cells and neighbourhood games: the action is the cell);
// h holds the column heights under gravity, any whether a stone is on the
// board (neighbourhood).
template <int RULES, class T>
__device__ __forceinline__ bool legal(const T* p0, const T* p1, const int* h,
                                      bool any, int a, int R, int C) {
  if (RULES == RULES_GRAVITY) return h[a] < R;
  if (p0[a] || p1[a]) return false;
  if (RULES == RULES_CELLS) return true;
  if (!any) return a == (R / 2) * C + C / 2;
  const int r = a / C, k = a % C;
  for (int rr = max(r - 1, 0); rr <= min(r + 1, R - 1); ++rr)
    for (int kk = max(k - 1, 0); kk <= min(k + 1, C - 1); ++kk)
      if (p0[rr * C + kk] || p1[rr * C + kk]) return true;
  return false;
}

template <class T>
__device__ __forceinline__ bool any_stone(const T* p0, const T* p1, int RC) {
  for (int c = 0; c < RC; ++c)
    if (p0[c] || p1[c]) return true;
  return false;
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

template <int RULES>
__global__ void root_init_kernel(float* visit, float* val, int32_t* child,
                                 float* prior, const float* probs,
                                 const float* value, const float* noise,
                                 const int8_t* board, int B, int N, int A,
                                 int R, int C, float eps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int RC = R * C;
  const int8_t* bd = board + (size_t)b * 2 * RC;
  int h[RULES == RULES_GRAVITY ? MAX_COLS : 1];
  if (RULES == RULES_GRAVITY) column_heights(bd, R, C, h);
  const bool any = RULES == RULES_NEIGHBOURHOOD && any_stone(bd, bd + RC, RC);
  const float one_m = __fsub_rn(1.0f, eps);
  int32_t* ch = child + (size_t)b * N * A;
  float* pr = prior + (size_t)b * N * A;
  for (int a = 0; a < A; ++a) {
    float p = probs[(size_t)b * A + a];
    if (noise != nullptr)
      p = __fadd_rn(__fmul_rn(one_m, p), __fmul_rn(eps, noise[(size_t)a * B + b]));
    const bool ok = legal<RULES>(bd, bd + RC, h, any, a, R, C);
    ch[a] = ok ? NO_CHILD : ILLEGAL;
    pr[a] = ok ? qprior(p) : 0.0f;
  }
  float* vs = visit + (size_t)b * N;
  float* vl = val + (size_t)b * N;
  for (int n = 0; n < N; ++n) {
    vs[n] = 0.0f;
    vl[n] = 0.0f;
  }
  vs[0] = 1.5f;
  vl[0] = -value[b];
}

template <int RULES>
__global__ void descend_leaf_kernel(
    const float* visit, const float* val, const int32_t* child,
    const float* prior, const int8_t* board, const int32_t* player,
    const int32_t* mc, const int32_t* lines, int32_t* path, int32_t* apath,
    int32_t* pend, uint8_t* valid, float* obs, int B, int N, int A, int R,
    int C, int F, int L, int K, int dcap, int max_moves, int slot, int az,
    float c_puct) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int RC = R * C;
  const float* vs = visit + (size_t)b * N;
  const float* vl = val + (size_t)b * N;
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
  int h[RULES == RULES_GRAVITY ? MAX_COLS : 1];
  if (RULES == RULES_GRAVITY) column_heights(bd, R, C, h);
  const int rootp = player[b];

  int node = 0, depth = 0, parent = -1, action = 0, chsel = 0;
  float pv = floorf(vs[0]);
  bool stop = vs[0] == pv;  // root not expanded
  for (int d = 0; d < dcap && !stop; ++d) {
    const int32_t* ch = child + ((size_t)b * N + node) * A;
    const float* pr = prior + ((size_t)b * N + node) * A;
    const float sq = __fsqrt_rn(pv);
    float best = -INFINITY, v_sel = 0.0f, e_sel = 0.0f;
    int act = 0, c_sel = 0;
    for (int a = 0; a < A; ++a) {
      const int c = ch[a];
      float cv = 0.0f, cl = 0.0f;
      if (c >= 0) {
        cv = vs[c];
        cl = vl[c];
      }
      const float cf = floorf(cv);
      const float ce = __fmul_rn(__fsub_rn(cv, cf), 2.0f);
      const float q = cf > 0.0f ? __fdiv_rn(cl, fmaxf(cf, 1.0f)) : 0.0f;
      float ex = __fmul_rn(pr[a], __fdiv_rn(sq, __fadd_rn(cf, 1.0f)));
      if (az) ex = __fmul_rn(c_puct, ex);
      const float u = c == ILLEGAL ? NEG_UCB : __fadd_rn(q, ex);
      if (u > best) {  // first maximum in ascending action order
        best = u;
        act = a;
        c_sel = c;
        v_sel = cf;
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
    if (RULES == RULES_GRAVITY) {
      if (h[act] < R) planes[mover][(R - 1 - h[act]) * C + act] = 1;
      h[act] += 1;
    } else {
      planes[mover][act] = 1;
    }
    stop = now_stop;
  }
  const bool root_case = parent < 0;
  const bool alloc = parent >= 0 && chsel < 0;
  const int leaf_player = (rootp + depth) & 1;
  const bool won = any_line(planes[1 - leaf_player], lines, L, K);
  const bool terminal = root_case || won || mc[b] + depth >= max_moves;
  const int leaf = root_case ? 0 : (alloc ? slot : chsel);
  int32_t* pd = pend + (size_t)b * PEND_COLS;
  pd[0] = depth;
  pd[1] = parent;
  pd[2] = action;
  pd[3] = alloc;
  pd[4] = leaf;
  pd[5] = terminal;
  pd[6] = won;
  const bool any =
      RULES == RULES_NEIGHBOURHOOD && any_stone(planes[0], planes[1], RC);
  for (int a = 0; a < A; ++a)
    valid[(size_t)b * A + a] =
        legal<RULES>(planes[0], planes[1], h, any, a, R, C);
  float* o = obs + (size_t)b * F * RC;
  for (int c = 0; c < RC; ++c) {
    o[c] = (float)planes[leaf_player][c];
    o[RC + c] = (float)planes[1 - leaf_player][c];
    if (F == 3) o[2 * RC + c] = (float)leaf_player;
  }
}

__global__ void apply_kernel(float* visit, float* val, int32_t* child,
                             float* prior, const int32_t* path,
                             const int32_t* pend, const uint8_t* valid,
                             const float* probs, const float* value, int B,
                             int N, int A, int dcap, int slot) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* pd = pend + (size_t)b * PEND_COLS;
  const int depth = pd[0], parent = pd[1], action = pd[2];
  const bool alloc = pd[3] != 0, terminal = pd[5] != 0, won = pd[6] != 0;
  const int leaf = pd[4];
  const bool do_expand = alloc && !terminal;
  int32_t* ch = child + (size_t)b * N * A;
  float* pr = prior + (size_t)b * N * A;
  for (int a = 0; a < A; ++a) {
    const bool e = do_expand && valid[(size_t)b * A + a];
    ch[(size_t)slot * A + a] = e ? NO_CHILD : ILLEGAL;
    pr[(size_t)slot * A + a] = e ? qprior(probs[(size_t)b * A + a]) : 0.0f;
  }
  if (alloc) ch[(size_t)parent * A + action] = slot;
  const float lv = terminal ? (won ? 1.0f : 0.0f) : -value[b];
  float* vs = visit + (size_t)b * N;
  float* vl = val + (size_t)b * N;
  const int32_t* pa = path + (size_t)b * dcap;
  for (int d = 0; d <= depth; ++d) {
    const int nd = d == depth ? leaf : pa[min(d, dcap - 1)];
    vs[nd] = __fadd_rn(vs[nd], (d == depth && do_expand) ? 1.5f : 1.0f);
    vl[nd] = __fadd_rn(vl[nd], ((depth - d) % 2 == 0) ? lv : -lv);
  }
}

template <int RULES>
__global__ void move_tail_kernel(
    const float* visit, const float* val, const int32_t* child,
    const float* unif, int8_t* board, int32_t* player, int32_t* mc,
    const int32_t* lines, float* r_policy, int32_t* r_player, int32_t* r_t,
    int32_t* r_action, uint8_t* r_done, int32_t* r_winner, float* r_rootq,
    int B, int N, int A, int R, int C, int L, int K, int max_moves,
    int temperature_moves) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int RC = R * C;
  const float* vs = visit + (size_t)b * N;
  const int32_t* ch0 = child + (size_t)b * N * A;
  // a root count is read again where it is needed, not kept in a
  // per-thread array of A entries
  auto count = [&](int a) { return ch0[a] >= 0 ? floorf(vs[ch0[a]]) : 0.0f; };
  float total = 0.0f, best = -1.0f;  // counts are >= 0
  int greedy = 0, last_visited = -1;
  for (int a = 0; a < A; ++a) {
    const float n = count(a);
    total = __fadd_rn(total, n);
    if (n > best) {  // the first maximum
      best = n;
      greedy = a;
    }
    if (n > 0.0f) last_visited = a;
  }
  total = fmaxf(total, 1.0f);
  const float rootq = __fdiv_rn(val[(size_t)b * N], fmaxf(floorf(vs[0]), 1.0f));
  const float u = unif[b];
  float acc = 0.0f;
  int sampled = A;
  for (int a = 0; a < A; ++a) {
    const float p = __fdiv_rn(count(a), total);
    r_policy[(size_t)b * A + a] = p;
    acc = __fadd_rn(acc, p);
    if (sampled == A && acc > u) sampled = a;
  }
  if (sampled >= A) sampled = last_visited >= 0 ? last_visited : greedy;
  const int m = mc[b];
  const int act = m < temperature_moves ? sampled : greedy;
  // env step for the player to move
  const int p = player[b];
  int8_t* bd = board + (size_t)b * 2 * RC;
  if (RULES == RULES_GRAVITY) {
    int h[MAX_COLS];
    column_heights(bd, R, C, h);
    if (h[act] < R) bd[p * RC + (R - 1 - h[act]) * C + act] = 1;
  } else {
    bd[p * RC + act] = 1;
  }
  uint8_t plane[MAX_CELLS];
  for (int c = 0; c < RC; ++c) plane[c] = (uint8_t)bd[p * RC + c];
  const bool won = any_line(plane, lines, L, K);
  const bool done = won || m + 1 >= max_moves;
  r_player[b] = p;
  r_t[b] = m;
  r_action[b] = act;
  r_done[b] = done;
  r_winner[b] = won ? p : -1;
  r_rootq[b] = rootq;
  if (done) {
    for (int c = 0; c < 2 * RC; ++c) bd[c] = 0;
    player[b] = 0;
    mc[b] = 0;
  } else {
    player[b] = 1 - p;
    mc[b] = m + 1;
  }
}

// ---- the move search (pallas_fused._move_kernel): the root comes from the
// host, then the sims above, then the root counts.

// Thread i < B·N writes tree row element (b, n) = (i / N, i % N) of
// visit/val, coalesced; thread i < B·A also writes root edge (i / A, i % A).
__global__ void move_root_init_kernel(float* visit, float* val,
                                      int32_t* child, float* prior,
                                      const float* root_prior,
                                      const float* value,
                                      const uint8_t* live, int B, int N,
                                      int A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * N) {
    const int b = i / N, n = i % N;
    const bool lv = live[b] != 0;
    visit[i] = n == 0 ? (lv ? 1.5f : 1.0f) : 0.0f;
    val[i] = (n == 0 && lv) ? -value[b] : 0.0f;
  }
  if (i < B * A) {
    const int b = i / A, a = i % A;
    const float rp = root_prior[i];
    const bool ok = rp > -1e29f;
    child[(size_t)b * N * A + a] = ok ? NO_CHILD : ILLEGAL;
    prior[(size_t)b * N * A + a] = ok ? qprior(rp) : 0.0f;
  }
}

__global__ void root_counts_kernel(const float* visit, const float* val,
                                   const int32_t* child, int32_t* counts,
                                   float* policy, float* root_q, int B, int N,
                                   int A) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* vs = visit + (size_t)b * N;
  const int32_t* ch0 = child + (size_t)b * N * A;
  int32_t* cnt = counts + (size_t)b * A;  // read back by this thread
  int tot = 0;
  for (int a = 0; a < A; ++a) {
    const int c = ch0[a];
    cnt[a] = c >= 0 ? (int)floorf(vs[c]) : 0;
    tot += cnt[a];
  }
  const float total = (float)max(tot, 1);
  for (int a = 0; a < A; ++a)
    policy[(size_t)b * A + a] = __fdiv_rn((float)cnt[a], total);
  root_q[b] = __fdiv_rn(val[(size_t)b * N], fmaxf(floorf(vs[0]), 1.0f));
}

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// The games these kernels take (search/fused.py:supports_chunk mirrors it).
bool game_ok(int A, int R, int C, int rules) {
  if (A < 1 || A > MAX_A || R * C > MAX_CELLS) return false;
  if (rules == RULES_GRAVITY) return C <= MAX_COLS && A == C;
  return (rules == RULES_CELLS || rules == RULES_NEIGHBOURHOOD) && A == R * C;
}

// launch(std::integral_constant<int, RULES>) for the game's rules, then the
// launch's error code
template <class Launch>
int with_rules(int A, int R, int C, int rules, Launch launch) {
  if (!game_ok(A, R, C, rules)) return (int)cudaErrorInvalidValue;
  if (rules == RULES_GRAVITY)
    launch(std::integral_constant<int, RULES_GRAVITY>());
  else if (rules == RULES_NEIGHBOURHOOD)
    launch(std::integral_constant<int, RULES_NEIGHBOURHOOD>());
  else
    launch(std::integral_constant<int, RULES_CELLS>());
  return (int)cudaGetLastError();
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
  return with_rules(A, R, C, rules, [&](auto rl) {
    root_init_kernel<decltype(rl)::value>
        <<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
            (float*)visit, (float*)val, (int32_t*)child, (float*)prior,
            (const float*)probs, (const float*)value, (const float*)noise,
            (const int8_t*)board, B, N, A, R, C, eps);
  });
}

int az_descend_leaf(const void* visit, const void* val, const void* child,
                    const void* prior, const void* board, const void* player,
                    const void* mc, const void* lines, void* path, void* apath,
                    void* pend, void* valid, void* obs, int B, int N, int A,
                    int R, int C, int F, int L, int K, int dcap, int max_moves,
                    int rules, int slot, int az, float c_puct, void* stream) {
  return with_rules(A, R, C, rules, [&](auto rl) {
    descend_leaf_kernel<decltype(rl)::value>
        <<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)visit, (const float*)val, (const int32_t*)child,
            (const float*)prior, (const int8_t*)board, (const int32_t*)player,
            (const int32_t*)mc, (const int32_t*)lines, (int32_t*)path,
            (int32_t*)apath, (int32_t*)pend, (uint8_t*)valid, (float*)obs, B,
            N, A, R, C, F, L, K, dcap, max_moves, slot, az, c_puct);
  });
}

int az_apply(void* visit, void* val, void* child, void* prior,
             const void* path, const void* pend, const void* valid,
             const void* probs, const void* value, int B, int N, int A,
             int dcap, int slot, void* stream) {
  apply_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)visit, (float*)val, (int32_t*)child, (float*)prior,
      (const int32_t*)path, (const int32_t*)pend, (const uint8_t*)valid,
      (const float*)probs, (const float*)value, B, N, A, dcap, slot);
  return (int)cudaGetLastError();
}

int az_move_tail(const void* visit, const void* val, const void* child,
                 const void* unif, void* board, void* player, void* mc,
                 const void* lines, void* r_policy, void* r_player, void* r_t,
                 void* r_action, void* r_done, void* r_winner, void* r_rootq,
                 int B, int N, int A, int R, int C, int L, int K,
                 int max_moves, int rules, int temperature_moves,
                 void* stream) {
  return with_rules(A, R, C, rules, [&](auto rl) {
    move_tail_kernel<decltype(rl)::value>
        <<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)visit, (const float*)val, (const int32_t*)child,
            (const float*)unif, (int8_t*)board, (int32_t*)player,
            (int32_t*)mc, (const int32_t*)lines, (float*)r_policy,
            (int32_t*)r_player, (int32_t*)r_t, (int32_t*)r_action,
            (uint8_t*)r_done, (int32_t*)r_winner, (float*)r_rootq, B, N, A, R,
            C, L, K, max_moves, temperature_moves);
  });
}

int az_move_root_init(void* visit, void* val, void* child, void* prior,
                      const void* root_prior, const void* value,
                      const void* live, int B, int N, int A, void* stream) {
  const int n = N > A ? B * N : B * A;
  move_root_init_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)visit, (float*)val, (int32_t*)child, (float*)prior,
      (const float*)root_prior, (const float*)value, (const uint8_t*)live, B,
      N, A);
  return (int)cudaGetLastError();
}

int az_root_counts(const void* visit, const void* val, const void* child,
                   void* counts, void* policy, void* root_q, int B, int N,
                   int A, void* stream) {
  if (A > MAX_A) return (int)cudaErrorInvalidValue;
  root_counts_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)visit, (const float*)val, (const int32_t*)child,
      (int32_t*)counts, (float*)policy, (float*)root_q, B, N, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
