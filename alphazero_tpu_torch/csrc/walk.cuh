// What the group kernels of search.cu (az_root_init, az_descend_leaf,
// az_apply, az_move_tail) and sim.cu (az_sim_step, az_sim_flush) share:
// the games' move rules, and the layout of a group of G lanes per game.
//
// A group of G lanes serves one game, G a power of two from the action
// count (group_size: 8 up to A=8, 16 up to 16, else 32, the most a warp
// shuffle spans), so a warp holds 32/G games.  A walk step reads the
// node's A edges spread over the lanes (a ≡ lane mod G, coalesced), each
// lane keeps its first maximum of the UCB in ascending action order, and
// group_first_max's butterfly of shuffles reduces (u, action) to the
// larger u, on a tie the lower action: the serial loop's first maximum.
// Every shuffle and ballot names the whole warp, so every lane of it must
// reach each one: a stopped or idle group (past B) runs on and writes
// nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define MAX_CELLS 256
#define MAX_COLS 32
// a game's move rules (envs/core.py: Env.rules)
#define RULES_CELLS 0
#define RULES_GRAVITY 1
#define RULES_NEIGHBOURHOOD 2

namespace {

constexpr unsigned kFull = 0xffffffffu;

// lanes per game for A actions (search/fused.py:search_geometry and
// search/sim.py:sim_geometry mirror it)
inline int group_size(int A) { return A <= 8 ? 8 : (A <= 16 ? 16 : 32); }

// this lane's group's lanes in its warp
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  return (kFull >> (32 - G)) << ((threadIdx.x & 31) & ~(G - 1));
}

// The group's maximum of (best, -act) into every lane of the group: the
// larger u, on equal u the lower action (a shuffle moves a value without
// changing it).
template <int G>
__device__ __forceinline__ void group_first_max(float& best, int& act) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ou = __shfl_xor_sync(kFull, best, off, G);
    const int oa = __shfl_xor_sync(kFull, act, off, G);
    if (ou > best || (ou == best && oa < act)) {
      best = ou;
      act = oa;
    }
  }
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

// The games a kernel of at most MAXA actions takes.
template <int MAXA>
bool game_ok(int A, int R, int C, int rules) {
  if (A < 1 || A > MAXA || R * C > MAX_CELLS) return false;
  if (rules == RULES_GRAVITY) return C <= MAX_COLS && A == C;
  return (rules == RULES_CELLS || rules == RULES_NEIGHBOURHOOD) && A == R * C;
}

// launch(std::integral_constant<int, RULES>) for the game's rules, then the
// launch's error code
template <int MAXA, class Launch>
int with_rules(int A, int R, int C, int rules, Launch launch) {
  if (!game_ok<MAXA>(A, R, C, rules)) return (int)cudaErrorInvalidValue;
  if (rules == RULES_GRAVITY)
    launch(std::integral_constant<int, RULES_GRAVITY>());
  else if (rules == RULES_NEIGHBOURHOOD)
    launch(std::integral_constant<int, RULES_NEIGHBOURHOOD>());
  else
    launch(std::integral_constant<int, RULES_CELLS>());
  return (int)cudaGetLastError();
}

// launch(std::integral_constant<int, G>) for the group size of A actions
template <class Launch>
void with_group(int A, Launch launch) {
  const int g = group_size(A);
  if (g == 8)
    launch(std::integral_constant<int, 8>());
  else if (g == 16)
    launch(std::integral_constant<int, 16>());
  else
    launch(std::integral_constant<int, 32>());
}

}  // namespace
