// Warp-level building blocks shared by the forward kernels
// (dense_forward.cu, resnet_tower.cu): bf16 mma.sync with float32
// accumulators, ldmatrix fragment loads from shared memory, and cp.async
// copies from global to shared memory in commit groups.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4·gid + tig.
//   A (16×16, row-major):  a0 = A[gid][2tig..+1],   a1 = A[gid+8][2tig..+1],
//                          a2 = A[gid][8+2tig..+1], a3 = A[gid+8][8+2tig..+1]
//   B (16×8, "col"):       b0 = B[2tig..+1][gid],   b1 = B[8+2tig..+1][gid]
//                          i.e. W[n=gid][k..k+1] of a weight W (out, in)
//   C (16×8, float32):     c0,c1 = C[gid][2tig..+1], c2,c3 = C[gid+8][2tig..+1]
// ldmatrix.x4 loads four 8×8 bf16 matrices; lane l gives the address of
// row (l & 7) of matrix (l >> 3), 16 bytes long and 16-byte aligned, and
// receives in register j the pair at row (l >> 2), columns 2(l & 3)..+1 of
// matrix j: exactly the A and B fragments above when the matrices are
// chosen as in ldsm_a and ldsm_b.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace az {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8×8 matrices (one n-tile's b0, b1): the addresses of lanes 0-15.
__device__ __forceinline__ void ldsm_x2(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// The lane's ldmatrix row address for an A fragment (16 rows × 16 k):
// `row` is the shared-memory address of row (lane & 15) of the tile, and
// the lane's half of k is (lane >> 4).
__device__ __forceinline__ uint32_t ldsm_a_addr(uint32_t row, int lane) {
  return row + ((lane >> 4) << 4);
}

// The lane's ldmatrix row address for the B fragments of two n-tiles
// (rows n0..n0+15 of a row-major weight W[n][k] with row stride `ld`
// elements) at k0: matrices (n0, k0), (n0, k0+8), (n0+8, k0), (n0+8, k0+8),
// so r0,r1 are the first n-tile's b0,b1 and r2,r3 the second's.
__device__ __forceinline__ uint32_t ldsm_b_addr(uint32_t w, int ld, int n0,
                                                int k0, int lane) {
  const int n = n0 + ((lane >> 4) << 3) + (lane & 7);
  const int k = k0 + (((lane >> 3) & 1) << 3);
  return w + (uint32_t)(n * ld + k) * 2u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n (0 to 2) commit groups of this thread are still in
// flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Copy rows × cols bf16 (cols a multiple of 8) from global memory with row
// stride `lds` into shared memory with row stride `ldd`, 16 bytes per
// cp.async, spread over the block's threads.
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, int ldd,
                                              const __nv_bfloat16* src,
                                              int lds, int rows, int cols) {
  const int chunks = cols >> 3;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) << 3;
    cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the four lanes of a quad (the lanes that hold one row of an
// mma accumulator).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace az
