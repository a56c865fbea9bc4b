// Batched contraction under the CSP approximate multiplier.
//
// Replaces the TPU kernel src/repro/kernels/approx_matmul/kernel.py,
// approx_matmul_pallas (body _matmul_kernel): (B,M,K) @ (B,K,N) int32 where
// every scalar product is the wiring's closed form (closed_form.cuh) and the
// sum is exact in the int32 ring.
//
// Bound on the H100. The product is not a multiply-add, so tensor cores (and
// cuBLAS, torch.matmul, _int_mm) cannot evaluate it. Where one operand has
// few distinct values, as the conv path's (9 x 1) tap column, the least work
// is a table read per product and the bytes of A bound it; this design
// evaluates the generic closed form for each of the M*N*K products (on the
// order of a hundred integer operations each), so INT32 ALU throughput
// bounds it, and at N = 1 it idles 15 of the 16 threads of a tile row.
// This first design: 16x16 output tiles, one thread per output,
// A/B k-slabs of 16 staged in shared memory, grid (M-tiles, N-tiles, B) --
// M on grid x because M reaches B*H*W rows on the im2col conv path, beyond
// the 65535 limit of grid y. Ragged M/N/K are bounds-checked.
//
// K tail: the *product* is masked, not the operand. A zero operand gives
// f(0,0), which is 192 for proposed@8, so zero-filled slab entries must never
// be multiplied into the sum; the JAX wrapper instead pads and subtracts
// f00 * pad_k (blocking.pad_crop_correct). Both give the same integers.

#include <cuda_runtime.h>

#include <cstring>

#include "closed_form.cuh"

#define MM_TILE 16

__global__ void approx_matmul_kernel(const int32_t* __restrict__ A,
                                     const int32_t* __restrict__ Bm,
                                     int32_t* __restrict__ C, int M, int K,
                                     int N, const CFParams cf) {
  __shared__ int32_t As[MM_TILE][MM_TILE];
  __shared__ int32_t Bs[MM_TILE][MM_TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.x * MM_TILE + ty;
  const int col = blockIdx.y * MM_TILE + tx;
  const int32_t* a = A + static_cast<size_t>(blockIdx.z) * M * K;
  const int32_t* b = Bm + static_cast<size_t>(blockIdx.z) * K * N;
  uint32_t acc = 0;  // int32 ring: unsigned wraparound is defined
  for (int k0 = 0; k0 < K; k0 += MM_TILE) {
    As[ty][tx] = (row < M && k0 + tx < K)
                     ? a[static_cast<size_t>(row) * K + k0 + tx] : 0;
    Bs[ty][tx] = (k0 + ty < K && col < N)
                     ? b[static_cast<size_t>(k0 + ty) * N + col] : 0;
    __syncthreads();
    const int kn = min(MM_TILE, K - k0);  // mask the product, not the operand
    for (int kk = 0; kk < kn; ++kk) {
      acc += static_cast<uint32_t>(cf_product(As[ty][kk], Bs[kk][tx], cf));
    }
    __syncthreads();
  }
  if (row < M && col < N) {
    C[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] =
        static_cast<int32_t>(acc);
  }
}

// a: contiguous (B, M, K), b: (B, K, N), c: (B, M, N), all int32 on the card.
// params: CF_PARAM_LEN host int32. Returns cudaGetLastError().
extern "C" int approx_matmul_launch(const void* a, const void* b, void* c,
                                    int B, int M, int K, int N,
                                    const void* params, void* stream) {
  if (B < 1 || B > 65535 || M < 1 || K < 1 || N < 1 ||
      (N + MM_TILE - 1) / MM_TILE > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CFParams cf;
  std::memcpy(cf.p, params, sizeof(cf.p));
  const dim3 block(MM_TILE, MM_TILE);
  const dim3 grid((M + MM_TILE - 1) / MM_TILE, (N + MM_TILE - 1) / MM_TILE, B);
  approx_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(c), M, K, N, cf);
  return static_cast<int>(cudaGetLastError());
}
