// Batched contraction with every scalar product read from a product table.
//
// Replaces the TPU kernel src/repro/kernels/lut_matmul/kernel.py,
// lut_matmul_pallas (body _lut_matmul_kernel): (B,M,K) @ (B,K,N) int32 where
// the product of a and b is table[((a+off)&mask) << n | ((b+off)&mask)],
// off = 2^(n-1), mask = 2^n - 1, for the flat (2^{2n},) int32 table of any
// product model at widths 3..8 (core.lut.flat_lut; the "exact" wiring has
// no closed form and runs here), and the sum is exact in the int32 ring. The
// index arithmetic is uint32, so out-of-range operands wrap to their low n
// bits, as in the reference.
//
// Bound on the H100. One table read and one add per product, so at the
// shapes the served plans give it (the center tap group, (B*H*W x 1) @
// (1 x 1)) the bytes of A and C bound it. The table is 256 KiB of int32 at
// n = 8, more than the 227 KiB of shared memory a block may use, so this
// design gathers it from device memory through the read-only data path
// (__ldg): the table stays in L2 (50 MB) and its hot lines in L1. Tiles as
// in approx_matmul.cu: 16x16 outputs per block, one thread per output, A/B
// k-slabs staged in shared memory as ready table offsets (row index << n,
// column index), grid (M-tiles, N-tiles, B) with M on grid x for the B*H*W
// rows of the conv path. At N = 1 it idles 15 of the 16 threads of a tile
// row (later work).
//
// K tail: the *product* is masked, not the operand. A zero operand reads
// f(0,0), which is nonzero for approximate wirings (192 for proposed@8), so
// zero-filled slab entries must never be looked up into the sum.

#include <cuda_runtime.h>

#include <cstdint>

#define LM_TILE 16

__global__ void lut_matmul_kernel(const int32_t* __restrict__ A,
                                  const int32_t* __restrict__ Bm,
                                  const int32_t* __restrict__ table,
                                  int32_t* __restrict__ C, int M, int K, int N,
                                  int n_bits) {
  __shared__ uint32_t As[LM_TILE][LM_TILE];  // table row offsets, << n_bits
  __shared__ uint32_t Bs[LM_TILE][LM_TILE];  // table column indices
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.x * LM_TILE + ty;
  const int col = blockIdx.y * LM_TILE + tx;
  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  const int32_t* a = A + static_cast<size_t>(blockIdx.z) * M * K;
  const int32_t* b = Bm + static_cast<size_t>(blockIdx.z) * K * N;
  uint32_t acc = 0;  // int32 ring: unsigned wraparound is defined
  for (int k0 = 0; k0 < K; k0 += LM_TILE) {
    As[ty][tx] = (row < M && k0 + tx < K)
        ? ((static_cast<uint32_t>(a[static_cast<size_t>(row) * K + k0 + tx]) +
            off) & mask) << n_bits
        : 0u;
    Bs[ty][tx] = (k0 + ty < K && col < N)
        ? (static_cast<uint32_t>(b[static_cast<size_t>(k0 + ty) * N + col]) +
           off) & mask
        : 0u;
    __syncthreads();
    const int kn = min(LM_TILE, K - k0);  // mask the product, not the operand
    for (int kk = 0; kk < kn; ++kk) {
      acc += static_cast<uint32_t>(__ldg(table + (As[ty][kk] | Bs[kk][tx])));
    }
    __syncthreads();
  }
  if (row < M && col < N) {
    C[(static_cast<size_t>(blockIdx.z) * M + row) * N + col] =
        static_cast<int32_t>(acc);
  }
}

// a: contiguous (B, M, K), b: (B, K, N), c: (B, M, N), table: (2^{2n},), all
// int32 on the card. Returns cudaGetLastError().
extern "C" int lut_matmul_launch(const void* a, const void* b,
                                 const void* table, void* c, int B, int M,
                                 int K, int N, int n_bits, void* stream) {
  if (B < 1 || B > 65535 || M < 1 || K < 1 || N < 1 || n_bits < 1 ||
      n_bits > 8 || (N + LM_TILE - 1) / LM_TILE > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(LM_TILE, LM_TILE);
  const dim3 grid((M + LM_TILE - 1) / LM_TILE, (N + LM_TILE - 1) / LM_TILE, B);
  lut_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(c), M, K, N,
      n_bits);
  return static_cast<int>(cudaGetLastError());
}
