// Batched contraction with every scalar product read from a product table,
// two designs.
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
// Bound on the H100: one table read and one add per product, so at the
// shapes the served plans give it (the center tap group, (B*H*W x 1) @
// (1 x 1)) the bytes of A and C bound it. The wrapper
// (kernels/lut_matmul/ops.py) picks the design from the shape and width
// (kernels/blocking.py, narrow_design):
//
// * narrow (N <= 8, K <= 16, every entry of the table within int16, which
//   holds for every product table: products wrap to 2n <= 16 bits):
//   table_columns_kernel copies the table column of each coefficient,
//   table[:, (b + off) & mask], into int16 scratch, and narrow_contract.cuh
//   streams the rows against it from shared memory.
// * tile (wider N, longer K, a table beyond int16): the table is 256 KiB of
//   int32 at n = 8, more than the 227 KiB of shared memory a block may use,
//   so it is gathered from device memory through the read-only data path
//   (__ldg): it stays in L2 (50 MB) and its hot lines in L1. 16x16 outputs
//   per block, one thread per output, A/B k-slabs staged in shared memory
//   as ready table offsets (row index << n, column index), grid (M-tiles,
//   N-tiles, B) with M on grid x for the B*H*W rows of the conv path.
//
// K tail of the tile design: the *product* is masked, not the operand. A
// zero operand reads f(0,0), which is nonzero for approximate wirings (192
// for proposed@8), so zero-filled slab entries must never be looked up into
// the sum. The narrow design has no K slab and no K tail.

#include <cuda_runtime.h>

#include <cstdint>

#include "narrow_contract.cuh"

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

// The tile design. a: contiguous (B, M, K), b: (B, K, N), c: (B, M, N),
// table: (2^{2n},), all int32 on the card. Returns cudaGetLastError().
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

// col[e] = table[x << n | ((b[e >> n] + off) & mask)] with x = e & mask: the
// columns of narrow_contract.cuh (the pixel is the table's row operand), b
// being contiguous (B, K, N).
__global__ void table_columns_kernel(const int32_t* __restrict__ b,
                                     const int32_t* __restrict__ table,
                                     int16_t* __restrict__ cols,
                                     long long n_entries, int n_bits) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n_entries) return;
  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  const uint32_t x = static_cast<uint32_t>(e) & mask;
  const uint32_t bi = (static_cast<uint32_t>(b[e >> n_bits]) + off) & mask;
  cols[e] = static_cast<int16_t>(table[(x << n_bits) | bi]);
}

// The narrow design. a: contiguous (B, M, K), b: (B, K, N), c: (B, M, N),
// table: (2^{2n},), all int32 on the card, every table entry within int16;
// cols: B*K*N*2^n int16 scratch on the card, written here. Contract in
// narrow_contract.cuh. Returns cudaGetLastError().
extern "C" int lut_matmul_narrow_launch(const void* a, const void* b,
                                        const void* table, void* c, void* cols,
                                        int B, int M, int K, int N, int n_bits,
                                        void* stream) {
  cudaError_t e = narrow_contract_check(a, cols, c, B, M, K, N, n_bits);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_entries = (static_cast<long long>(B) * K * N) << n_bits;
  table_columns_kernel<<<static_cast<unsigned>((n_entries + 255) / 256), 256,
                         0, s>>>(static_cast<const int32_t*>(b),
                                 static_cast<const int32_t*>(table),
                                 static_cast<int16_t*>(cols), n_entries,
                                 n_bits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(narrow_contract(
      static_cast<const int32_t*>(a), static_cast<const int16_t*>(cols),
      static_cast<int32_t*>(c), B, M, K, N, n_bits, s));
}
