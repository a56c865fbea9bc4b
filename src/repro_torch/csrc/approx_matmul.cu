// Batched contraction under the CSP approximate multiplier, four designs.
//
// Replaces the TPU kernel src/repro/kernels/approx_matmul/kernel.py,
// approx_matmul_pallas (body _matmul_kernel): (B,M,K) @ (B,K,N) int32 where
// every scalar product is the wiring's closed form (closed_form.cuh) and the
// sum is exact in the int32 ring.
//
// Bound on the H100. The product is not a multiply-add, so no library GEMM
// (cuBLAS, torch.matmul, _int_mm) evaluates it; the rows design rewrites it
// as a short sum of int8 GEMMs for the tensor cores. Where b has few distinct
// values per launch, as the conv path's (K x 1) tap column, the least work is
// a table read per product, and the bytes of A and C bound it. The wrapper
// (kernels/approx_matmul/ops.py) picks the design from the shape and width
// alone (kernels/blocking.py, narrow_design, decode_design, rows_design), in
// this order:
//
// * narrow (N <= 8, K <= 16, width <= 8; every shape the edge paths give
//   it): cf_columns_kernel evaluates the closed form once per (coefficient,
//   operand) pair, B*K*N*2^n products, into int16 columns, and
//   narrow_contract.cuh streams the rows against them: one shared-memory
//   gather per product, so the bytes of A and C bound it.
// * decode (M <= 16, width <= 8, any other K and N; every dense layer of an
//   LM decode step): cf_table_kernel (closed_form.cuh) evaluates the closed
//   form once for each of the 2^(2n) operand pairs into an int16 table, once
//   per (wiring, device), and decode_contract.cuh gathers every product from
//   that table in shared memory, reading each int8 weight code once for all
//   M rows. INT32 operations (a gather and an add per product) bound it.
// * rows (M > 16, widths 3..8, any other K and N; every dense layer of a
//   training step or a prefill): the closed form's int16 table (the decode
//   design's) taken apart on the host into an exact int8 GEMM plus R
//   bit-monomial int8 GEMMs (kernels/monomials.py; R = 19 at proposed@8),
//   which rows_contract.cuh runs on the INT8 tensor cores. The tensor cores
//   bound it.
// * tile (widths 9..16, or forced): 16x16 output
//   tiles, one thread per output, A/B k-slabs of 16 staged in shared
//   memory, grid (M-tiles, N-tiles, B) -- M on grid x, beyond the 65535
//   limit of grid y. It evaluates the generic closed form for each of the
//   M*N*K products (on the order of a hundred integer operations each), so
//   INT32 ALU throughput bounds it. Ragged M/N/K are bounds-checked.
//
// K tail of the tile design: the *product* is masked, not the operand. A
// zero operand gives f(0,0), which is 192 for proposed@8, so zero-filled
// slab entries must never be multiplied into the sum; the JAX wrapper
// instead pads and subtracts f00 * pad_k (blocking.pad_crop_correct). Both
// give the same integers. The narrow and decode designs have no K slab and
// no K tail; the rows design adds K * f(0,0) once and zero-fills a K tail
// whose bit tests and factors are all 0.

#include <cuda_runtime.h>

#include <cstring>

#include "closed_form.cuh"
#include "decode_contract.cuh"
#include "narrow_contract.cuh"
#include "rows_contract.cuh"

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

// The tile design. a: contiguous (B, M, K), b: (B, K, N), c: (B, M, N), all
// int32 on the card. params: CF_PARAM_LEN host int32. Returns
// cudaGetLastError().
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

// The narrow design. a: contiguous (B, M, K), b: (B, K, N), c: (B, M, N),
// all int32 on the card; cols: B*K*N*2^n int16 scratch on the card, written
// here by cf_columns_kernel (closed_form.cuh), one column per entry of b.
// params: CF_PARAM_LEN host int32 (its width n <= 8). Contract in
// narrow_contract.cuh. Returns cudaGetLastError().
extern "C" int approx_matmul_narrow_launch(const void* a, const void* b,
                                           void* c, void* cols, int B, int M,
                                           int K, int N, const void* params,
                                           void* stream) {
  CFParams cf;
  std::memcpy(cf.p, params, sizeof(cf.p));
  const int n = cf.p[0];
  cudaError_t e = narrow_contract_check(a, cols, c, B, M, K, N, n);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_entries = (static_cast<long long>(B) * K * N) << n;
  cf_columns_kernel<<<static_cast<unsigned>((n_entries + 255) / 256), 256, 0,
                      s>>>(static_cast<const int32_t*>(b),
                           static_cast<int16_t*>(cols), n_entries, cf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(narrow_contract(
      static_cast<const int32_t*>(a), static_cast<const int16_t*>(cols),
      static_cast<int32_t*>(c), B, M, K, N, n, s));
}

// The decode design's product table: table, 2^(2n) int16 on the card, is
// written with f(xa - 2^(n-1), xb - 2^(n-1)) at xa << n | xb. params:
// CF_PARAM_LEN host int32, its width n <= 8. Returns cudaGetLastError().
extern "C" int approx_matmul_table_launch(void* table, const void* params,
                                          void* stream) {
  CFParams cf;
  std::memcpy(cf.p, params, sizeof(cf.p));
  const int n = cf.p[0];
  if (n < 1 || n > DC_MAX_BITS) return static_cast<int>(cudaErrorInvalidValue);
  const int entries = 1 << (2 * n);
  cf_table_kernel<<<(entries + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(table), cf);
  return static_cast<int>(cudaGetLastError());
}

// The decode design. a: contiguous (B, M, K) int8 codes, b: (B, K, N) int8
// codes, c: (B, M, N) int32, table: the 2^(2n) int16 table that
// approx_matmul_table_launch wrote, all on the card. Contract in
// decode_contract.cuh. Returns cudaGetLastError() or the contract's error.
extern "C" int approx_matmul_decode_launch(const void* a, const void* b,
                                           const void* table, void* c, int B,
                                           int M, int K, int N, int n_bits,
                                           void* stream) {
  return static_cast<int>(decode_contract(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int16_t*>(table), static_cast<int32_t*>(c), B, M, K, N,
      n_bits, static_cast<cudaStream_t>(stream)));
}

// The rows design. a: contiguous (B, M, K) int8 codes, w: (B, K, N) int8
// codes, c: (B, M, N) int32, planes: the closed form's planes as
// kernels/monomials.device_planes lays them out (R of them, f00 its
// product at (0, 0)), all on the card. Contract in rows_contract.cuh.
// Returns cudaGetLastError() or the contract's error.
extern "C" int approx_matmul_rows_launch(const void* a, const void* w,
                                         const void* planes, void* c, int B,
                                         int M, int K, int N, int n_bits,
                                         int R, int f00, void* stream) {
  return static_cast<int>(rows_contract(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(planes), static_cast<int32_t*>(c), B, M, K,
      N, n_bits, R, f00, static_cast<cudaStream_t>(stream)));
}
