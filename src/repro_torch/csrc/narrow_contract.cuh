// Narrow contraction: (B,M,K) @ (B,K,N) int32 against per-coefficient
// product columns, shared by approx_matmul.cu and lut_matmul.cu.
//
// Every shape the served paths give the two contraction kernels has N = 1 and
// K <= 9: im2col patches (B*H*W x K) against a (K x 1) column of Laplacian
// taps. With b fixed for a launch, the product f(a, b[z][k][j]) is a function
// of the low n bits of a alone (n the operand width), so it is a column of
// 2^n entries:
//
//     col[z][k][j][x] = f(x - 2^(n-1), b[z][k][j]),  x in [0, 2^n)
//     f(a, b[z][k][j]) = col[z][k][j][(a + 2^(n-1)) & (2^n - 1)]
//
// for every int32 a, out-of-range ones included: the closed form and the
// table index both wrap the first operand to n bits before anything else.
// Products wrap to 2n <= 16 bits, so int16 columns are lossless. The two
// kernels differ only in how they fill the columns (a small prologue kernel
// per launch into a scratch buffer the wrapper allocates on the caller's
// stream): approx_matmul.cu evaluates the closed form 2^n times per
// coefficient, lut_matmul.cu copies table[x << n | ((b + off) & mask)].
//
// narrow_contract_kernel<K> then streams the rows. Bound on the H100: the
// bytes of A (read once) and C (written once); a product costs one
// shared-memory gather and one add.
//
// * Persistent blocks, grid (min(tiles, resident blocks / B), B). A block
//   stages its batch's columns (K * N * 2^n int16, at most 64 KiB) in shared
//   memory once, then walks row tiles of NC_ROWS rows, a contiguous span of
//   NC_ROWS * K int32.
// * Row tiles stream through a ring of kStages shared buffers with cp.async
//   (16-byte copies, coalesced; the last chunk of an M tail copies only its
//   valid bytes and zero-fills the rest), so kStages - 1 tiles are in flight
//   while one is summed: 2 stages at K >= 5, up to 8 at K = 1, about 32 KiB
//   in flight per block.
// * A thread owns 4 consecutive rows, i.e. K consecutive 16-byte chunks of
//   the tile: K vector loads from shared memory, 4K biased indices, 4K * N
//   gathers, and one uint32 (wrapping) sum per row and output column. At
//   K = 2 or K % 4 == 0 the chunks are stored XOR-swizzled within groups of
//   8, so that the 8 threads of a quarter warp read 8 distinct bank groups
//   (odd K needs no swizzle).
// * N = 1 writes the 4 rows as one int4; N > 1 and a partial last row group
//   write scalars. No K slab, so no K tail and no f(0,0) to mask; the M tail
//   neither reads past M * K nor writes past M.
//
// Contract (the launcher checks it, the wrapper arranges it): A, C and the
// columns 16-byte aligned, and every batch of A and C too (B == 1 or
// M % 4 == 0); 1 <= K <= NC_MAX_K, 1 <= N <= NC_MAX_N, 1 <= n <= 8.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#define NC_THREADS 256
#define NC_ROWS (4 * NC_THREADS)  // rows of one tile, 4 per thread
#define NC_MAX_K 16
#define NC_MAX_N 8
#define NC_MAX_BITS 8

// Internal linkage: approx_matmul.cu and lut_matmul.cu each build their own
// copy into their own library, and nothing here may be unified across the
// two when both are loaded into one process.
namespace {

template <int K>
struct NarrowCfg {
  static constexpr int kChunks = NC_ROWS * K / 4;  // int4 chunks of a tile
  static constexpr int kStages = 8 / K + 1 > 8 ? 8 : (8 / K + 1 < 2 ? 2 : 8 / K + 1);
  static constexpr bool kSwizzle = K == 2 || K % 4 == 0;
  // the most shared memory any launch of this K takes (columns <= 64 KiB)
  static constexpr int kMaxSmem = kStages * kChunks * 16 +
                                  NC_MAX_K * NC_MAX_N * (2 << NC_MAX_BITS);

  __device__ __forceinline__ static int slot(int c) {
    return kSwizzle ? (c ^ ((c >> 3) & 7)) : c;
  }
};

__device__ __forceinline__ void nc_cp_async16(void* smem, const void* gmem,
                                              int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void nc_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void nc_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

template <int K>
__global__ void __launch_bounds__(NC_THREADS)
    narrow_contract_kernel(const int32_t* __restrict__ A,
                           const int16_t* __restrict__ cols,
                           int32_t* __restrict__ C, int M, int N, int n_bits) {
  using Cfg = NarrowCfg<K>;
  extern __shared__ __align__(16) unsigned char nc_smem[];
  int4* ring = reinterpret_cast<int4*>(nc_smem);
  int16_t* scol = reinterpret_cast<int16_t*>(ring + Cfg::kStages * Cfg::kChunks);
  const int tid = threadIdx.x;
  const int z = blockIdx.y;

  const int n_col = (K * N) << n_bits;
  const int16_t* zcols = cols + static_cast<size_t>(z) * n_col;
  for (int e = tid; e < n_col; e += NC_THREADS) scol[e] = zcols[e];

  const int32_t* Az = A + static_cast<size_t>(z) * M * K;
  int32_t* Cz = C + static_cast<size_t>(z) * M * N;
  const int n_tiles = (M + NC_ROWS - 1) / NC_ROWS;

  auto issue = [&](int tile, int stage) {
    if (tile < n_tiles) {
      const long long r0 = static_cast<long long>(tile) * NC_ROWS;
      const int words = static_cast<int>(min(static_cast<long long>(NC_ROWS),
                                             M - r0)) * K;
      const int32_t* src = Az + static_cast<size_t>(r0) * K;
      int4* dst = ring + stage * Cfg::kChunks;
      for (int c = tid; 4 * c < words; c += NC_THREADS) {
        nc_cp_async16(dst + Cfg::slot(c), src + 4 * c, 4 * min(4, words - 4 * c));
      }
    }
    nc_cp_async_commit();  // one group per stage, empty past the last tile
  };

  int tile = blockIdx.x;
  for (int s = 0; s < Cfg::kStages - 1; ++s) issue(tile + s * gridDim.x, s);

  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    issue(tile + (Cfg::kStages - 1) * gridDim.x,
          (it + Cfg::kStages - 1) % Cfg::kStages);
    nc_cp_async_wait<Cfg::kStages - 1>();  // this tile's group has landed
    __syncthreads();  // (and, the first time, the columns)

    const int4* buf = ring + (it % Cfg::kStages) * Cfg::kChunks;
    int32_t w[4 * K];  // the thread's 4 rows, row-major
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int4 v = buf[Cfg::slot(tid * K + i)];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    uint32_t acc[4][NC_MAX_N];  // int32 ring: unsigned wraparound is defined
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < NC_MAX_N; ++j) acc[r][j] = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t x = (static_cast<uint32_t>(w[r * K + k]) + off) & mask;
        const int16_t* ck = scol + (((k * N) << n_bits) | x);
#pragma unroll
        for (int j = 0; j < NC_MAX_N; ++j) {
          if (j < N) acc[r][j] += static_cast<uint32_t>(
              static_cast<int32_t>(ck[j << n_bits]));
        }
      }
    }

    const long long row = static_cast<long long>(tile) * NC_ROWS + 4 * tid;
    if (row < M) {
      const int valid = static_cast<int>(min(4LL, M - row));
      if (N == 1 && valid == 4) {
        *reinterpret_cast<int4*>(Cz + row) = make_int4(
            static_cast<int32_t>(acc[0][0]), static_cast<int32_t>(acc[1][0]),
            static_cast<int32_t>(acc[2][0]), static_cast<int32_t>(acc[3][0]));
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int j = 0; j < NC_MAX_N; ++j) {
            if (r < valid && j < N) {
              Cz[(row + r) * N + j] = static_cast<int32_t>(acc[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before refill
  }
  nc_cp_async_wait<0>();  // no copy outlives the block
}

template <int K>
cudaError_t narrow_contract_run(const int32_t* a, const int16_t* cols,
                                int32_t* c, int B, int M, int N, int n_bits,
                                cudaStream_t stream) {
  using Cfg = NarrowCfg<K>;
  // the opt-in limit is always the most any launch of this K takes, so that
  // concurrent launches of other shapes never see a smaller one
  cudaError_t e = cudaFuncSetAttribute(
      narrow_contract_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kMaxSmem);
  if (e != cudaSuccess) return e;
  const size_t smem = static_cast<size_t>(Cfg::kStages) * Cfg::kChunks * 16 +
                      (static_cast<size_t>(K * N) << n_bits) * sizeof(int16_t);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, narrow_contract_kernel<K>, NC_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  const int tiles = (M + NC_ROWS - 1) / NC_ROWS;
  const int resident = std::max(1, sms * per_sm / B);
  const dim3 grid(std::min(tiles, resident), B);
  narrow_contract_kernel<K><<<grid, NC_THREADS, smem, stream>>>(a, cols, c, M,
                                                                N, n_bits);
  return cudaGetLastError();
}

// Checks the contract above; cudaErrorInvalidValue or
// cudaErrorMisalignedAddress if it does not hold.
cudaError_t narrow_contract_check(const void* a, const void* cols,
                                  const void* c, int B, int M, int K, int N,
                                  int n_bits) {
  if (B < 1 || B > 65535 || M < 1 || K < 1 || K > NC_MAX_K || N < 1 ||
      N > NC_MAX_N || n_bits < 1 || n_bits > NC_MAX_BITS) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(cols) |
                        reinterpret_cast<uintptr_t>(c);
  if ((any & 15) != 0 || (B > 1 && M % 4 != 0)) {
    return cudaErrorMisalignedAddress;
  }
  return cudaSuccess;
}

// Launches narrow_contract_kernel<K> for a runtime K in 1..NC_MAX_K.
cudaError_t narrow_contract(const int32_t* a, const int16_t* cols, int32_t* c,
                            int B, int M, int K, int N, int n_bits,
                            cudaStream_t stream) {
  switch (K) {
#define NC_CASE(k) \
  case k:          \
    return narrow_contract_run<k>(a, cols, c, B, M, N, n_bits, stream);
    NC_CASE(1) NC_CASE(2) NC_CASE(3) NC_CASE(4) NC_CASE(5) NC_CASE(6)
    NC_CASE(7) NC_CASE(8) NC_CASE(9) NC_CASE(10) NC_CASE(11) NC_CASE(12)
    NC_CASE(13) NC_CASE(14) NC_CASE(15) NC_CASE(16)
#undef NC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
