// Batched contraction with every scalar product read from a product table,
// six designs.
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
// (kernels/lut_matmul/ops.py) picks the design from the shape, the width
// and the table (kernels/blocking.py, narrow_design, tensor_design,
// decode_design, rows_design, gather_design), in this order:
//
// * narrow (N <= 8, K <= 16, every entry of the table within int16, which
//   holds for every product table: products wrap to 2n <= 16 bits):
//   table_columns_kernel copies the table column of each coefficient,
//   table[:, (b + off) & mask], into int16 scratch, and narrow_contract.cuh
//   streams the rows against it from shared memory.
// * tensor (the table is the exact product of signed 8-bit codes, M <= 16,
//   K <= 131071; the exact wiring's dense layers in an LM decode step): the
//   table is not read at all. exact_matmul_kernel below computes the
//   int8 x int8 -> int32 product on the INT8 tensor cores (mma.sync
//   m16n8k32), bytes-bound.
// * decode (M <= 16, any other K and N, every table entry within int16):
//   an int16 twin of the table (kernels/lut_matmul/ops.py) and
//   decode_contract.cuh, as approx_matmul.cu's decode design.
// * rows (M > 16, widths 3..8, a table that the host takes apart into at
//   most 32 int8 bit-monomial planes besides the exact product: every
//   product table of a CSP wiring, and the exact product with none):
//   rows_contract.cuh on the INT8 tensor cores, as approx_matmul.cu's rows
//   design; the table itself is not read.
// * gather (every other table: entries beyond int16, or an int16 table
//   beyond the rows planes at M > 16; at the shapes where it beats the
//   tile design, blocking.gather_design; no served path):
//   gather_contract.cuh keeps the table in shared memory (the int16 twin,
//   or the int32 table in row windows of 128 KiB: two at n = 8) and
//   gathers each product once from it, 16-row tiles of persistent blocks,
//   each weight code read once per tile. INT32 operations (shared-memory
//   gathers in practice) bound it.
// * tile (narrow N at many rows under a table beyond int16, such as the
//   edge contraction, where each gather segment's fixed cost loses;
//   otherwise forced only): the table
//   is 256 KiB of int32 at n = 8, more than the 227 KiB of shared memory a
//   block may use, so it is gathered from device memory through the
//   read-only data path (__ldg): it stays in L2 (50 MB) and its hot lines
//   in L1. 16x16 outputs per block, one thread per output, A/B k-slabs
//   staged in shared memory as ready table offsets (row index << n, column
//   index), grid (M-tiles, N-tiles, B) with M on grid x for the B*H*W rows
//   of the conv path.
//
// K tail of the tile design: the *product* is masked, not the operand. A
// zero operand reads f(0,0), which is nonzero for approximate wirings (192
// for proposed@8), so zero-filled slab entries must never be looked up into
// the sum. The narrow, decode and gather designs have no K slab and no K
// tail; the tensor design zero-fills its K tail, which is exact for the
// exact product alone (0 * b = 0), the only table it takes.

#include <cuda_runtime.h>

#include <cstdint>

#include "decode_contract.cuh"
#include "gather_contract.cuh"
#include "narrow_contract.cuh"
#include "rows_contract.cuh"

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

// The decode design. a: contiguous (B, M, K) int8 codes, b: (B, K, N) int8
// codes, c: (B, M, N) int32, table16: the 2^(2n) int16 twin of the flat
// table, all on the card. Contract in decode_contract.cuh. Returns
// cudaGetLastError() or the contract's error.
extern "C" int lut_matmul_decode_launch(const void* a, const void* b,
                                        const void* table16, void* c, int B,
                                        int M, int K, int N, int n_bits,
                                        void* stream) {
  return static_cast<int>(decode_contract(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int16_t*>(table16), static_cast<int32_t*>(c), B, M, K,
      N, n_bits, static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------------
// The tensor design: the exact product of int8 codes on the INT8 tensor cores
//
// C[m][n] = sum_k A[m][k] * W[k][n] for M <= 16 activation rows. Bound on the
// H100: the K x N weight bytes (2 M K N operations at 1979 TOP/s take far
// less time than K N bytes at 3.35 TB/s), so the kernel must read each
// weight byte once, in wide loads, with enough of them in flight.
//
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 with the weight as the 16-row
// side (A of the mma: 16 output columns x 32 k) and the activation rows as
// the 8-column side (B of the mma: 32 k x 8 rows; a second n8 group for
// M > 8). Rows of the mma beyond M read zero codes and are never stored.
//
// Operand layout. Both mma operands must be K-contiguous in their
// registers, and dense's weight is (K, N), N-contiguous; ldmatrix does not
// transpose 8-bit elements. The transpose is done in registers: lane
// (g, t) = (lane / 4, lane % 4) of a warp loads the 16 columns
// [16g, 16g + 16) of its group at k rows 4t..4t+3 and 16+4t..16+4t+3 of the
// 32-row step, one 16-byte load each (a warp load covers 4 rows x 128
// contiguous bytes), and 8 byte permutes turn each 4 x 4 byte block into 4
// K-contiguous words, one per column. The order of the mma's 16 rows is
// free, so tile tau (0..7) takes column 16g + 2 tau as its row g and
// 16g + 2 tau + 1 as its row g + 8: each lane feeds its own columns and
// nothing crosses lanes. Cost per call: 64 permutes per lane per 32-row
// step, no shared memory, no extra pass over the weight, nothing in the
// wrapper.
//
// Split K: a block of 4 warps owns 128 columns and a k range of k_blk rows
// (a multiple of 128), a quarter per warp; the grid is (N / 128, K / k_blk,
// B), k_blk chosen so that the grid is one wave of resident blocks. The
// 4 warps' sums meet in shared memory, and the block adds its 128 x M
// outputs into C with int32 atomicAdd where K is split (C zeroed by the
// launcher), else stores them. K <= 131071 keeps every partial and total sum
// within int32 (|a b| <= 2^14), so the mma accumulator never overflows.
// ---------------------------------------------------------------------------

#define TC_WARPS 4
#define TC_COLS 128  // columns of a block, 16 per lane group
#define TC_MAX_M 16
#define TC_MAX_K 131071

namespace {

// 4 words, each 4 int8 of one k row at 4 adjacent columns, into 4 words,
// each the 4 k rows (low byte first) of one column.
__device__ __forceinline__ void tc_transpose4(uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3,
                                              uint32_t* out) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// 4 int8 of a row at [col, col + 4), zero beyond `valid` (bytes of the row
// from col on), as one word: a 32-bit load where `vec`.
__device__ __forceinline__ uint32_t tc_word(const int8_t* p, int valid,
                                            bool vec) {
  if (valid <= 0) return 0u;
  if (vec && valid >= 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < valid) {
      w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + i))) << (8 * i);
    }
  }
  return w;
}

template <int MG>  // n8 groups of activation rows: M <= 8 MG
__global__ void __launch_bounds__(TC_WARPS * 32)
    exact_matmul_kernel(const int8_t* __restrict__ A,
                        const int8_t* __restrict__ W, int32_t* __restrict__ C,
                        int M, int K, int N, int k_blk, int vec_w, int vec_a,
                        int atomic) {
  __shared__ int32_t red[8 * MG][TC_COLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.z;
  const int n0 = blockIdx.x * TC_COLS;
  const int col = n0 + 16 * g;  // this lane's 16 columns
  const int kw = k_blk / TC_WARPS;
  const int k_lo = blockIdx.y * k_blk + warp * kw;
  const int k_hi = min(K, k_lo + kw);
  const int8_t* Az = A + static_cast<size_t>(z) * M * K;
  const int8_t* Wz = W + static_cast<size_t>(z) * K * N;

  for (int e = tid; e < 8 * MG * TC_COLS; e += TC_WARPS * 32) {
    (&red[0][0])[e] = 0;
  }

  int32_t acc[MG][8][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
    for (int tau = 0; tau < 8; ++tau) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mg][tau][i] = 0;
    }
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += 32) {
    // the weight: [half][j] = row k0 + 16 half + 4t + j, 16 columns
    uint4 wr[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = k0 + 16 * h + 4 * t + j;  // < k_lo + kw always
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < K && col < N) {
          const int8_t* p = Wz + static_cast<size_t>(row) * N + col;
          if (vec_w) {  // N % 16 == 0: the 16 columns are all in range
            v = __ldg(reinterpret_cast<const uint4*>(p));
          } else {
            const int valid = N - col;
            v.x = tc_word(p, valid, false);
            v.y = tc_word(p + 4, valid - 4, false);
            v.z = tc_word(p + 8, valid - 8, false);
            v.w = tc_word(p + 12, valid - 12, false);
          }
        }
        wr[h][j] = v;
      }
    }
    // the activation rows: b[mg][half] = row 8 mg + g, k k0 + 16 half + 4t..
    uint32_t b[MG][2];
#pragma unroll
    for (int mg = 0; mg < MG; ++mg) {
      const int m = 8 * mg + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 16 * h + 4 * t;
        b[mg][h] = m < M ? tc_word(Az + static_cast<size_t>(m) * K + k, K - k,
                                   vec_a != 0)
                         : 0u;
      }
    }
    // transpose: a[half][q] = column col + q, k rows 4t..4t+3 of the half
    uint32_t a[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tc_transpose4(wr[h][0].x, wr[h][1].x, wr[h][2].x, wr[h][3].x, a[h] + 0);
      tc_transpose4(wr[h][0].y, wr[h][1].y, wr[h][2].y, wr[h][3].y, a[h] + 4);
      tc_transpose4(wr[h][0].z, wr[h][1].z, wr[h][2].z, wr[h][3].z, a[h] + 8);
      tc_transpose4(wr[h][0].w, wr[h][1].w, wr[h][2].w, wr[h][3].w, a[h] + 12);
    }
#pragma unroll
    for (int tau = 0; tau < 8; ++tau) {
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(acc[mg][tau][0]), "+r"(acc[mg][tau][1]),
              "+r"(acc[mg][tau][2]), "+r"(acc[mg][tau][3])
            : "r"(a[0][2 * tau]), "r"(a[0][2 * tau + 1]),
              "r"(a[1][2 * tau]), "r"(a[1][2 * tau + 1]), "r"(b[mg][0]),
              "r"(b[mg][1]));
      }
    }
  }
  __syncthreads();  // red is zeroed

  // c0, c1: column 16g + 2 tau, rows 2t, 2t + 1; c2, c3: column + 1
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
#pragma unroll
    for (int tau = 0; tau < 8; ++tau) {
      const int r = 8 * mg + 2 * t, c = 16 * g + 2 * tau;
      atomicAdd(&red[r][c], acc[mg][tau][0]);
      atomicAdd(&red[r + 1][c], acc[mg][tau][1]);
      atomicAdd(&red[r][c + 1], acc[mg][tau][2]);
      atomicAdd(&red[r + 1][c + 1], acc[mg][tau][3]);
    }
  }
  __syncthreads();
  for (int e = tid; e < M * TC_COLS; e += TC_WARPS * 32) {
    const int m = e / TC_COLS, c = e - m * TC_COLS;
    if (n0 + c < N) {
      int32_t* out = C + (static_cast<size_t>(z) * M + m) * N + n0 + c;
      if (atomic) {
        atomicAdd(out, red[m][c]);
      } else {
        *out = red[m][c];
      }
    }
  }
}

template <int MG>
cudaError_t exact_matmul_run(const int8_t* a, const int8_t* w, int32_t* c,
                             int B, int M, int K, int N, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, exact_matmul_kernel<MG>, TC_WARPS * 32, 0);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(N + TC_COLS - 1) / TC_COLS * B;
  // as many k ranges per column tile as one wave of resident blocks holds
  const int k_steps = (K + 127) / 128;  // k ranges of 128 rows, 32 per warp
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int split = static_cast<int>(std::max(1LL, std::min<long long>(
      k_steps, slots / std::max(1LL, tiles))));
  const int k_blk = (k_steps + split - 1) / split * 128;
  const int grid_y = (K + k_blk - 1) / k_blk;
  const int atomic = grid_y > 1 ? 1 : 0;
  if (atomic) {
    e = cudaMemsetAsync(c, 0, static_cast<size_t>(B) * M * N * sizeof(int32_t),
                        stream);
    if (e != cudaSuccess) return e;
  }
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const uintptr_t aa = reinterpret_cast<uintptr_t>(a);
  const int vec_w = (N % 16 == 0 && wa % 16 == 0) ? 1 : 0;
  const int vec_a = (K % 4 == 0 && aa % 4 == 0) ? 1 : 0;
  const dim3 grid((N + TC_COLS - 1) / TC_COLS, grid_y, B);
  exact_matmul_kernel<MG><<<grid, TC_WARPS * 32, 0, stream>>>(
      a, w, c, M, K, N, k_blk, vec_w, vec_a, atomic);
  return cudaGetLastError();
}

}  // namespace

// The tensor design. a: contiguous (B, M, K) int8 codes, w: (B, K, N) int8
// codes, c: (B, M, N) int32, all on the card; 1 <= M <= 16,
// 1 <= K <= 131071. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape outside that.
extern "C" int lut_matmul_tensor_launch(const void* a, const void* w, void* c,
                                        int B, int M, int K, int N,
                                        void* stream) {
  if (B < 1 || B > 65535 || M < 1 || M > TC_MAX_M || K < 1 || K > TC_MAX_K ||
      N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  int32_t* c32 = static_cast<int32_t*>(c);
  return static_cast<int>(M <= 8 ? exact_matmul_run<1>(a8, w8, c32, B, M, K, N, s)
                                 : exact_matmul_run<2>(a8, w8, c32, B, M, K, N, s));
}

// The rows design. a: contiguous (B, M, K) int8 codes, w: (B, K, N) int8
// codes, c: (B, M, N) int32, planes: the table's planes as
// kernels/monomials.device_planes lays them out (R of them, f00 the table's
// entry at (0, 0)), all on the card. Contract in rows_contract.cuh. Returns
// cudaGetLastError() or the contract's error.
extern "C" int lut_matmul_rows_launch(const void* a, const void* w,
                                      const void* planes, void* c, int B,
                                      int M, int K, int N, int n_bits, int R,
                                      int f00, void* stream) {
  return static_cast<int>(rows_contract(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(planes), static_cast<int32_t*>(c), B, M, K,
      N, n_bits, R, f00, static_cast<cudaStream_t>(stream)));
}

// The gather design. a: contiguous (B, M, K) int8 codes, b: (B, K, N) int8
// codes, c: (B, M, N) int32, table: the 2^(2n) entries of entry_bytes (2:
// the int16 twin, 4: the int32 table), all on the card. Contract in
// gather_contract.cuh. Returns cudaGetLastError() or the contract's error.
extern "C" int lut_matmul_gather_launch(const void* a, const void* b,
                                        const void* table, int entry_bytes,
                                        void* c, int B, int M, int K, int N,
                                        int n_bits, void* stream) {
  return static_cast<int>(gather_contract(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), table,
      entry_bytes, static_cast<int32_t*>(c), B, M, K, N, n_bits,
      static_cast<cudaStream_t>(stream)));
}
