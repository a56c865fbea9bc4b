// Decode contraction: (B,M,K) @ (B,K,N) int8 codes against the whole
// int16 product table, for few rows (M <= 16), shared by approx_matmul.cu
// and lut_matmul.cu.
//
// The served shape is an LM decode step: M = 8 activation rows (one token per
// sequence) against a (K x N) weight at K, N in {1024, 4096, 16384}. The tile
// design computes 16 x 16 output tiles there, so it throws half of every tile
// away, reads every weight code once per 16-row tile, and evaluates the
// generic closed form (about a hundred INT32 operations) per product. Here:
//
//     table[xa << n | xb] = f(xa - 2^(n-1), xb - 2^(n-1)),  xa, xb in [0, 2^n)
//     f(a, b) = table[((a + 2^(n-1)) & (2^n - 1)) << n | ((b + 2^(n-1)) & (2^n - 1))]
//
// for every a, b, out-of-range ones included (both the closed form and the
// product table wrap an operand to its low n bits first). Products wrap to
// 2n <= 16 bits, so the int16 table is lossless: 2^16 entries, 128 KiB, at
// n = 8 (the int32 one would not fit a block's 227 KiB). approx_matmul.cu
// fills it once per (wiring, device) with cf_table_kernel (closed_form.cuh);
// lut_matmul.cu keeps an int16 twin of the flat table.
//
// Bound on the H100: 2 M K N operations (a table read and an add per
// product) against M K + K N + 4 M N bytes, so INT32 operations bound it at
// M = 8; in practice the shared-memory gathers do (random int16 lookups,
// about 3-4 wavefronts per warp gather).
//
// * Persistent blocks, one per SM (the table takes 128 KiB): each stages the
//   table in shared memory once, then walks an equal share of the
//   B x (N / 128) x K work space (batch, 128-column group, k row), cut into
//   segments of one group and a contiguous k range. So every SM has work at
//   every shape (4096 x 1024 is 8 groups x 4096 k rows), and the k ranges
//   that a group is split into combine with int32 atomicAdd on an output the
//   launcher zeroes: exact and order-independent in the int32 ring, so the
//   result is deterministic.
// * A segment streams its k range in chunks of DC_CHUNK rows: the M rows'
//   activation codes of the chunk are staged as byte offsets of their table
//   rows (xa << (n + 1)), stride MP (M padded to 4) per k, read as
//   broadcast 16-byte loads.
// * The 16 warps take the chunk's k rows in turn; lane l owns 4 adjacent
//   columns of the group and reads their 4 weight codes of a k row as one
//   32-bit load (a warp reads one 128-byte line), so every weight code is
//   read from device memory once and applied to all M rows. All 32 lanes of
//   a warp then gather from the same table row (one activation code) at their
//   own column offsets, which spreads them over the 32 banks; a table laid
//   out by weight code would put them all in one bank.
// * Per segment the warps' sums meet in shared memory (shared atomicAdd),
//   then go out as one global atomicAdd per output.
//
// The masked product rule: rows beyond M, columns beyond N and k beyond the
// segment are never summed (no operand is zero-filled into a sum; f(0,0) is
// 192 at proposed@8). Columns beyond N compute garbage that is never stored.
//
// Contract (the launcher checks it): 1 <= M <= DC_MAX_M, 1 <= n <= 8, the
// table 2^(2n) int16 and 16-byte aligned, C zeroed by the launcher. The
// weight is read as 32-bit words where N % 4 == 0 and it is 4-byte aligned,
// else byte by byte.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#define DC_THREADS 512
#define DC_WARPS (DC_THREADS / 32)
#define DC_COLS 128   // columns of a group: 32 lanes x 4
#define DC_CHUNK 256  // k rows staged per chunk
#define DC_MAX_M 16
#define DC_MAX_BITS 8
#define DC_UNROLL 4   // k rows a warp loads ahead of its gathers

// Internal linkage: approx_matmul.cu and lut_matmul.cu each build their own
// copy into their own library (see narrow_contract.cuh).
namespace {

__host__ __device__ constexpr int dc_mp(int m) { return (m + 3) & ~3; }

// the most shared memory any launch takes: the n = 8 table, the chunk's row
// offsets and the group's sums at M = 16
constexpr int kDcMaxSmem = (2 << (2 * DC_MAX_BITS)) +
                           DC_CHUNK * DC_MAX_M * 4 + DC_MAX_M * DC_COLS * 4;

__device__ __forceinline__ int dc_table_bytes(int n_bits) {
  return max(16, 2 << (2 * n_bits));
}

template <int M>
__global__ void __launch_bounds__(DC_THREADS, 1)
    decode_matmul_kernel(const int8_t* __restrict__ A,
                         const int8_t* __restrict__ Bw,
                         const int16_t* __restrict__ table,
                         int32_t* __restrict__ C, int K, int N, int n_bits,
                         int n_groups, long long total, int vec_b) {
  constexpr int MP = dc_mp(M);
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int tbytes = dc_table_bytes(n_bits);
  const unsigned char* stab = dc_smem;
  uint32_t* rowoff = reinterpret_cast<uint32_t*>(dc_smem + tbytes);
  int32_t* red = reinterpret_cast<int32_t*>(rowoff + DC_CHUNK * MP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (n_bits >= 2) {  // 2^(2n) int16 is a whole number of 16-byte words
    const int4* src = reinterpret_cast<const int4*>(table);
    int4* dst = reinterpret_cast<int4*>(dc_smem);
    for (int e = tid; e < (2 << (2 * n_bits)) / 16; e += DC_THREADS) {
      dst[e] = src[e];
    }
  } else {
    for (int e = tid; e < (1 << (2 * n_bits)); e += DC_THREADS) {
      reinterpret_cast<int16_t*>(dc_smem)[e] = table[e];
    }
  }
  for (int e = tid; e < M * DC_COLS; e += DC_THREADS) red[e] = 0;

  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  long long it = static_cast<long long>(blockIdx.x) * per;
  const long long end = min(total, it + per);
  while (it < end) {
    const long long seg = it / K;  // (batch, group)
    const int klo = static_cast<int>(it - seg * K);
    const int khi = static_cast<int>(min(static_cast<long long>(K),
                                         klo + (end - it)));
    const int z = static_cast<int>(seg / n_groups);
    const int g = static_cast<int>(seg - static_cast<long long>(z) * n_groups);
    const int col0 = g * DC_COLS + 4 * lane;
    const int8_t* Az = A + static_cast<size_t>(z) * M * K;
    const int8_t* Bz = Bw + static_cast<size_t>(z) * K * N;

    uint32_t acc[M][4];  // int32 ring: unsigned wraparound is defined
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0u;
    }

    for (int kc = klo; kc < khi; kc += DC_CHUNK) {
      const int kn = min(DC_CHUNK, khi - kc);
      __syncthreads();  // the previous chunk's offsets are read (and, the
                        // first time, the table and sums are in place)
      for (int e = tid; e < kn * M; e += DC_THREADS) {
        const int m = e / kn, kk = e - m * kn;  // consecutive k: coalesced
        const uint32_t xa = (static_cast<uint32_t>(static_cast<int32_t>(
                                 Az[static_cast<size_t>(m) * K + kc + kk])) +
                             off) & mask;
        rowoff[kk * MP + m] = xa << (n_bits + 1);
      }
      __syncthreads();

      for (int k0 = warp; k0 < kn; k0 += DC_WARPS * DC_UNROLL) {
        uint32_t w4[DC_UNROLL];
#pragma unroll
        for (int u = 0; u < DC_UNROLL; ++u) {
          const int kk = k0 + u * DC_WARPS;
          w4[u] = 0u;
          if (kk < kn) {
            const int8_t* row = Bz + static_cast<size_t>(kc + kk) * N;
            if (vec_b) {
              if (col0 < N) w4[u] = __ldg(reinterpret_cast<const uint32_t*>(row + col0));
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (col0 + c < N) {
                  w4[u] |= static_cast<uint32_t>(static_cast<uint8_t>(
                               __ldg(row + col0 + c))) << (8 * c);
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < DC_UNROLL; ++u) {
          const int kk = k0 + u * DC_WARPS;
          if (kk >= kn) break;  // mask the product, not the operand
          uint32_t xb2[4];  // byte offsets of the 4 columns within a row
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            xb2[c] = (((w4[u] >> (8 * c)) + off) & mask) << 1;
          }
          const uint4* rp = reinterpret_cast<const uint4*>(rowoff + kk * MP);
#pragma unroll
          for (int q = 0; q < MP / 4; ++q) {
            const uint4 r = rp[q];
            const uint32_t ro[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * q + j < M) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  acc[4 * q + j][c] += static_cast<uint32_t>(static_cast<int32_t>(
                      *reinterpret_cast<const int16_t*>(stab + (ro[j] + xb2[c]))));
                }
              }
            }
          }
        }
      }
    }

    // the warps' sums of this segment meet in shared memory, [m][c][lane]
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        atomicAdd(red + (m * 4 + c) * 32 + lane, static_cast<int32_t>(acc[m][c]));
      }
    }
    __syncthreads();
    for (int e = tid; e < M * DC_COLS; e += DC_THREADS) {
      const int m = e / DC_COLS, r = e - m * DC_COLS;
      const int col = g * DC_COLS + 4 * (r & 31) + (r >> 5);
      if (col < N) {
        atomicAdd(C + (static_cast<size_t>(z) * M + m) * N + col, red[e]);
      }
      red[e] = 0;  // the next segment adds in after its first __syncthreads
    }
    it += khi - klo;
  }
}

template <int M>
cudaError_t decode_contract_run(const int8_t* a, const int8_t* b,
                                const int16_t* table, int32_t* c, int B, int K,
                                int N, int n_bits, cudaStream_t stream) {
  // the opt-in limit is always the most any launch takes, so that concurrent
  // launches of other shapes never see a smaller one
  cudaError_t e = cudaFuncSetAttribute(
      decode_matmul_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDcMaxSmem);
  if (e != cudaSuccess) return e;
  const size_t smem = static_cast<size_t>(std::max(16, 2 << (2 * n_bits))) +
                      static_cast<size_t>(DC_CHUNK) * dc_mp(M) * 4 +
                      static_cast<size_t>(M) * DC_COLS * 4;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_matmul_kernel<M>, DC_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_groups = (N + DC_COLS - 1) / DC_COLS;
  const long long total = static_cast<long long>(B) * n_groups * K;
  // at least 64 k rows of one group per block, at most one wave
  const long long want = std::max(1LL, total / 64);
  const int grid = static_cast<int>(std::min<long long>(
      static_cast<long long>(sms) * per_sm, want));
  e = cudaMemsetAsync(c, 0, static_cast<size_t>(B) * M * N * sizeof(int32_t),
                      stream);
  if (e != cudaSuccess) return e;
  const uintptr_t bw = reinterpret_cast<uintptr_t>(b);
  const int vec_b = (N % 4 == 0 && bw % 4 == 0) ? 1 : 0;
  decode_matmul_kernel<M><<<grid, DC_THREADS, smem, stream>>>(
      a, b, table, c, K, N, n_bits, n_groups, total, vec_b);
  return cudaGetLastError();
}

// Launches decode_matmul_kernel<M> for a runtime M in 1..DC_MAX_M: a
// (B, M, K) int8, b (B, K, N) int8, both contiguous; table 2^(2n) int16;
// c (B, M, N) int32, zeroed here on the stream. cudaErrorInvalidValue or
// cudaErrorMisalignedAddress if the contract does not hold.
cudaError_t decode_contract(const int8_t* a, const int8_t* b,
                            const int16_t* table, int32_t* c, int B, int M,
                            int K, int N, int n_bits, cudaStream_t stream) {
  if (B < 1 || M < 1 || M > DC_MAX_M || K < 1 || N < 1 || n_bits < 1 ||
      n_bits > DC_MAX_BITS) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  switch (M) {
#define DC_CASE(m) \
  case m:          \
    return decode_contract_run<m>(a, b, table, c, B, K, N, n_bits, stream);
    DC_CASE(1) DC_CASE(2) DC_CASE(3) DC_CASE(4) DC_CASE(5) DC_CASE(6)
    DC_CASE(7) DC_CASE(8) DC_CASE(9) DC_CASE(10) DC_CASE(11) DC_CASE(12)
    DC_CASE(13) DC_CASE(14) DC_CASE(15) DC_CASE(16)
#undef DC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
