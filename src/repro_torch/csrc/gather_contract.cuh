// Gather contraction: (B,M,K) @ (B,K,N) int8 codes against a product table
// in shared memory at any M, lut_matmul.cu's gather design.
//
// It takes the tables the other designs refuse: entries beyond int16 (no
// int16 twin for the decode design), or int16 tables beyond the rows
// design's 32 planes at M > 16. Before it the tile design gathered every
// product through the read-only path from L1/L2 (a 256 KiB int32 table
// at n = 8 is more than a block's 227 KiB of shared memory), one thread an
// output. Here, as decode_contract.cuh does for M <= 16:
//
//     f(a, b) = table[((a + 2^(n-1)) & (2^n - 1)) << n | ((b + 2^(n-1)) & (2^n - 1))]
//
// with the table in shared memory: its int16 twin where every entry fits
// (128 KiB at n = 8), else the int32 table itself in row windows of at
// most 128 KiB: whole at n <= 7, two windows of 128 rows (activation codes)
// at n = 8. A window's pass sums only the products whose activation code
// falls in it; every product is read exactly once, as one 4-byte entry.
// (Splitting an entry exactly, T = lo + 65536 hi, would fit both halves at
// once, but doubles the shared-memory gathers, which bound this design.)
//
// Bound on the H100: 2 M K N operations (a table read and an add per
// product) against M K + K N + 4 M N bytes, so INT32 operations; in
// practice the shared-memory gathers (random lookups, 3-4 wavefronts a
// warp gather).
//
// * Persistent blocks, one per SM: each walks an equal share of the work
//   space windows x B x (M / 16) x (N / 128) x K (window, batch, 16-row
//   tile, 128-column group, k row) in segments of one (window, tile,
//   group) and a contiguous k range, loading a window into shared memory
//   when its share enters it (at most once per window it touches). The k
//   ranges a (tile, group) is split into, and its windows, combine with
//   int32 atomicAdd on an output the launcher zeroes: exact and
//   order-independent in the int32 ring.
// * A segment streams its k range in chunks of GC_CHUNK rows: the tile's
//   16 rows' activation codes are staged as byte offsets of their table
//   rows within the window, or GC_SKIP where the code is in another window
//   (or the row is beyond M).
// * The 16 warps take the chunk's k rows in turn; lane l owns 4 adjacent
//   columns of the group and reads their 4 weight codes of a k row as one
//   32-bit load, so each weight code is read once per row tile. All 32
//   lanes of a warp read the same row offset (one activation code), so a
//   skipped row is a branch the whole warp takes: a window's pass costs
//   nothing for the products of the other, and the gathers of a row spread
//   over the 32 banks by column.
// * Per segment the warps' sums meet in shared memory, then go out as one
//   global atomicAdd per output; warps without a k row, rows beyond M and
//   columns beyond N take no part, so a narrow N pays for its own columns.
//
// The masked product rule: rows beyond M, columns beyond N and k beyond the
// segment are never summed (no operand is zero-filled into a sum).
//
// Contract (the launcher checks it): 1 <= B <= 65535, M, K, N >= 1,
// 1 <= n <= 8, the table 2^(2n) entries of 2 (int16) or 4 (int32) bytes,
// 16-byte aligned; C zeroed by the launcher. The weight is read as 32-bit
// words where N % 4 == 0 and it is 4-byte aligned, else byte by byte.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#define GC_THREADS 512
#define GC_WARPS (GC_THREADS / 32)
#define GC_COLS 128   // columns of a group: 32 lanes x 4
#define GC_CHUNK 256  // k rows staged per chunk
#define GC_ROWS 16    // rows of a row tile
#define GC_MAX_BITS 8
#define GC_UNROLL 4   // k rows a warp loads ahead of its gathers
#define GC_WINDOW_BYTES (128 << 10)
#define GC_SKIP 0xFFFFFFFFu

// Internal linkage, as decode_contract.cuh.
namespace {

constexpr int kGcMaxSmem = GC_WINDOW_BYTES + GC_CHUNK * GC_ROWS * 4 +
                           GC_ROWS * GC_COLS * 4;

// table rows (activation codes) of one window at width n, entry size es
__host__ __device__ constexpr int gc_window_rows(int n_bits, int es) {
  return (1 << n_bits) * (1 << n_bits) * es <= GC_WINDOW_BYTES
             ? (1 << n_bits)
             : GC_WINDOW_BYTES / ((1 << n_bits) * es);
}

template <int ES>
__device__ __forceinline__ uint32_t gc_entry(const unsigned char* p) {
  if constexpr (ES == 2) {
    return static_cast<uint32_t>(
        static_cast<int32_t>(*reinterpret_cast<const int16_t*>(p)));
  } else {
    return *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int ES>  // table entry bytes: 2 (int16 twin) or 4 (int32)
__global__ void __launch_bounds__(GC_THREADS, 1)
    gather_matmul_kernel(const int8_t* __restrict__ A,
                         const int8_t* __restrict__ Bw,
                         const unsigned char* __restrict__ table,
                         int32_t* __restrict__ C, int M, int K, int N,
                         int n_bits, int n_groups, int m_tiles, int wrows,
                         int wbytes, long long per_window, long long total,
                         int vec_b) {
  extern __shared__ __align__(16) unsigned char gc_smem[];
  constexpr int ESH = ES == 2 ? 1 : 2;  // log2 of the entry size
  const unsigned char* stab = gc_smem;
  uint32_t* rowoff = reinterpret_cast<uint32_t*>(gc_smem + wbytes);
  int32_t* red = reinterpret_cast<int32_t*>(rowoff + GC_CHUNK * GC_ROWS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long table_bytes = static_cast<long long>(ES) << (2 * n_bits);

  for (int e = tid; e < GC_ROWS * GC_COLS; e += GC_THREADS) red[e] = 0;

  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  const long long segs_per_window = per_window / K;
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  long long it = static_cast<long long>(blockIdx.x) * per;
  const long long end = min(total, it + per);
  int loaded = -1;  // the window in shared memory
  while (it < end) {
    const long long seg = it / K;  // (window, batch, tile, group)
    const int klo = static_cast<int>(it - seg * K);
    const int khi = static_cast<int>(min(static_cast<long long>(K),
                                         klo + (end - it)));
    const int win = static_cast<int>(seg / segs_per_window);
    long long s = seg - win * segs_per_window;
    const int z = static_cast<int>(s / (static_cast<long long>(m_tiles) * n_groups));
    s -= static_cast<long long>(z) * m_tiles * n_groups;
    const int mt = static_cast<int>(s / n_groups);
    const int g = static_cast<int>(s - static_cast<long long>(mt) * n_groups);
    if (win != loaded) {
      __syncthreads();  // every warp is done with the old window
      const long long w0 = static_cast<long long>(win) * wbytes;
      const int nb = static_cast<int>(min(static_cast<long long>(wbytes),
                                          table_bytes - w0));
      if (nb % 16 == 0) {
        const int4* src = reinterpret_cast<const int4*>(table + w0);
        int4* dst = reinterpret_cast<int4*>(gc_smem);
        for (int e = tid; e < nb / 16; e += GC_THREADS) dst[e] = src[e];
      } else {
        for (int e = tid; e < nb; e += GC_THREADS) gc_smem[e] = table[w0 + e];
      }
      loaded = win;  // visible after the chunk's first __syncthreads
    }
    const int row_lo = win * wrows;
    const int col0 = g * GC_COLS + 4 * lane;
    const int8_t* Az = A + static_cast<size_t>(z) * M * K;
    const int8_t* Bz = Bw + static_cast<size_t>(z) * K * N;

    uint32_t acc[GC_ROWS][4];  // int32 ring: unsigned wraparound is defined
#pragma unroll
    for (int m = 0; m < GC_ROWS; ++m) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0u;
    }

    for (int kc = klo; kc < khi; kc += GC_CHUNK) {
      const int kn = min(GC_CHUNK, khi - kc);
      __syncthreads();  // the previous chunk's offsets are read (and, the
                        // first time, the window and sums are in place)
      for (int e = tid; e < kn * GC_ROWS; e += GC_THREADS) {
        const int m = e / kn, kk = e - m * kn;  // consecutive k: coalesced
        const int row = mt * GC_ROWS + m;
        uint32_t ro = GC_SKIP;
        if (row < M) {
          const uint32_t xa = (static_cast<uint32_t>(static_cast<int32_t>(
                                   Az[static_cast<size_t>(row) * K + kc + kk])) +
                               off) & mask;
          const int local = static_cast<int>(xa) - row_lo;
          if (local >= 0 && local < wrows) {
            ro = static_cast<uint32_t>(local) << (n_bits + ESH);
          }
        }
        rowoff[kk * GC_ROWS + m] = ro;
      }
      __syncthreads();

      for (int k0 = warp; k0 < kn; k0 += GC_WARPS * GC_UNROLL) {
        uint32_t w4[GC_UNROLL];
#pragma unroll
        for (int u = 0; u < GC_UNROLL; ++u) {
          const int kk = k0 + u * GC_WARPS;
          w4[u] = 0u;
          if (kk < kn) {
            const int8_t* rowp = Bz + static_cast<size_t>(kc + kk) * N;
            if (vec_b) {
              if (col0 < N) {
                w4[u] = __ldg(reinterpret_cast<const uint32_t*>(rowp + col0));
              }
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (col0 + c < N) {
                  w4[u] |= static_cast<uint32_t>(static_cast<uint8_t>(
                               __ldg(rowp + col0 + c))) << (8 * c);
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < GC_UNROLL; ++u) {
          const int kk = k0 + u * GC_WARPS;
          if (kk >= kn) break;  // mask the product, not the operand
          uint32_t xb[4];  // byte offsets of the 4 columns within a row
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            xb[c] = (((w4[u] >> (8 * c)) + off) & mask) << ESH;
          }
          const uint4* rp = reinterpret_cast<const uint4*>(rowoff + kk * GC_ROWS);
#pragma unroll
          for (int q = 0; q < GC_ROWS / 4; ++q) {
            const uint4 r = rp[q];
            const uint32_t ro[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (ro[j] != GC_SKIP) {  // the same for every lane
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  acc[4 * q + j][c] += gc_entry<ES>(stab + (ro[j] + xb[c]));
                }
              }
            }
          }
        }
      }
    }

    // the warps' sums of this segment meet in shared memory, [m][c][lane]:
    // only warps that took a k row, rows below M and columns below N (the
    // others' sums are zero or never stored)
    const int n_rows = min(GC_ROWS, M - mt * GC_ROWS);
    const int n_cols = min(GC_COLS, N - g * GC_COLS);
    if (warp < khi - klo) {
#pragma unroll
      for (int m = 0; m < GC_ROWS; ++m) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (m < n_rows && 4 * lane + c < n_cols) {
            atomicAdd(red + (m * 4 + c) * 32 + lane,
                      static_cast<int32_t>(acc[m][c]));
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n_rows * n_cols; e += GC_THREADS) {
      const int m = e / n_cols, j = e - m * n_cols;  // consecutive columns
      const int r = (m * 4 + (j & 3)) * 32 + (j >> 2);
      atomicAdd(C + (static_cast<size_t>(z) * M + mt * GC_ROWS + m) * N +
                    g * GC_COLS + j,
                red[r]);
      red[r] = 0;  // the next segment adds in after its first __syncthreads
    }
    it += khi - klo;
  }
}

template <int ES>
cudaError_t gather_contract_run(const int8_t* a, const int8_t* b,
                                const unsigned char* table, int32_t* c, int B,
                                int M, int K, int N, int n_bits,
                                cudaStream_t stream) {
  // the opt-in limit is always the most any launch takes, so that
  // concurrent launches of other shapes never see a smaller one
  cudaError_t e = cudaFuncSetAttribute(
      gather_matmul_kernel<ES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGcMaxSmem);
  if (e != cudaSuccess) return e;
  const int wrows = gc_window_rows(n_bits, ES);
  const int wbytes = ((wrows << n_bits) * ES + 15) / 16 * 16;
  const int windows = ((1 << n_bits) + wrows - 1) / wrows;
  const size_t smem = static_cast<size_t>(wbytes) + GC_CHUNK * GC_ROWS * 4 +
                      GC_ROWS * GC_COLS * 4;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_matmul_kernel<ES>, GC_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_groups = (N + GC_COLS - 1) / GC_COLS;
  const int m_tiles = (M + GC_ROWS - 1) / GC_ROWS;
  const long long per_window = static_cast<long long>(B) * m_tiles * n_groups * K;
  const long long total = per_window * windows;
  // at least 64 k rows of one segment per block, at most one wave
  const long long want = std::max(1LL, total / 64);
  const int grid = static_cast<int>(std::min<long long>(
      static_cast<long long>(sms) * per_sm, want));
  e = cudaMemsetAsync(c, 0, static_cast<size_t>(B) * M * N * sizeof(int32_t),
                      stream);
  if (e != cudaSuccess) return e;
  const uintptr_t bw = reinterpret_cast<uintptr_t>(b);
  const int vec_b = (N % 4 == 0 && bw % 4 == 0) ? 1 : 0;
  gather_matmul_kernel<ES><<<grid, GC_THREADS, smem, stream>>>(
      a, b, table, c, M, K, N, n_bits, n_groups, m_tiles, wrows, wbytes,
      per_window, total, vec_b);
  return cudaGetLastError();
}

// Launches gather_matmul_kernel: a (B, M, K) int8, b (B, K, N) int8, both
// contiguous; table 2^(2n) entries of entry_bytes (2: int16, 4: int32); c
// (B, M, N) int32, zeroed here on the stream. cudaErrorInvalidValue or
// cudaErrorMisalignedAddress if the contract does not hold.
cudaError_t gather_contract(const int8_t* a, const int8_t* b,
                            const void* table, int entry_bytes, int32_t* c,
                            int B, int M, int K, int N, int n_bits,
                            cudaStream_t stream) {
  if (B < 1 || B > 65535 || M < 1 || K < 1 || N < 1 || n_bits < 1 ||
      n_bits > GC_MAX_BITS || (entry_bytes != 2 && entry_bytes != 4)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const unsigned char* t = static_cast<const unsigned char*>(table);
  return entry_bytes == 2
             ? gather_contract_run<2>(a, b, t, c, B, M, K, N, n_bits, stream)
             : gather_contract_run<4>(a, b, t, c, B, M, K, N, n_bits, stream);
}

}  // namespace
