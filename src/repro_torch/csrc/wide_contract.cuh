// Wide contraction: (B,M,K) @ (B,K,N) under the closed form at widths 9..16
// on the INT8 tensor cores, approx_matmul.cu's wide design.
//
// At widths 9..16 no product table fits a block (2^32 entries at 16), so
// before this design every product paid the generic closed form in the
// tile design (about a hundred INT32 operations read from the constant
// bank, 0.16-1.9% of its bound). Here the closed form is taken apart on the
// host (kernels/monomials.py, wide_planes) from its parameter block:
//
//   f(a, b) = f00 + sum_p sign_p * 2^shift_p * A_p(a) * B_p(b)
//
// exact as integers (the 2n-bit wrap never fires), where each side is a
// byte-valued function of an operand's wrapped 16-bit value: its unsigned
// low byte, its signed high byte, a byte under a mask, or a bit test of
// its n-bit code times a byte. The planes: the exact product in four byte
// GEMMs (scales 1, 256, 256, 65536); the truncation, one plane per bit
// a_i (i < n - 1) against the bytes of b & (2^(n-1-i) - 1), those of one
// b side and scale merged by their a masks (the bits i <= n - 9 meet the
// whole low byte of b, so they fold into the exact LO x LO plane and cancel
// it at width 16); and the few bit-monomial pairs [a ⊇ S][b ⊇ T] of the
// compensation, conversion and compressor errors. P = 26 planes at
// proposed@12, 29 at proposed@16.
// Summed over k that is P int8 GEMMs plus K * f00: work for the tensor
// cores, and no B-side plane is ever written to device memory.
//
// Bound on the H100: P * 2 * M * K * N int8 tensor-core operations
// against the operand and output bytes, so the tensor cores at M = 256.
//
// * A prologue (wd_split_kernel) writes each operand's wrapped values as
//   two byte planes, low and high, zero-padded to 128 rows and 32 k, the
//   weight transposed to (N, K): K-contiguous per column as the mma's col
//   operand needs, so nothing is transposed in the main loop. 6 bytes a
//   weight element against the P GEMMs' work.
// * Block tiles of 128 x 128 outputs, 8 warps of 32 x 64; K streamed in
//   chunks of 32 through a 3-stage cp.async ring of the four byte tiles
//   (swizzled as rows_contract.cuh's, conflict-free ldmatrix). Per chunk a
//   warp loads its raw fragments once (both bytes of both operands), then
//   per plane builds each side's fragment in registers (an AND, or the
//   SIMD-within-a-word bit test and a sign-replicating prmt, on four codes
//   a word) and issues 16 mma.sync.m16n8k32 of the plane's operand types
//   (.u8 or .s8 on either side).
// * Planes come in accumulator groups by (sign, shift), at most 8. A group
//   sums its planes of the chunk in an int32 scratch accumulator (at most
//   64 planes x 32 k x 2^16 per product: no overflow), which is then folded
//   into the uint32 result with one multiply-add by +-2^shift, wrapping in
//   the int32 ring. So no mma accumulator overflows at any K.
// * Split K: as many k ranges per output tile as one wave of resident
//   blocks holds, combined with int32 atomicAdd on an output the launcher
//   zeroes (exact and order-independent in the int32 ring).
// * K tail: the padded k of both operands are zero codes, and every plane
//   gives 0 at a zero code of either operand (bit tests of nonempty masks,
//   masked bytes, bytes of 0), so they add nothing; the k range's first
//   block adds K * f00 for the real k alone (the masked-product rule).
//   Rows beyond M and columns beyond N are never stored.
//
// Contract (the launcher checks it): 1 <= B <= 65535, M, K, N >= 1,
// 9 <= n <= 16, the parameter block of kernels/monomials.wide_device_params
// (1 <= P <= 64 planes, 1 <= G <= 8 groups), the scratch of
// 2 B (Mp + Np) Kp bytes on the card and 16-byte aligned (Mp, Np: M, N
// rounded up to 128; Kp: K rounded up to 32).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>

#define WD_THREADS 256
#define WD_BM 128
#define WD_BN 128
#define WD_BK 32
#define WD_STAGES 3
#define WD_TILE (WD_BM * WD_BK)  // bytes of one byte tile
#define WD_STAGE_BYTES (4 * WD_TILE)
#define WD_MIN_BITS 9
#define WD_MAX_BITS 16
#define WD_MAX_PLANES 64
#define WD_MAX_GROUPS 8
#define WD_PLANE_WORDS 12
#define WD_PLANES_AT (2 + 2 * WD_MAX_GROUPS)
#define WD_PARAM_LEN (WD_PLANES_AT + WD_MAX_PLANES * WD_PLANE_WORDS)

// side kinds (kernels/monomials.py: LO, HI, AND_LO, AND_HI, TEST)
#define WD_LO 0
#define WD_HI 1
#define WD_AND_LO 2
#define WD_AND_HI 3
#define WD_TEST 4
#define WD_TEST_LO 5
#define WD_TEST_HI 6

// Internal linkage, as rows_contract.cuh.
namespace {

// Passed by value as a __grid_constant__: read from the constant bank.
struct WDParams {
  int32_t p[WD_PARAM_LEN];
};

__device__ __forceinline__ uint32_t wd_saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wd_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   wd_saddr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wd_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wd_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(WD_STAGES - 2) : "memory");
}

__device__ __forceinline__ void wd_ldmatrix4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wd_saddr(p))
      : "memory");
}

// each byte 0xFF where its bit 7 is set, else 0
__device__ __forceinline__ uint32_t wd_sign_bytes(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xBA98;\n" : "=r"(r) : "r"(x), "r"(0u));
  return r;
}

// bit 7 of each byte set where the byte holds every bit of the mask whose
// low 7 bits are `low` and whose bit 7 is clear in `top` (rows_contract.cuh)
__device__ __forceinline__ uint32_t wd_test(uint32_t x, uint32_t low,
                                            uint32_t top) {
  return (0x80808080u - (~x & low)) & (x | top);
}

// One side of a plane on NR fragment registers of 4 codes each: lo / hi
// the codes' low and high bytes, q the side's 5 words (kernels/monomials.
// wide_device_params). The kind is the same for the whole warp.
template <int NR>
__device__ __forceinline__ void wd_side(int kind, const uint32_t* lo,
                                        const uint32_t* hi, uint32_t q0,
                                        uint32_t q1, uint32_t q2, uint32_t q3,
                                        uint32_t q4, uint32_t* out) {
  switch (kind) {
    case WD_LO:
#pragma unroll
      for (int i = 0; i < NR; ++i) out[i] = lo[i];
      break;
    case WD_HI:
#pragma unroll
      for (int i = 0; i < NR; ++i) out[i] = hi[i];
      break;
    case WD_AND_LO:
#pragma unroll
      for (int i = 0; i < NR; ++i) out[i] = lo[i] & q0;
      break;
    case WD_AND_HI:
#pragma unroll
      for (int i = 0; i < NR; ++i) out[i] = hi[i] & q0;
      break;
    case WD_TEST_LO:
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        out[i] = wd_sign_bytes(wd_test(lo[i], q0, q1)) & q4;
      }
      break;
    case WD_TEST_HI:
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        out[i] = wd_sign_bytes(wd_test(hi[i], q2, q3)) & q4;
      }
      break;
    default:
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        out[i] = wd_sign_bytes(wd_test(lo[i], q0, q1) &
                               wd_test(hi[i], q2, q3)) & q4;
      }
      break;
  }
}

// mma.sync m16n8k32 with the plane's operand types (.s8 where signed)
template <bool SA, bool SB>
__device__ __forceinline__ void wd_mma(int32_t* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  if constexpr (!SA && !SB) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else if constexpr (!SA && SB) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else if constexpr (SA && !SB) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// the 2 x 8 mma of a warp tile for one plane
template <bool SA, bool SB>
__device__ __forceinline__ void wd_plane(int32_t (*t)[8][4], uint32_t (*af)[4],
                                         uint32_t (*bf)[2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      wd_mma<SA, SB>(t[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
}

// out[z][r][c] (r < Rp, c < Cp; lo and hi bytes of the operand's wrapped
// n-bit value, zero beyond R rows and C columns) from in (B, R, C), or from
// in (B, C, R) where `transpose`; 32 x 32 tiles, 32 x 8 threads.
__global__ void wd_split_kernel(const int32_t* __restrict__ in,
                                int8_t* __restrict__ lo,
                                int8_t* __restrict__ hi, int R, int C, int Rp,
                                int Cp, int n_bits, int transpose) {
  __shared__ int32_t tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const size_t z = blockIdx.z;
  const int sh = 32 - n_bits;
  for (int j = ty; j < 32; j += 8) {
    // read along the input's contiguous axis
    const int r = transpose ? r0 + tx : r0 + j;
    const int c = transpose ? c0 + j : c0 + tx;
    int32_t v = 0;
    if (r < R && c < C) {
      const size_t idx = transpose ? (z * C + c) * R + r : (z * R + r) * C + c;
      v = static_cast<int32_t>(static_cast<uint32_t>(in[idx]) << sh) >> sh;
    }
    if (transpose) {
      tile[tx][j] = v;
    } else {
      tile[j][tx] = v;
    }
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int32_t v = tile[j][tx];
    const size_t o = (z * Rp + r0 + j) * Cp + c0 + tx;
    lo[o] = static_cast<int8_t>(v & 0xFF);
    hi[o] = static_cast<int8_t>(v >> 8);
  }
}

__global__ void __launch_bounds__(WD_THREADS, 1)
    wide_matmul_kernel(const int8_t* __restrict__ Alo,
                       const int8_t* __restrict__ Ahi,
                       const int8_t* __restrict__ Wlo,
                       const int8_t* __restrict__ Whi,
                       uint32_t* __restrict__ C, int M, int N, int Mp, int Np,
                       int Kp, int K, int kb, int f00, int atomic, int m_tiles,
                       const __grid_constant__ WDParams prm) {
  extern __shared__ __align__(16) unsigned char wd_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (blockIdx.x % m_tiles) * WD_BM;
  const int n0 = (blockIdx.x / m_tiles) * WD_BN;
  const size_t z = blockIdx.z;
  const int k_chunks = Kp / WD_BK;
  const int c_lo = blockIdx.y * kb, c_hi = min(k_chunks, c_lo + kb);
  const int8_t* a_lo = Alo + z * Mp * Kp;
  const int8_t* a_hi = Ahi + z * Mp * Kp;
  const int8_t* w_lo = Wlo + z * Np * Kp;
  const int8_t* w_hi = Whi + z * Np * Kp;

  // chunk -> stage: row tid / 2 of each tile, 16-byte half tid % 2, stored
  // at half ^ (row / 4 % 2)
  auto load = [&](int chunk, int stage) {
    const int r = tid >> 1, h = tid & 1;
    const int k = chunk * WD_BK + 16 * h;
    const int so = r * WD_BK + 16 * (h ^ ((r >> 2) & 1));
    unsigned char* st = wd_smem + stage * WD_STAGE_BYTES + so;
    const size_t ra = static_cast<size_t>(m0 + r) * Kp + k;
    const size_t rw = static_cast<size_t>(n0 + r) * Kp + k;
    wd_cp_async16(st, a_lo + ra);
    wd_cp_async16(st + WD_TILE, a_hi + ra);
    wd_cp_async16(st + 2 * WD_TILE, w_lo + rw);
    wd_cp_async16(st + 3 * WD_TILE, w_hi + rw);
  };

  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows 32 wm, cols 64 wn
  const int n_groups = prm.p[1];

  uint32_t acc[2][8][4];  // the int32 ring: unsigned wraparound is defined
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0u;
    }
  }

#pragma unroll
  for (int s = 0; s < WD_STAGES - 1; ++s) {
    if (c_lo + s < c_hi) load(c_lo + s, s);
    wd_cp_commit();
  }

  for (int c = c_lo; c < c_hi; ++c) {
    const int stage = (c - c_lo) % WD_STAGES;
    wd_cp_wait();
    __syncthreads();  // chunk c in place; every warp is done with chunk c - 1
    {
      const int next = c + WD_STAGES - 1;
      if (next < c_hi) load(next, (next - c_lo) % WD_STAGES);
      wd_cp_commit();
    }

    // -- the raw fragments of this chunk: both bytes of both operands
    uint32_t alo[2][4], ahi[2][4], blo[8][2], bhi[8][2];
    {
      const unsigned char* st = wd_smem + stage * WD_STAGE_BYTES;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 32 * wm + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int h = lane >> 4;
        const int o = r * WD_BK + 16 * (h ^ ((r >> 2) & 1));
        wd_ldmatrix4(alo[mt], st + o);
        wd_ldmatrix4(ahi[mt], st + WD_TILE + o);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = 64 * wn + 16 * np + (lane & 7) + 8 * ((lane >> 4) & 1);
        const int h = (lane >> 3) & 1;
        const int o = n * WD_BK + 16 * (h ^ ((n >> 2) & 1));
        uint32_t r4[4];
        wd_ldmatrix4(r4, st + 2 * WD_TILE + o);
        blo[2 * np][0] = r4[0];
        blo[2 * np][1] = r4[1];
        blo[2 * np + 1][0] = r4[2];
        blo[2 * np + 1][1] = r4[3];
        wd_ldmatrix4(r4, st + 3 * WD_TILE + o);
        bhi[2 * np][0] = r4[0];
        bhi[2 * np][1] = r4[1];
        bhi[2 * np + 1][0] = r4[2];
        bhi[2 * np + 1][1] = r4[3];
      }
    }

    // -- the planes, group by group
    int p = 0;
    for (int g = 0; g < n_groups; ++g) {
      int32_t t[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) t[i][j][q] = 0;
        }
      }
      const int p_end = prm.p[2 + g];
      for (; p < p_end; ++p) {
        const int32_t* w = prm.p + WD_PLANES_AT + p * WD_PLANE_WORDS;
        const uint32_t kinds = static_cast<uint32_t>(w[0]);
        uint32_t af[2][4], bf[8][2];
        wd_side<8>(static_cast<int>(kinds & 0xFF), &alo[0][0], &ahi[0][0],
                   w[1], w[2], w[3], w[4], w[5], &af[0][0]);
        wd_side<16>(static_cast<int>((kinds >> 8) & 0xFF), &blo[0][0],
                    &bhi[0][0], w[6], w[7], w[8], w[9], w[10], &bf[0][0]);
        switch (((kinds >> 16) & 1u) | ((kinds >> 23) & 2u)) {
          case 0: wd_plane<false, false>(t, af, bf); break;
          case 1: wd_plane<true, false>(t, af, bf); break;
          case 2: wd_plane<false, true>(t, af, bf); break;
          default: wd_plane<true, true>(t, af, bf); break;
        }
      }
      const uint32_t mul = static_cast<uint32_t>(prm.p[2 + WD_MAX_GROUPS + g]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][j][q] += static_cast<uint32_t>(t[i][j][q]) * mul;
          }
        }
      }
    }
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none outlives the block

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  const uint32_t kf = blockIdx.y == 0
      ? static_cast<uint32_t>(K) * static_cast<uint32_t>(f00) : 0u;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 32 * wm + 16 * mt + g + 8 * h;
      if (row >= M) continue;
      uint32_t* out = C + (z * M + row) * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 64 * wn + 8 * nt + 2 * t + e;
          if (col < N) {
            const uint32_t v = acc[mt][nt][2 * h + e] + kf;
            if (atomic) {
              atomicAdd(out + col, v);
            } else {
              out[col] = v;
            }
          }
        }
      }
    }
  }
}

constexpr int wd_round(int x, int to) { return (x + to - 1) / to * to; }

// Bytes of the launch's scratch: the two byte planes of A (B, Mp, Kp) and of
// the transposed weight (B, Np, Kp).
size_t wide_scratch_bytes(int B, int M, int K, int N) {
  const size_t kp = wd_round(K, WD_BK);
  return 2 * static_cast<size_t>(B) *
         (static_cast<size_t>(wd_round(M, WD_BM)) + wd_round(N, WD_BN)) * kp;
}

// Launches the split prologue and wide_matmul_kernel: a (B, M, K) int32,
// w (B, K, N) int32, both contiguous, any int32 values (wrapped to n bits
// here); params the host block of kernels/monomials.wide_device_params;
// f00 the closed form at (0, 0); scratch as wide_scratch_bytes; c (B, M, N)
// int32 (zeroed here on the stream where K is split).
// cudaErrorInvalidValue or cudaErrorMisalignedAddress if the contract does
// not hold (scratch_bytes below wide_scratch_bytes among it).
cudaError_t wide_contract(const int32_t* a, const int32_t* w,
                          const int32_t* params, int32_t* c, int8_t* scratch,
                          long long scratch_bytes, int B, int M, int K, int N,
                          int n_bits, int f00, cudaStream_t stream) {
  if (B < 1 || B > 65535 || M < 1 || K < 1 || N < 1 || n_bits < WD_MIN_BITS ||
      n_bits > WD_MAX_BITS || M > INT_MAX - WD_BM || N > INT_MAX - WD_BN ||
      K > INT_MAX - WD_BK ||
      scratch_bytes < static_cast<long long>(wide_scratch_bytes(B, M, K, N))) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  WDParams prm;
  std::memcpy(prm.p, params, sizeof(prm.p));
  const int P = prm.p[0], G = prm.p[1];
  if (P < 1 || P > WD_MAX_PLANES || G < 1 || G > WD_MAX_GROUPS ||
      prm.p[1 + G] != P) {
    return cudaErrorInvalidValue;
  }
  const int Mp = wd_round(M, WD_BM), Np = wd_round(N, WD_BN);
  const int Kp = wd_round(K, WD_BK);
  if (Kp / 32 > 65535) return cudaErrorInvalidValue;
  int8_t* a_lo = scratch;
  int8_t* a_hi = a_lo + static_cast<size_t>(B) * Mp * Kp;
  int8_t* w_lo = a_hi + static_cast<size_t>(B) * Mp * Kp;
  int8_t* w_hi = w_lo + static_cast<size_t>(B) * Np * Kp;
  const dim3 sb(32, 8);
  wd_split_kernel<<<dim3(Mp / 32, Kp / 32, B), sb, 0, stream>>>(
      a, a_lo, a_hi, M, K, Mp, Kp, n_bits, 0);
  wd_split_kernel<<<dim3(Np / 32, Kp / 32, B), sb, 0, stream>>>(
      w, w_lo, w_hi, N, K, Np, Kp, n_bits, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int smem = WD_STAGES * WD_STAGE_BYTES;
  e = cudaFuncSetAttribute(wide_matmul_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wide_matmul_kernel, WD_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long m_tiles = Mp / WD_BM;
  const long long tiles_mn = m_tiles * (Np / WD_BN);
  if (tiles_mn > INT_MAX) return cudaErrorInvalidValue;
  const long long tiles = tiles_mn * B;
  const long long k_chunks = Kp / WD_BK;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long split = std::max(1LL, std::min(k_chunks, slots / tiles));
  const long long kb = (k_chunks + split - 1) / split;
  const long long grid_y = (k_chunks + kb - 1) / kb;
  const int atomic = grid_y > 1 ? 1 : 0;
  if (atomic) {
    e = cudaMemsetAsync(c, 0, static_cast<size_t>(B) * M * N * sizeof(int32_t),
                        stream);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(tiles_mn),
                  static_cast<unsigned>(grid_y), static_cast<unsigned>(B));
  wide_matmul_kernel<<<grid, WD_THREADS, smem, stream>>>(
      a_lo, a_hi, w_lo, w_hi, reinterpret_cast<uint32_t*>(c), M, N, Mp, Np, Kp,
      K, static_cast<int>(kb), f00, atomic, static_cast<int>(m_tiles), prm);
  return cudaGetLastError();
}

}  // namespace
