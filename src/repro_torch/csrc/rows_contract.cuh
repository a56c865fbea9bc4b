// Rows contraction: (B,M,K) @ (B,K,N) int8 codes for many rows (M > 16) on
// the INT8 tensor cores, shared by approx_matmul.cu and lut_matmul.cu.
//
// The served shapes are a training step's and a prefill's dense layers: M =
// 256 activation rows (8 x 32 or 4 x 64 tokens) against a (K x N) weight at
// K, N in {1024, 4096, 16384}. The tile design evaluates the generic closed
// form there (about a hundred INT32 operations per product, 1.3-1.4% of the
// INT32 bound), and a gather design is bound by shared-memory gathers. Here
// the product table is taken apart on the host (kernels/monomials.py):
//
//   f(a, b) = a*b + f00 + sum_r scale_r * [u(a) & S_r == S_r] * F_r(u(b))
//
// for the wrapped n-bit operands a, b and their unsigned n-bit codes u, with
// R bit-monomial planes (19 at proposed@8, 0 for the exact product) whose
// factors F_r are int8. Summed over k that is one exact int8 GEMM plus R
// int8 GEMMs of a 0/1 bit-test matrix against a mapped weight, plus K*f00:
// work for the tensor cores. Every plane adds into the same int32
// accumulator: its A-side byte is +1, -1 or +64, and a scale-256 plane's
// device factor is 4 * hi (64 * 4 = 256; kernels/monomials.device_planes).
//
// Bound on the H100: (R + 1) * 2 * M * K * N int8 tensor-core operations
// against M K + K N + 4 M N bytes, so the tensor cores at M = 256.
//
// * Block tiles of 128 x 128 outputs, 8 warps of 32 x 64; K streamed in
//   chunks of 32 through a 3-stage cp.async ring (A as [row][k], W as
//   [k][col], both 16-byte chunks XOR-swizzled so that every read below is
//   free of bank conflicts). Where K % 16, N % 16 or an operand's alignment
//   forbid 16-byte copies, the same ring is filled byte by byte.
// * Per chunk, the block expands the weight tile once into R + 1 planes in
//   shared memory, K-contiguous per column as the mma's col operand needs
//   (a 4 x 4 byte transpose per thread, as lut_matmul.cu's tensor design): plane 0 the
//   wrapped codes, plane r the factors F_r(w) gathered from a 256-row table
//   (one row per raw code, 4 planes per 32-bit word, odd row stride). All
//   128 rows of the block reuse them: the expansion is amortised over the
//   rows, which is the point of many rows.
// * Per plane, a warp builds its A fragment from the codes it holds in
//   registers (ldmatrix once per chunk): the wrapped codes for plane 0, for
//   plane r the per-byte bit test (code & S) == S (three SIMD-within-a-word
//   operations, a byte sign-replicating prmt) masked to the plane's A-side
//   byte; then ldmatrix.x4 of the plane's weight fragments and 16
//   mma.sync.m16n8k32.s32.s8.s8.s32.
// * Split K: as many k ranges per output tile as one wave of resident
//   blocks holds, combined with int32 atomicAdd on an output the launcher
//   zeroes (exact and order-independent in the int32 ring). No mma
//   accumulator may overflow (its behaviour then is not relied on): every
//   product of a plane is within 2^14 in magnitude, so a block's k range is
//   at most floor(2^31 / (2^14 (R + 1))) rows, and the ranges meet in
//   wrapping adds.
// * Epilogue: the k range's first block adds K * f00 (the masked-product
//   rule: every real k row contributes f00 once, zero-filled ones nothing;
//   a zero code's bit tests are 0 for every nonempty mask, and the empty
//   mask's factor is 0 at code 0). Rows beyond M and columns beyond N are
//   computed from zero-filled codes and never stored.
//
// Contract (the launcher checks it): 1 <= B <= 65535, M, K, N >= 1,
// 3 <= n <= 8, 0 <= R <= RC_MAX_PLANES, planes 4-byte aligned on the card:
// 64 + 256 * G words (G = max(1, ceil(R / 4)) | 1), the plane masks, the
// A-side bytes and the factor rows as kernels/monomials.device_planes lays
// them out.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#define RC_THREADS 256
#define RC_BM 128
#define RC_BN 128
#define RC_BK 32
#define RC_STAGES 3
#define RC_MAX_PLANES 32
#define RC_MIN_BITS 3
#define RC_MAX_BITS 8

// Internal linkage: approx_matmul.cu and lut_matmul.cu each build their own
// copy into their own library (see narrow_contract.cuh).
namespace {

__host__ __device__ constexpr int rc_groups(int planes) {
  return (planes > 4 ? (planes + 3) / 4 : 1) | 1;
}

// shared memory of a launch with R planes: plane words and factor rows, the
// A and W stages, the R + 1 expanded weight planes
__host__ __device__ constexpr int rc_smem_bytes(int planes) {
  return (2 * RC_MAX_PLANES + 256 * rc_groups(planes)) * 4 +
         RC_STAGES * (RC_BM * RC_BK + RC_BK * RC_BN) +
         (planes + 1) * RC_BN * RC_BK;
}

constexpr int kRcMaxSmem = rc_smem_bytes(RC_MAX_PLANES);

__device__ __forceinline__ uint32_t rc_saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void rc_cp_async16(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   rc_saddr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void rc_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void rc_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RC_STAGES - 2) : "memory");
}

__device__ __forceinline__ void rc_ldmatrix4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(rc_saddr(p))
      : "memory");
}

__device__ __forceinline__ void rc_mma(int32_t* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// each byte 0xFF where its bit 7 is set, else 0 (prmt's sign replication)
__device__ __forceinline__ uint32_t rc_sign_bytes(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xBA98;\n" : "=r"(r) : "r"(x), "r"(0u));
  return r;
}

// 4 words, each 4 bytes of one k row at 4 adjacent columns, into 4 words,
// each the 4 k rows (low byte first) of one column (as lut_matmul.cu)
__device__ __forceinline__ void rc_transpose4(uint32_t r0, uint32_t r1,
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

// Sign-extends the low n bits of each byte (n < 8): the wrapped n-bit
// values as int8. (u ^ s) + (0x80 - s) stays within a byte, then ^ 0x80.
struct RcWrap {
  uint32_t mask, sign, add;
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const {
    return (((x & mask) ^ sign) + add) ^ 0x80808080u;
  }
};

// 16 bytes of a row at gk (the A tile's k, or the W tile's columns), zero
// beyond `valid` bytes, into 16-byte aligned shared memory
__device__ __forceinline__ void rc_load16_bytes(int8_t* dst, const int8_t* src,
                                                int valid) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t w = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (4 * q + i < valid) {
        w |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * q + i]))
             << (8 * i);
      }
    }
    reinterpret_cast<uint32_t*>(dst)[q] = w;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(RC_THREADS, 2)
    rows_matmul_kernel(const int8_t* __restrict__ A,
                       const int8_t* __restrict__ W,
                       const uint32_t* __restrict__ planes,
                       uint32_t* __restrict__ C, int M, int K, int N,
                       int n_bits, int R, int kb, int f00, int atomic,
                       int m_tiles) {
  extern __shared__ __align__(16) unsigned char rc_smem[];
  const int G = rc_groups(R);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(rc_smem);
  uint32_t* s_abyte = s_mask + RC_MAX_PLANES;
  const uint32_t* s_tab = s_abyte + RC_MAX_PLANES;  // 256 rows x G words
  int8_t* s_a = reinterpret_cast<int8_t*>(s_mask + 2 * RC_MAX_PLANES + 256 * G);
  int8_t* s_w = s_a + RC_STAGES * RC_BM * RC_BK;
  int8_t* s_ex = s_w + RC_STAGES * RC_BK * RC_BN;  // (R + 1) x [col][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (blockIdx.x % m_tiles) * RC_BM;
  const int n0 = (blockIdx.x / m_tiles) * RC_BN;
  const int z = blockIdx.z;
  const int k_chunks = (K + RC_BK - 1) / RC_BK;
  const int c_lo = blockIdx.y * kb, c_hi = min(k_chunks, c_lo + kb);
  const int k_hi = min(K, c_hi * RC_BK);
  const int8_t* Az = A + static_cast<size_t>(z) * M * K;
  const int8_t* Wz = W + static_cast<size_t>(z) * K * N;

  for (int e = tid; e < 2 * RC_MAX_PLANES + 256 * G; e += RC_THREADS) {
    s_mask[e] = __ldg(planes + e);
  }

  // chunk -> stage: A row tid / 2, 16-byte half tid % 2, stored at half
  // ^ (row / 4 % 2); W k row tid / 8, 16-byte column group tid % 8, stored
  // at group ^ (k row / 4 % 8)
  auto load = [&](int chunk, int stage) {
    const int k0 = chunk * RC_BK;
    {
      const int r = tid >> 1, h = tid & 1;
      const int gm = m0 + r, gk = k0 + 16 * h;
      int8_t* dst = s_a + stage * RC_BM * RC_BK + r * RC_BK +
                    16 * (h ^ ((r >> 2) & 1));
      const bool ok = gm < M && gk < k_hi;
      const int8_t* src = ok ? Az + static_cast<size_t>(gm) * K + gk : Az;
      if (VEC) {
        rc_cp_async16(dst, src, ok ? 16 : 0);
      } else {
        rc_load16_bytes(dst, src, ok ? k_hi - gk : 0);
      }
    }
    {
      const int r = tid >> 3, g = tid & 7;
      const int gk = k0 + r, gn = n0 + 16 * g;
      int8_t* dst = s_w + stage * RC_BK * RC_BN + r * RC_BN +
                    16 * (g ^ ((r >> 2) & 7));
      const bool ok = gk < k_hi && gn < N;
      const int8_t* src = ok ? Wz + static_cast<size_t>(gk) * N + gn : Wz;
      if (VEC) {
        rc_cp_async16(dst, src, ok ? 16 : 0);
      } else {
        rc_load16_bytes(dst, src, ok ? N - gn : 0);
      }
    }
  };

  const bool wrap = n_bits < 8;
  const uint32_t code_mask = (1u << n_bits) - 1, sign = 1u << (n_bits - 1);
  const RcWrap wrapper{code_mask * 0x01010101u, sign * 0x01010101u,
                       (0x80u - sign) * 0x01010101u};
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows 32 wm, cols 64 wn
  // expansion: this thread's 4 k rows (4 kq ..) x 4 columns (4 nq ..)
  const int kq = lane & 7, nql = lane >> 3, nq = 4 * warp + nql;

  int32_t acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < RC_STAGES - 1; ++s) {
    if (c_lo + s < c_hi) load(c_lo + s, s);
    rc_cp_commit();
  }

  for (int c = c_lo; c < c_hi; ++c) {
    const int stage = (c - c_lo) % RC_STAGES;
    rc_cp_wait();
    __syncthreads();  // chunk c in place; every warp is done with chunk c - 1
    {
      const int next = c + RC_STAGES - 1;
      if (next < c_hi) load(next, (next - c_lo) % RC_STAGES);
      rc_cp_commit();
    }

    // -- expand the weight tile into the R + 1 planes, [col][k] per plane
    {
      const int8_t* sw = s_w + stage * RC_BK * RC_BN;
      uint32_t x[4], col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const uint32_t*>(
            sw + (4 * kq + i) * RC_BN + 16 * (warp ^ kq) + 4 * nql);
      }
      rc_transpose4(x[0], x[1], x[2], x[3], col);
      // rotate by nql: in store s the 4 lanes groups of a warp write 4
      // different columns, so that the 32 lanes hit 32 banks
      if (nql & 1) {
        const uint32_t t = col[0];
        col[0] = col[1]; col[1] = col[2]; col[2] = col[3]; col[3] = t;
      }
      if (nql & 2) {
        uint32_t t = col[0]; col[0] = col[2]; col[2] = t;
        t = col[1]; col[1] = col[3]; col[3] = t;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int n = 4 * nq + ((s + nql) & 3);
        const int off = n * RC_BK + 16 * ((kq >> 2) ^ (nq & 1)) + 4 * (kq & 3);
        const uint32_t codes = col[s];
        *reinterpret_cast<uint32_t*>(s_ex + off) = wrap ? wrapper(codes) : codes;
        const uint32_t* row0 = s_tab + (codes & 0xFFu) * G;
        const uint32_t* row1 = s_tab + ((codes >> 8) & 0xFFu) * G;
        const uint32_t* row2 = s_tab + ((codes >> 16) & 0xFFu) * G;
        const uint32_t* row3 = s_tab + (codes >> 24) * G;
        for (int g = 0; 4 * g < R; ++g) {
          uint32_t p[4];
          rc_transpose4(row0[g], row1[g], row2[g], row3[g], p);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (4 * g + q < R) {
              *reinterpret_cast<uint32_t*>(
                  s_ex + (1 + 4 * g + q) * RC_BN * RC_BK + off) = p[q];
            }
          }
        }
      }
    }
    __syncthreads();

    // -- the R + 1 GEMMs of this chunk
    uint32_t araw[2][4];
    {
      const int8_t* sa = s_a + stage * RC_BM * RC_BK;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 32 * wm + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int h = lane >> 4;
        rc_ldmatrix4(araw[mt], sa + r * RC_BK + 16 * (h ^ ((r >> 2) & 1)));
      }
    }
    for (int p = 0; p <= R; ++p) {
      uint32_t af[2][4];
      if (p == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            af[mt][i] = wrap ? wrapper(araw[mt][i]) : araw[mt][i];
          }
        }
      } else {
        const uint32_t mask = s_mask[p - 1], abyte = s_abyte[p - 1];
        const uint32_t low = mask & 0x7F7F7F7Fu, top = ~(mask & 0x80808080u);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t x = araw[mt][i];
            // bit 7 of a byte of t: its code has every bit of the mask
            const uint32_t t = (0x80808080u - (~x & low)) & (x | top);
            af[mt][i] = rc_sign_bytes(t) & abyte;
          }
        }
      }
      const int8_t* ex = s_ex + p * RC_BN * RC_BK;
      uint32_t b[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = 64 * wn + 16 * np + (lane & 7) + 8 * ((lane >> 4) & 1);
        const int h = (lane >> 3) & 1;
        uint32_t r4[4];
        rc_ldmatrix4(r4, ex + n * RC_BK + 16 * (h ^ ((n >> 2) & 1)));
        b[2 * np][0] = r4[0];
        b[2 * np][1] = r4[1];
        b[2 * np + 1][0] = r4[2];
        b[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) rc_mma(acc[mt][nt], af[mt], b[nt][0], b[nt][1]);
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
      uint32_t* out = C + (static_cast<size_t>(z) * M + row) * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 64 * wn + 8 * nt + 2 * t + e;
          if (col < N) {
            const uint32_t v = static_cast<uint32_t>(acc[mt][nt][2 * h + e]) + kf;
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

template <bool VEC>
cudaError_t rows_contract_run(const int8_t* a, const int8_t* w,
                              const uint32_t* planes, uint32_t* c, int B,
                              int M, int K, int N, int n_bits, int R, int f00,
                              cudaStream_t stream) {
  // the opt-in limit is always the most any launch takes, so that
  // concurrent launches of other plane counts never see a smaller one
  cudaError_t e = cudaFuncSetAttribute(
      rows_matmul_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRcMaxSmem);
  if (e != cudaSuccess) return e;
  const int smem = rc_smem_bytes(R);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_matmul_kernel<VEC>, RC_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long m_tiles = (M + RC_BM - 1) / RC_BM;
  const long long tiles_mn = m_tiles * ((N + RC_BN - 1) / RC_BN);
  if (tiles_mn > INT_MAX) return cudaErrorInvalidValue;
  const long long tiles = tiles_mn * B;
  const long long k_chunks = (K + RC_BK - 1) / RC_BK;
  // no mma accumulator overflows: |a plane's product| <= 2^14
  const long long max_chunks =
      std::max(1LL, (1LL << 31) / ((1LL << 14) * (R + 1)) / RC_BK);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long split = std::max(1LL, std::min(k_chunks, slots / tiles));
  const long long kb = std::min(max_chunks, (k_chunks + split - 1) / split);
  const long long grid_y = (k_chunks + kb - 1) / kb;
  if (grid_y > 65535) return cudaErrorInvalidValue;
  const int atomic = grid_y > 1 ? 1 : 0;
  if (atomic) {
    e = cudaMemsetAsync(c, 0, static_cast<size_t>(B) * M * N * sizeof(int32_t),
                        stream);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(tiles_mn),
                  static_cast<unsigned>(grid_y), static_cast<unsigned>(B));
  rows_matmul_kernel<VEC><<<grid, RC_THREADS, smem, stream>>>(
      a, w, planes, c, M, K, N, n_bits, R, static_cast<int>(kb), f00, atomic,
      static_cast<int>(m_tiles));
  return cudaGetLastError();
}

// Launches rows_matmul_kernel: a (B, M, K) int8 codes, w (B, K, N) int8
// codes, both contiguous; planes as in the header; c (B, M, N) int32 (zeroed
// here on the stream where K is split). 16-byte copies where K % 16 == 0,
// N % 16 == 0 and both operands are 16-byte aligned, else byte loads.
// cudaErrorInvalidValue or cudaErrorMisalignedAddress if the contract does
// not hold.
cudaError_t rows_contract(const int8_t* a, const int8_t* w,
                          const int32_t* planes, int32_t* c, int B, int M,
                          int K, int N, int n_bits, int R, int f00,
                          cudaStream_t stream) {
  if (B < 1 || B > 65535 || M < 1 || K < 1 || N < 1 ||
      n_bits < RC_MIN_BITS || n_bits > RC_MAX_BITS || R < 0 ||
      R > RC_MAX_PLANES) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(planes) % 4 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(planes);
  uint32_t* out = reinterpret_cast<uint32_t*>(c);
  return vec ? rows_contract_run<true>(a, w, p, out, B, M, K, N, n_bits, R,
                                       f00, stream)
             : rows_contract_run<false>(a, w, p, out, B, M, K, N, n_bits, R,
                                        f00, stream);
}

}  // namespace
