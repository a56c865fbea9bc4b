// The fused conv's tiled design: every conv the stencil design refuses (the
// closed form at widths 9..16, kernels beyond 5 x 5 in either product kind),
// up to 16 x 16 taps at any width to 16.
//
// Replaces, with the stencil design (fused_conv.cu), the TPU kernel
// src/repro/kernels/fused_conv/kernel.py, fused_conv_pallas (body
// _fused_kernel): products of the staged pixels per distinct tap, then
// shifted adds in the int32 ring.
//
// Product data (the wrapper builds it once per key, kind, taps and device,
// kernels/fused_conv/ops.py tiled_products): both kinds wrap the pixel to
// n bits first, so f(., c) for a tap c fixed at launch is a function of the
// column index u = (x + 2^(n-1)) & (2^n - 1) alone. Five sources:
//   TL_COL16   int16 columns, 2^n entries per distinct tap (n <= 8, both
//              kinds: fused_conv_columns), in shared memory;
//   TL_COL32   int32 columns (n = 9..16, the closed form, evaluated on the
//              card by cf_columns_kernel), in shared memory where
//              D x 2^n x 4 B fits;
//   TL_COL32_G the same read from global memory through L1 / L2;
//   TL_BYTES   int32 byte tables, 256 + 2^(n-8) entries per distinct tap:
//              f(u, c) = lo[u & 255] + hi[u >> 8]. The closed form is
//              additive over the low and high byte of its pixel operand for
//              every wiring (a.c splits by byte, the truncation and the
//              conversion term are linear in a's bits, and no bit-monomial
//              pair of the error terms has a-bits in both bytes:
//              monomials.wide_planes), so the split is exact; the wrapper
//              checks it on every column entry when it builds the tables.
//              In shared memory: 2 KiB per tap at n = 16;
//   TL_BYTES_G the same read from global memory.
// In shared memory every table keeps one spare entry after each 32, so that
// pixels whose low bits are 0 (to_signed_pixels at widths above 8 shifts
// them left) spread over the 32 banks instead of hitting a few.
//
// Blocks are persistent (one wave) and walk output tiles of TL_TH x TL_TW
// pixels of one image. Each tile's input rows and halo (TL_TH + kh - 1 rows,
// TL_TW + kw - 1 columns, rows and columns outside the image as 0) land in
// one of two shared-memory buffers by cp.async, 16-byte copies where W % 4
// == 0 and the base is aligned (with a zero fill past the image), 4-byte
// copies otherwise; the next tile's copies are in flight while a tile is
// computed. A thread owns TL_R consecutive output rows of one column (a
// warp: 32 adjacent columns, so its shared-memory reads of pixels are
// conflict-free). For each kernel column dj and each chunk of up to DC
// kernel rows (DC = kh to 8 rows, else 8) it reads the TL_R + DC - 1 pixels
// of its column once, and forms each pixel's product once per run of equal
// taps down the kernel column, adding it into the TL_R row sums it feeds
// (uint32: the int32 ring). A 3x3 Laplacian (columns -1/-1/-1, -1/8/-1,
// -1/-1/-1) so costs about 5.3 product reads and 3.4 pixel reads of shared
// memory per output, against 9 products per output. The taps travel by
// value (constant bank) as a column index per tap plus the runs. TL_TW and
// TL_R are the fastest of the tile shapes tools/fused_conv_sweep.py
// measures (-D overrides), on photo-like frames and on uniform codes.
//
// Bound: bytes, 4 read and 4 written per pixel, while the products per
// output stay few; with many distinct taps (a 7 x 7 kernel of 49 taps),
// shared-memory reads, one product a tap an output: the table_ops term of
// chip_smoke.py's bound counts one operation per entry and per product.
// Shared-memory bank conflicts of the product reads grow with the spread of
// the pixel values.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#ifndef TL_TW
#define TL_TW 128      // output columns of a tile, one per thread of a row group
#endif
#ifndef TL_R
#define TL_R 16        // consecutive output rows of a thread
#endif
#define TL_THREADS 256
#define TL_TH (TL_THREADS / TL_TW * TL_R)  // output rows of a tile
#define TL_MAX_K 16
#define TL_MAX_DC 8    // kernel rows of a chunk
// shared row pitch of a staged tile in int32: the tile's columns, the
// widest halo and up to 3 leading columns of a 16-byte chunk, in chunks
#define TL_PITCH (((TL_TW + TL_MAX_K - 1 + 3 + 3) / 4) * 4)

enum { TL_COL16 = 0, TL_COL32 = 1, TL_COL32_G = 2, TL_BYTES = 3, TL_BYTES_G = 4 };

struct TiledTaps {
  int32_t kh, kw, n_bits, n_cols;
  int32_t stride;                      // entries of one tap's product data
  uint32_t run[TL_MAX_K];              // bit di: tap (di, dj) reads the column of (di - 1, dj)
  uint8_t slot[TL_MAX_K * TL_MAX_K];   // column of tap (di, dj), row-major
};

__host__ __device__ constexpr bool tl_in_smem(int src) {
  return src == TL_COL16 || src == TL_COL32 || src == TL_BYTES;
}

__host__ __device__ constexpr int tl_elem_bytes(int src) {
  return src == TL_COL16 ? 2 : 4;
}

// Entries of a table of e entries in shared memory: one spare after each 32.
__host__ __device__ constexpr int tl_padded(int e) { return e + (e >> 5); }

// Shared-memory entries of one tap's product data (its stride padded).
__host__ __device__ constexpr int tl_smem_stride(int src, int stride) {
  return src == TL_BYTES ? tl_padded(256) + tl_padded(stride - 256)
                         : tl_padded(stride);
}

namespace {

__device__ __forceinline__ void tl_cp_async(void* smem, const void* gmem,
                                            int bytes, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void tl_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void tl_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The product at column index u of the tap whose data starts o entries
// into the product data p (padded in shared memory, plain in global).
template <int SRC>
__device__ __forceinline__ uint32_t tl_product(const void* p, uint32_t o,
                                               uint32_t u) {
  if constexpr (SRC == TL_COL16) {
    return static_cast<uint32_t>(static_cast<int32_t>(
        static_cast<const int16_t*>(p)[o + u + (u >> 5)]));
  } else if constexpr (SRC == TL_COL32) {
    return static_cast<const uint32_t*>(p)[o + u + (u >> 5)];
  } else if constexpr (SRC == TL_COL32_G) {
    return __ldg(static_cast<const uint32_t*>(p) + o + u);
  } else if constexpr (SRC == TL_BYTES) {
    const uint32_t* t = static_cast<const uint32_t*>(p) + o;
    const uint32_t lo = u & 255u, hi = u >> 8;
    return t[lo + (lo >> 5)] + t[tl_padded(256) + hi + (hi >> 5)];
  } else {
    const uint32_t* t = static_cast<const uint32_t*>(p) + o;
    return __ldg(t + (u & 255u)) + __ldg(t + 256 + (u >> 8));
  }
}

// Start the copies of one tile's input (mh rows from r_top, columns from
// cs, chunks of 16 or 4 bytes) into buf; zero past the image.
__device__ __forceinline__ void tl_stage(const int32_t* __restrict__ img,
                                         int32_t* buf, int H, int W, int mh,
                                         int r_top, int cs, int n_words,
                                         bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int step = vec ? 4 : 1;
  for (int i = warp; i < mh; i += TL_THREADS / 32) {
    const int r = r_top + i;
    const bool row_in = r >= 0 && r < H;
    for (int q = lane * step; q < n_words; q += 32 * step) {
      const int g = cs + q;  // vec: W % 4 == 0, so a chunk is in or out
      const bool in = row_in && g >= 0 && g < W;
      tl_cp_async(buf + i * TL_PITCH + q,
                  in ? img + static_cast<size_t>(r) * W + g : img, 4 * step,
                  in ? 4 * step : 0);
    }
  }
}

// Add the products of kernel rows d0 .. d0 + nd - 1 of kernel column dj
// into a thread's TL_R row sums: the TL_R + nd - 1 pixels of its column
// (buf: its first staged row and column), each product formed once per run
// of equal taps down the kernel column.
template <int DC, int SRC>
__device__ __forceinline__ void tl_chunk(uint32_t (&acc)[TL_R],
                                         const int32_t* buf, const void* pdata,
                                         const TiledTaps& taps, int sstride,
                                         uint32_t off, uint32_t mask, int dj,
                                         int d0, int nd) {
  uint32_t o[DC];  // where the product data of tap (d0 + di, dj) starts
#pragma unroll
  for (int di = 0; di < DC; ++di) {
    o[di] = di < nd ? static_cast<uint32_t>(taps.slot[(d0 + di) * taps.kw + dj]) *
                          sstride : 0u;
  }
  const uint32_t run = taps.run[dj] >> d0;
  const int32_t* col = buf + d0 * TL_PITCH + dj;
#pragma unroll
  for (int p = 0; p < TL_R + DC - 1; ++p) {  // pixel row d0 + p of the column
    if (p < TL_R - 1 + nd) {  // later rows feed only the kernel's past rows
      const uint32_t u = (static_cast<uint32_t>(col[p * TL_PITCH]) ^ off) & mask;
      uint32_t g = 0u;
#pragma unroll
      for (int di = 0; di < DC; ++di) {
        const int k = p - di;  // the output row that tap row d0 + di feeds
        if (k < 0 || k >= TL_R || di >= nd) continue;
        // the first tap row feeding a row sum from this pixel forms its
        // product; the next reuses it while the taps' column is the same
        if (di == 0 || k == TL_R - 1 || !((run >> di) & 1u)) {
          g = tl_product<SRC>(pdata, o[di], u);
        }
        acc[k] += g;
      }
    }
  }
}

template <int DC, int SRC>
__global__ void __launch_bounds__(TL_THREADS)
    fused_conv_tiled_kernel(const int32_t* __restrict__ x,
                            int32_t* __restrict__ out, int B, int H, int W,
                            const void* __restrict__ prod,
                            const TiledTaps taps, int vec) {
  extern __shared__ __align__(16) unsigned char tl_smem[];
  const int kh = taps.kh, kw = taps.kw, n_bits = taps.n_bits;
  const int mh = TL_TH + kh - 1;  // staged rows of a tile
  const int sstride = tl_in_smem(SRC) ? tl_smem_stride(SRC, taps.stride)
                                      : taps.stride;
  const int prod_bytes = tl_in_smem(SRC)
      ? ((taps.n_cols * sstride * tl_elem_bytes(SRC) + 15) & ~15) : 0;
  int32_t* bufs = reinterpret_cast<int32_t*>(tl_smem + prod_bytes);
  const void* pdata = tl_in_smem(SRC) ? static_cast<const void*>(tl_smem) : prod;
  if constexpr (tl_in_smem(SRC)) {  // each table with its spare entries
    const int n = taps.n_cols * taps.stride;
    for (int e = threadIdx.x; e < n; e += TL_THREADS) {
      const int d = e / taps.stride, i = e - d * taps.stride;
      const int at = d * sstride + (SRC == TL_BYTES && i >= 256
          ? tl_padded(256) + tl_padded(i - 256) : tl_padded(i));
      if constexpr (SRC == TL_COL16) {
        reinterpret_cast<int16_t*>(tl_smem)[at] = static_cast<const int16_t*>(prod)[e];
      } else {
        reinterpret_cast<uint32_t*>(tl_smem)[at] = static_cast<const uint32_t*>(prod)[e];
      }
    }
  }

  const int tiles_x = (W + TL_TW - 1) / TL_TW;
  const int tiles_y = (H + TL_TH - 1) / TL_TH;
  const long long n_tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  const int ph = kh / 2, pw = kw / 2;
  // columns copied for a tile: from the chunk holding its first input
  // column (vec) or that column itself
  const int n_words = vec ? (((3 + TL_TW + kw - 1) + 3) & ~3) : TL_TW + kw - 1;
  auto origin = [&](long long t, int& b, int& r0, int& c0) {
    b = static_cast<int>(t / (static_cast<long long>(tiles_y) * tiles_x));
    const int rem = static_cast<int>(t - static_cast<long long>(b) * tiles_y * tiles_x);
    r0 = (rem / tiles_x) * TL_TH;
    c0 = (rem % tiles_x) * TL_TW;
  };
  auto col_start = [&](int c0) { return vec ? ((c0 - pw) & ~3) : c0 - pw; };
  const size_t plane = static_cast<size_t>(H) * W;

  long long t = blockIdx.x;
  if (t < n_tiles) {
    int b, r0, c0;
    origin(t, b, r0, c0);
    tl_stage(x + b * plane, bufs, H, W, mh, r0 - ph, col_start(c0), n_words, vec);
  }
  tl_commit();
  __syncthreads();  // the product data is in place

  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  const int c = threadIdx.x % TL_TW;
  const int k0 = (threadIdx.x / TL_TW) * TL_R;
  for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
    int b, r0, c0;
    origin(t, b, r0, c0);
    const long long t_next = t + gridDim.x;
    if (t_next < n_tiles) {  // the next tile's copies fly while this one runs
      int b1, r1, c1;
      origin(t_next, b1, r1, c1);
      tl_stage(x + b1 * plane, bufs + ((it + 1) & 1) * mh * TL_PITCH, H, W, mh,
               r1 - ph, col_start(c1), n_words, vec);
    }
    tl_commit();
    tl_wait<1>();  // this tile's group has landed
    __syncthreads();

    const int lead = (c0 - pw) - col_start(c0);
    const int32_t* buf = bufs + (it & 1) * mh * TL_PITCH + k0 * TL_PITCH + lead + c;
    uint32_t acc[TL_R];
#pragma unroll
    for (int k = 0; k < TL_R; ++k) acc[k] = 0u;
    for (int dj = 0; dj < kw; ++dj) {
      for (int d0 = 0; d0 < kh; d0 += DC) {
        const int nd = min(DC, kh - d0);  // kernel rows of this chunk
        // a whole chunk takes nd as a constant: every index into acc stays
        // static (registers); only the last chunk of a kernel beyond 8 rows
        // may be short
        if (DC < TL_MAX_DC || nd == DC) {
          tl_chunk<DC, SRC>(acc, buf, pdata, taps, sstride, off, mask, dj, d0, DC);
        } else {
          tl_chunk<DC, SRC>(acc, buf, pdata, taps, sstride, off, mask, dj, d0, nd);
        }
      }
    }
    const int j = c0 + c;
    if (j < W) {
      int32_t* dst = out + b * plane + j;
#pragma unroll
      for (int k = 0; k < TL_R; ++k) {
        const int i = r0 + k0 + k;
        if (i < H) dst[static_cast<size_t>(i) * W] = static_cast<int32_t>(acc[k]);
      }
    }
    __syncthreads();  // every read of this buffer is done before it refills
  }
  tl_wait<0>();  // no copy outlives the block
}

template <int DC, int SRC>
cudaError_t tiled_run(const int32_t* x, int32_t* out, int B, int H, int W,
                      const void* prod, const TiledTaps& t, int vec,
                      cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  const size_t prod_bytes = tl_in_smem(SRC)
      ? (static_cast<size_t>(t.n_cols) * tl_smem_stride(SRC, t.stride) *
             tl_elem_bytes(SRC) + 15) & ~static_cast<size_t>(15)
      : 0;
  const size_t smem = prod_bytes +
      2 * sizeof(int32_t) * static_cast<size_t>(TL_TH + t.kh - 1) * TL_PITCH;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  // raised on every launch to the most any launch can take, so that
  // concurrent launches never see a smaller limit
  e = cudaFuncSetAttribute(fused_conv_tiled_kernel<DC, SRC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_conv_tiled_kernel<DC, SRC>, TL_THREADS, smem);
  }
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_tiles = static_cast<long long>(B) *
      ((H + TL_TH - 1) / TL_TH) * ((W + TL_TW - 1) / TL_TW);
  const int grid = static_cast<int>(
      std::min<long long>(static_cast<long long>(sms) * per_sm, n_tiles));
  fused_conv_tiled_kernel<DC, SRC><<<grid, TL_THREADS, smem, stream>>>(
      x, out, B, H, W, prod, t, vec);
  return cudaGetLastError();
}

template <int DC>
cudaError_t tiled_by_source(int src, const int32_t* x, int32_t* out, int B,
                            int H, int W, const void* prod, const TiledTaps& t,
                            int vec, cudaStream_t stream) {
  switch (src) {
    case TL_COL16:
      return tiled_run<DC, TL_COL16>(x, out, B, H, W, prod, t, vec, stream);
    case TL_COL32:
      return tiled_run<DC, TL_COL32>(x, out, B, H, W, prod, t, vec, stream);
    case TL_COL32_G:
      return tiled_run<DC, TL_COL32_G>(x, out, B, H, W, prod, t, vec, stream);
    case TL_BYTES:
      return tiled_run<DC, TL_BYTES>(x, out, B, H, W, prod, t, vec, stream);
    case TL_BYTES_G:
      return tiled_run<DC, TL_BYTES_G>(x, out, B, H, W, prod, t, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tiled design for a runtime kh in 1..TL_MAX_K: kernel rows in one
// chunk of kh to 8 rows, else in chunks of 8.
cudaError_t tiled_contract(int src, const int32_t* x, int32_t* out, int B,
                           int H, int W, const void* prod, const TiledTaps& t,
                           int vec, cudaStream_t stream) {
  switch (std::min(t.kh, TL_MAX_DC)) {
#define TL_CASE(k) \
  case k:          \
    return tiled_by_source<k>(src, x, out, B, H, W, prod, t, vec, stream);
    TL_CASE(1) TL_CASE(2) TL_CASE(3) TL_CASE(4) TL_CASE(5) TL_CASE(6)
    TL_CASE(7) TL_CASE(8)
#undef TL_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
