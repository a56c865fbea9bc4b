// Fused 'same' convolution under an approximate multiplier: two designs,
// each in two product kinds.
//
// Replaces the TPU kernel src/repro/kernels/fused_conv/kernel.py,
// fused_conv_pallas (body _fused_kernel): for each output pixel, the exact
// int32 sum over the kh x kw window of f(x[i+di-ph, j+dj-pw], tap[di][dj]).
// The product kinds are those of the reference (fused_conv/ops.py): the
// closed_form kind's f is the wiring's closed form (closed_form.cuh); the
// lut kind's f is a read of the wiring's product table, table[((x+off)&mask)
// << n | ((c+off)&mask)] -- the pixel is the first operand and the tap the
// second, since the CSP multipliers are not symmetric. The lut kind serves
// product models with no closed form ("exact") and kernel="lut".
//
// Bound on the H100: bytes, 4 read and 4 written per pixel. The taps are
// fixed at launch, and both kinds wrap the pixel operand to n bits before
// anything else, so f(., c) is a column of 2^n entries per distinct tap,
// indexed by (x + 2^(n-1)) & (2^n - 1) for every int32 x; a pixel then
// costs a few column reads and adds. The wrapper (kernels/fused_conv/ops.py)
// picks the design from the width, the kernel size and the distinct taps
// (stencil_design):
//
// * stencil (width <= 8, kh and kw <= 5; every served conv, both kinds):
//   fused_conv_stencil_kernel<KH, KW> reads D int16 columns, one per
//   distinct wrapped tap (the products wrap to 2n <= 16 bits, so int16 is
//   lossless; a tap c and its n-bit wrap give the same products, which the
//   CPU tests check for both kinds). The wrapper builds them once per (key,
//   taps, device) and keeps them on the card: the closed-form kind with
//   cf_columns_kernel (closed_form.cuh, 2^n closed-form products per column),
//   the lut kind from the table. A block stages them in shared memory (at
//   most 25 x 2^8 x 2 B = 12.5 KiB) and covers 32 * ST_V output columns x
//   ST_TY strips of ST_ROWS rows of one image. A thread owns ST_V = 8
//   consecutive outputs along W and walks down its strip: each input row is
//   loaded once (two 16-byte loads of its 8 centre pixels, kw - 1
//   bounds-checked halo loads; the loads of the next ST_AHEAD - 1 rows are
//   in flight meanwhile), gathered once per distinct column for its
//   8 + kw - 1 pixels, and added into the kh output rows it feeds, held in a
//   rolling window of kh x 8 sums; the oldest row is then complete and
//   stored with two 16-byte stores. A 3x3 Laplacian (D = 2) so costs
//   2 x 10 / 8 = 2.5 shared-memory gathers per output instead of 9
//   products. Which tap reads which column is a bit mask per column, and
//   the adds are predicated on it: D x kh x kw x 8 per input row, the price
//   of taking the taps as a launch argument. That integer work, not the
//   gathers, is what holds the kernel from its bound: its time does not
//   move with the pixel data (bank conflicts), and grows with D. ST_V,
//   ST_ROWS, ST_TY and ST_AHEAD are the fastest of the shapes that
//   tools/fused_conv_sweep.py measures on the card (4 outputs a thread
//   take 17% longer). Rows and columns outside the image read 0 and are
//   still looked up: f(0, c) != 0, since the compensation constant fires on
//   zero operands (the JAX kernel, which zero-pads, counts that term too).
//   Ragged W (W % 4 != 0) or an unaligned base takes scalar loads and
//   stores in the same kernel.
// * generic (the closed form at widths 9..16, kernels beyond 5 x 5):
//   fused_conv_kernel evaluates the closed form for every pixel x tap, one
//   thread per output pixel (on the order of a hundred integer operations
//   per product, so INT32 ALU throughput bounds it), and
//   fused_conv_lut_kernel stages one int16 column per distinct tap and reads
//   one per tap, LUT_ROWS output rows per thread, with scalar loads through
//   L1 and a bounds check on each. Both take the taps by value (constant
//   bank) and read out-of-image pixels as 0, as above.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "closed_form.cuh"

// -- the generic design -------------------------------------------------------

#define FC_MAX_TAPS 256

struct ConvTaps {
  int32_t kh, kw;
  int32_t v[FC_MAX_TAPS];
};

__global__ void fused_conv_kernel(const int32_t* __restrict__ x,
                                  int32_t* __restrict__ out, int H, int W,
                                  const ConvTaps taps, const CFParams cf) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const int ph = taps.kh / 2, pw = taps.kw / 2;
  const int32_t* img = x + static_cast<size_t>(blockIdx.z) * H * W;
  uint32_t acc = 0;  // int32 ring: unsigned wraparound is defined
  for (int di = 0; di < taps.kh; ++di) {
    const int r = i + di - ph;
    const bool row_in = r >= 0 && r < H;
    for (int dj = 0; dj < taps.kw; ++dj) {
      const int c = j + dj - pw;
      const int32_t v =
          (row_in && c >= 0 && c < W) ? img[static_cast<size_t>(r) * W + c] : 0;
      acc += static_cast<uint32_t>(cf_product(v, taps.v[di * taps.kw + dj], cf));
    }
  }
  out[(static_cast<size_t>(blockIdx.z) * H + i) * W + j] =
      static_cast<int32_t>(acc);
}

#define LUT_ROWS 4  // output rows per thread of the lut kind

struct LutTaps {
  int32_t kh, kw, n_bits, n_cols;
  uint8_t slot[FC_MAX_TAPS];  // column of each tap, row-major
};

__global__ void fused_conv_lut_kernel(const int32_t* __restrict__ x,
                                      int32_t* __restrict__ out, int H, int W,
                                      const int16_t* __restrict__ cols,
                                      const LutTaps taps) {
  extern __shared__ int16_t scol[];  // n_cols x 2^n_bits
  const int n_bits = taps.n_bits;
  const int n_entries = taps.n_cols << n_bits;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < n_entries; e += blockDim.x * blockDim.y) {
    scol[e] = cols[e];
  }
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W) return;
  const int ph = taps.kh / 2, pw = taps.kw / 2;
  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;
  const int32_t* img = x + static_cast<size_t>(blockIdx.z) * H * W;
  for (int r = 0; r < LUT_ROWS; ++r) {
    const int i = (blockIdx.y * LUT_ROWS + r) * blockDim.y + threadIdx.y;
    if (i >= H) return;
    uint32_t acc = 0;  // int32 ring: unsigned wraparound is defined
    for (int di = 0; di < taps.kh; ++di) {
      const int rr = i + di - ph;
      const bool row_in = rr >= 0 && rr < H;
      for (int dj = 0; dj < taps.kw; ++dj) {
        const int c = j + dj - pw;
        const int32_t v = (row_in && c >= 0 && c < W)
            ? img[static_cast<size_t>(rr) * W + c] : 0;
        const uint32_t xi = (static_cast<uint32_t>(v) + off) & mask;
        const int t = di * taps.kw + dj;
        acc += static_cast<uint32_t>(
            static_cast<int32_t>(scol[(taps.slot[t] << n_bits) | xi]));
      }
    }
    out[(static_cast<size_t>(blockIdx.z) * H + i) * W + j] =
        static_cast<int32_t>(acc);
  }
}

// -- the stencil design -------------------------------------------------------

// ST_V, ST_TY, ST_ROWS, ST_AHEAD: -D overrides for tools/fused_conv_sweep.py
#ifndef ST_V
#define ST_V 8        // consecutive outputs of a thread along W (4 or 8)
#endif
#define ST_TX 32      // threads of a block along W: 32 * ST_V output columns
#ifndef ST_TY
#define ST_TY 2       // row strips of a block, one warp each
#endif
#ifndef ST_ROWS
#define ST_ROWS 32    // output rows of a strip
#endif
#ifndef ST_AHEAD
#define ST_AHEAD 2    // input rows a thread has loaded or in flight
#endif
#define ST_MAX_K 5    // kh, kw <= 5 (stencil_design in kernels/fused_conv/ops.py)
#define ST_MAX_BITS 8

struct StencilTaps {
  int32_t n_bits, n_cols;
  uint32_t mask[ST_MAX_K * ST_MAX_K];  // bit di*kw+dj: tap (di, dj) reads column d
};

// Row r's pixels at columns j0 - KW/2 + p, p < ST_V + KW - 1; 0 outside
// the image. vec: W % 4 == 0 and a 16-byte aligned base, so the ST_V centre
// pixels are ST_V / 4 16-byte loads.
template <int KW>
__device__ __forceinline__ void st_load_row(const int32_t* __restrict__ img,
                                            int r, int H, int W, int j0,
                                            bool vec,
                                            int32_t (&v)[ST_V + KW - 1]) {
  constexpr int P = ST_V + KW - 1, PW = KW / 2;
  if (r < 0 || r >= H) {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = 0;
    return;
  }
  const int32_t* row = img + static_cast<size_t>(r) * W;
  if (vec) {
#pragma unroll
    for (int q = 0; q < ST_V; q += 4) {  // W % 4 == 0: a chunk is in or out
      const int4 c = j0 + q < W
          ? __ldg(reinterpret_cast<const int4*>(row + j0 + q))
          : make_int4(0, 0, 0, 0);
      v[PW + q] = c.x;
      v[PW + q + 1] = c.y;
      v[PW + q + 2] = c.z;
      v[PW + q + 3] = c.w;
    }
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      const int j = j0 - PW + p;
      v[p] = j >= 0 ? __ldg(row + j) : 0;
    }
#pragma unroll
    for (int p = PW + ST_V; p < P; ++p) {
      const int j = j0 - PW + p;
      v[p] = j < W ? __ldg(row + j) : 0;
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = j0 - PW + p;
      v[p] = (j >= 0 && j < W) ? __ldg(row + j) : 0;
    }
  }
}

template <int KH, int KW>
__global__ void __launch_bounds__(ST_TX * ST_TY)
    fused_conv_stencil_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ out, int H, int W,
                              const int16_t* __restrict__ cols,
                              const StencilTaps taps, int vec) {
  constexpr int P = ST_V + KW - 1;  // input columns a thread reads per row
  constexpr int PH = KH / 2;
  extern __shared__ int16_t st_cols[];  // n_cols x 2^n_bits
  const int n_bits = taps.n_bits;
  const int n_entries = taps.n_cols << n_bits;
  for (int e = threadIdx.y * ST_TX + threadIdx.x; e < n_entries;
       e += ST_TX * ST_TY) {
    st_cols[e] = cols[e];
  }
  __syncthreads();  // the only barrier: threads past the image may leave

  const int j0 = (blockIdx.x * ST_TX + threadIdx.x) * ST_V;
  const int o0 = (blockIdx.y * ST_TY + threadIdx.y) * ST_ROWS;
  if (j0 >= W || o0 >= H) return;
  const int o1 = min(o0 + ST_ROWS, H);
  const size_t plane = static_cast<size_t>(H) * W;
  const int32_t* img = x + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;
  const uint32_t off = 1u << (n_bits - 1), mask = (1u << n_bits) - 1;

  // acc[k]: output row r + PH - (KH - 1) + k while input row r is added;
  // int32 ring: unsigned wraparound is defined
  uint32_t acc[KH][ST_V];
#pragma unroll
  for (int k = 0; k < KH; ++k) {
#pragma unroll
    for (int v = 0; v < ST_V; ++v) acc[k][v] = 0u;
  }
  const int r_last = o1 - 1 + (KH - 1 - PH);
  int32_t win[ST_AHEAD][P];  // rows r .. r + ST_AHEAD - 1, loads in flight
#pragma unroll
  for (int a = 0; a < ST_AHEAD; ++a) {
    if (o0 - PH + a <= r_last) {
      st_load_row<KW>(img, o0 - PH + a, H, W, j0, vec, win[a]);
    }
  }
  for (int r = o0 - PH; r <= r_last; ++r) {
    const bool more = r + ST_AHEAD <= r_last;
    int32_t nxt[P];
    if (more) st_load_row<KW>(img, r + ST_AHEAD, H, W, j0, vec, nxt);
    uint32_t idx[P];  // (x + 2^(n-1)) & (2^n - 1), as an xor
#pragma unroll
    for (int p = 0; p < P; ++p) {
      idx[p] = (static_cast<uint32_t>(win[0][p]) ^ off) & mask;
    }
    for (int d = 0; d < taps.n_cols; ++d) {
      const int16_t* col = st_cols + (d << n_bits);
      const uint32_t m = taps.mask[d];
      uint32_t g[P];  // this row's product map for column d
#pragma unroll
      for (int p = 0; p < P; ++p) {
        g[p] = static_cast<uint32_t>(static_cast<int32_t>(col[idx[p]]));
      }
#pragma unroll
      for (int di = 0; di < KH; ++di) {
#pragma unroll
        for (int dj = 0; dj < KW; ++dj) {
          if ((m >> (di * KW + dj)) & 1u) {
#pragma unroll
            for (int v = 0; v < ST_V; ++v) acc[KH - 1 - di][v] += g[v + dj];
          }
        }
      }
    }
    const int o = r + PH - (KH - 1);  // the output row that row r completes
    if (o >= o0) {
      int32_t* orow = dst + static_cast<size_t>(o) * W;
      if (vec) {
#pragma unroll
        for (int q = 0; q < ST_V; q += 4) {
          if (j0 + q >= W) break;
          *reinterpret_cast<int4*>(orow + j0 + q) = make_int4(
              static_cast<int32_t>(acc[0][q]),
              static_cast<int32_t>(acc[0][q + 1]),
              static_cast<int32_t>(acc[0][q + 2]),
              static_cast<int32_t>(acc[0][q + 3]));
        }
      } else {
#pragma unroll
        for (int v = 0; v < ST_V; ++v) {
          if (j0 + v < W) orow[j0 + v] = static_cast<int32_t>(acc[0][v]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k + 1 < KH; ++k) {
#pragma unroll
      for (int v = 0; v < ST_V; ++v) acc[k][v] = acc[k + 1][v];
    }
#pragma unroll
    for (int v = 0; v < ST_V; ++v) acc[KH - 1][v] = 0u;
#pragma unroll
    for (int a = 0; a + 1 < ST_AHEAD; ++a) {
#pragma unroll
      for (int p = 0; p < P; ++p) win[a][p] = win[a + 1][p];
    }
    if (more) {
#pragma unroll
      for (int p = 0; p < P; ++p) win[ST_AHEAD - 1][p] = nxt[p];
    }
  }
}

template <int KH, int KW>
cudaError_t stencil_run(const int32_t* x, int32_t* out, int B, int H, int W,
                        const int16_t* cols, const StencilTaps& t, int vec,
                        cudaStream_t stream) {
  // raised on every launch, to the most any launch of this kernel takes, so
  // that concurrent launches never see a smaller limit
  const cudaError_t e = cudaFuncSetAttribute(
      fused_conv_stencil_kernel<KH, KW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(int16_t) * (KH * KW) << ST_MAX_BITS));
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(int16_t) * (static_cast<size_t>(t.n_cols) << t.n_bits);
  const dim3 block(ST_TX, ST_TY);
  const dim3 grid((W + ST_TX * ST_V - 1) / (ST_TX * ST_V),
                  (H + ST_TY * ST_ROWS - 1) / (ST_TY * ST_ROWS), B);
  fused_conv_stencil_kernel<KH, KW><<<grid, block, smem, stream>>>(
      x, out, H, W, cols, t, vec);
  return cudaGetLastError();
}

// The generic design, closed-form kind. x, out: contiguous (B, H, W) int32
// on the card. taps: kh*kw host int32, row-major. params: CF_PARAM_LEN host
// int32. Returns cudaGetLastError().
extern "C" int fused_conv2d_launch(const void* x, void* out, int B, int H,
                                   int W, const void* taps, int kh, int kw,
                                   const void* params, void* stream) {
  if (kh < 1 || kw < 1 || kh * kw > FC_MAX_TAPS || B < 1 || B > 65535 ||
      H < 1 || W < 1 || (H + 7) / 8 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvTaps t;
  t.kh = kh;
  t.kw = kw;
  std::memcpy(t.v, taps, sizeof(int32_t) * kh * kw);
  CFParams cf;
  std::memcpy(cf.p, params, sizeof(cf.p));
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  fused_conv_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), H, W, t, cf);
  return static_cast<int>(cudaGetLastError());
}

// The generic design, lut kind. x, out: contiguous (B, H, W) int32 on the
// card. slots: kh*kw host uint8, the column of each tap (row-major); cols:
// n_cols x 2^n_bits int16 on the card. Returns cudaGetLastError().
extern "C" int fused_conv2d_lut_launch(const void* x, void* out, int B, int H,
                                       int W, const void* slots, int kh,
                                       int kw, const void* cols, int n_cols,
                                       int n_bits, void* stream) {
  if (kh < 1 || kw < 1 || kh * kw > FC_MAX_TAPS || B < 1 || B > 65535 ||
      H < 1 || W < 1 || n_bits < 1 || n_bits > 8 || n_cols < 1 ||
      n_cols > (1 << n_bits) || (H + 8 * LUT_ROWS - 1) / (8 * LUT_ROWS) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LutTaps t;
  t.kh = kh;
  t.kw = kw;
  t.n_bits = n_bits;
  t.n_cols = n_cols;
  std::memcpy(t.slot, slots, kh * kw);
  const size_t smem = sizeof(int16_t) * (static_cast<size_t>(n_cols) << n_bits);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_conv_lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 8 * LUT_ROWS - 1) / (8 * LUT_ROWS), B);
  fused_conv_lut_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), H, W,
      static_cast<const int16_t*>(cols), t);
  return static_cast<int>(cudaGetLastError());
}

// The stencil design, both kinds. x, out: contiguous (B, H, W) int32 on the
// card. slots: kh*kw host uint8, the column of each tap (row-major); cols:
// n_cols x 2^n_bits int16 on the card (fused_conv2d_columns_launch for the
// closed-form kind, the table's columns for the lut kind). Takes the 16-byte
// path where W % 4 == 0 and x and out are 16-byte aligned, else scalar
// loads and stores. Returns cudaGetLastError().
extern "C" int fused_conv2d_stencil_launch(const void* x, void* out, int B,
                                           int H, int W, const void* slots,
                                           int kh, int kw, const void* cols,
                                           int n_cols, int n_bits,
                                           void* stream) {
  if (kh < 1 || kw < 1 || kh > ST_MAX_K || kw > ST_MAX_K || B < 1 ||
      B > 65535 || H < 1 || W < 1 || n_bits < 1 || n_bits > ST_MAX_BITS ||
      n_cols < 1 || n_cols > kh * kw ||
      (H + ST_TY * ST_ROWS - 1) / (ST_TY * ST_ROWS) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StencilTaps t;
  std::memset(&t, 0, sizeof(t));
  t.n_bits = n_bits;
  t.n_cols = n_cols;
  const uint8_t* s = static_cast<const uint8_t*>(slots);
  for (int i = 0; i < kh * kw; ++i) {
    if (s[i] >= n_cols) return static_cast<int>(cudaErrorInvalidValue);
    t.mask[s[i]] |= 1u << i;
  }
  const int vec = W % ST_V == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  const int16_t* c = static_cast<const int16_t*>(cols);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kh * 8 + kw) {
#define ST_CASE(a, b) \
  case a * 8 + b:     \
    return static_cast<int>(stencil_run<a, b>(xi, o, B, H, W, c, t, vec, st));
#define ST_ROW(a) ST_CASE(a, 1) ST_CASE(a, 2) ST_CASE(a, 3) ST_CASE(a, 4) ST_CASE(a, 5)
    ST_ROW(1) ST_ROW(2) ST_ROW(3) ST_ROW(4) ST_ROW(5)
#undef ST_ROW
#undef ST_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The closed-form kind's columns: cols[d][x] = f(x - 2^(n-1), coeffs[d]),
// n_cols x 2^n int16 on the card, written here. coeffs: n_cols int32 on the
// card; params: CF_PARAM_LEN host int32 (its width n <= 8). Returns
// cudaGetLastError().
extern "C" int fused_conv2d_columns_launch(const void* coeffs, void* cols,
                                           int n_cols, const void* params,
                                           void* stream) {
  CFParams cf;
  std::memcpy(cf.p, params, sizeof(cf.p));
  const int n = cf.p[0];
  if (n < 1 || n > ST_MAX_BITS || n_cols < 1 || n_cols > (1 << n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_entries = static_cast<long long>(n_cols) << n;
  cf_columns_kernel<<<static_cast<unsigned>((n_entries + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<int16_t*>(cols),
      n_entries, cf);
  return static_cast<int>(cudaGetLastError());
}
