// Fused 'same' convolution under an approximate multiplier, two kinds.
//
// Replaces the TPU kernel src/repro/kernels/fused_conv/kernel.py,
// fused_conv_pallas (body _fused_kernel): for each output pixel, the exact
// int32 sum over the kh x kw window of f(x[i+di-ph, j+dj-pw], tap[di][dj]).
// Two kernels, one per product kind of the reference (fused_conv/ops.py):
//
// * fused_conv_kernel (closed_form kind): f is the wiring's closed form
//   (closed_form.cuh), evaluated generically for every pixel x tap.
// * fused_conv_lut_kernel (lut kind, ops.py _lut_tap_product): f(x, c) is a
//   read of the wiring's product table, table[((x+off)&mask) << n |
//   ((c+off)&mask)] -- the pixel is the first operand and the tap the
//   second; the CSP multipliers are not symmetric. This is the kind for
//   product models with no closed form ("exact") and for kernel="lut".
//
// Bound on the H100. The least work is bytes: the taps are fixed at launch,
// so f(x, c) is a 2^N-entry column of the table per distinct tap, and a
// pixel then costs one table read per tap and kh*kw-1 adds against 4 bytes
// read and 4 written. The closed-form kind is far from that floor: it
// evaluates kh*kw generic products per output pixel (on the order of a
// hundred integer operations each), so INT32 ALU throughput bounds it. One
// thread per output pixel, grid (W-tiles, H-tiles, B), taps and the
// closed-form block passed by value (constant bank), image reads through L1
// with bounds checks instead of a padded copy.
//
// The lut kind reads exactly those columns. The wrapper keeps them on the
// card (one 2^N-entry int16 column per distinct tap value, built once per
// wiring, taps and device; products wrap to 2N <= 16 bits, so int16 is
// lossless) and passes each tap's column slot by value. A block stages the
// columns in shared memory (at most 2^N columns of 2^N entries: 128 KiB at
// N = 8, above the 48 KiB default, hence cudaFuncSetAttribute), then each
// thread computes LUT_ROWS output rows of one column, so the staging is
// amortised over a 32 x 32 tile.
//
// A tap that lands outside the image reads 0 and still multiplies it
// (closed form) or looks it up (lut): f(0, c) != 0 because the compensation
// constant fires on zero operands, and the JAX kernel (which zero-pads)
// counts that term too.

#include <cuda_runtime.h>

#include <cstring>

#include "closed_form.cuh"

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

// x, out: contiguous (B, H, W) int32 on the card. taps: kh*kw host int32,
// row-major. params: CF_PARAM_LEN host int32. Returns cudaGetLastError().
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

// x, out: contiguous (B, H, W) int32 on the card. slots: kh*kw host uint8,
// the column of each tap (row-major); cols: n_cols x 2^n_bits int16 on the
// card. Returns cudaGetLastError().
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
