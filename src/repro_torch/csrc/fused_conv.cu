// Fused 'same' convolution under the CSP approximate multiplier.
//
// Replaces the TPU kernel src/repro/kernels/fused_conv/kernel.py,
// fused_conv_pallas (body _fused_kernel): for each output pixel, the exact
// int32 sum over the kh x kw window of f(x[i+di-ph, j+dj-pw], tap[di][dj]),
// with f the wiring's closed form (closed_form.cuh).
//
// Bound on the H100. The least work is bytes: the taps are fixed at launch,
// so f(x, c) is a 2^N-entry table of x per distinct tap, and a pixel then
// costs one table read per distinct tap and kh*kw-1 adds against 4 bytes
// read and 4 written. This first design is far from that floor: it
// evaluates kh*kw generic closed-form products per output pixel (on the
// order of a hundred integer operations each), so INT32 ALU throughput
// bounds it. One thread per output pixel, grid (W-tiles, H-tiles, B), taps
// and the closed-form block passed by value (constant bank), image reads
// through L1 with bounds checks instead of a padded copy. Per-tap tables or
// product maps (2 instead of 9 products per pixel for the Laplacian) and
// shared-memory halo tiles are later work.
//
// A tap that lands outside the image reads 0 and still multiplies it:
// f(0, c) != 0 because the compensation constant fires on zero operands,
// and the JAX kernel (which zero-pads) counts that term too.

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
