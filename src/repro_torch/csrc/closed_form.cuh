// Device function of the CSP approximate multipliers' closed form.
//
// Replaces the per-element product that the TPU kernels inline
// (src/repro/kernels/closed_form.py, make_closed_form): one function reads a
// flat int32 parameter block (repro_torch.kernels.closed_form.
// closed_form_params, layout in that module's docstring), so one compiled
// kernel serves every wiring x width. Its plain twin, loop for loop, is
// closed_form_from_params in the same module; the CPU tests hold that twin
// against the JAX generator exhaustively.
//
// Cost: a generic product is on the order of a hundred integer operations
// (truncation loop, conversion term, compare-select error sums) read from
// the block, and tensor cores cannot evaluate it. Where the coefficient is
// fixed for a launch, the kernels tabulate it instead: cf_columns_kernel
// below writes 2^n products per coefficient into a column, and the
// served designs read one column entry per product from shared memory
// (approx_matmul.cu's narrow design through narrow_contract.cuh,
// fused_conv.cu's stencil design), and cf_table_kernel writes the whole
// 2^(2n)-entry product table once per wiring for approx_matmul.cu's decode
// design (decode_contract.cuh). At widths 9..16 approx_matmul.cu's wide
// design (wide_contract.cuh) runs the closed form's byte planes, taken apart
// on the host from this block, on the INT8 tensor cores instead, and
// fused_conv.cu's tiled design (conv_tiles.cuh) reads int32 columns of it
// (widths 9..16) or byte tables split from them. Only fused_conv's generic
// kernel and approx_matmul's tile design, which no path launches since the
// tiled and wide designs, still evaluate it once per product. All
// arithmetic is on uint32 so that the int32 ring's wraparound is defined in
// C++; signed values come back through the shift-based width wrap.
//
// Both approx_matmul.cu and fused_conv.cu include this header, each into
// its own library: the kernel below has internal linkage, so nothing of it
// is unified across the two when both are loaded into one process.
#pragma once

#include <cstdint>

#define CF_MAX_TAPS 3
#define CF_MAX_TERMS 8
#define CF_SLOT_LEN (4 + 2 * CF_MAX_TAPS + 1 + 2 * CF_MAX_TERMS)
#define CF_PARAM_LEN (2 + 3 * CF_SLOT_LEN)

// Passed to the kernels by value, so the block lives in the constant bank.
struct CFParams {
  int32_t p[CF_PARAM_LEN];
};

// Low `bits` of x, sign-extended (wrap_to_width); identity at 32 bits.
__device__ __forceinline__ int32_t cf_wrap(uint32_t x, int bits) {
  if (bits >= 32) return static_cast<int32_t>(x);
  return static_cast<int32_t>(x << (32 - bits)) >> (32 - bits);
}

__device__ __forceinline__ int32_t cf_product(int32_t a_in, int32_t b_in,
                                              const CFParams& P) {
  const int n = P.p[0];
  const int32_t a = cf_wrap(static_cast<uint32_t>(a_in), n);
  const int32_t b = cf_wrap(static_cast<uint32_t>(b_in), n);
  uint32_t raw = static_cast<uint32_t>(a) * static_cast<uint32_t>(b) +
                 static_cast<uint32_t>(P.p[1]);
  // truncated LSP columns via the (n-1)-term masked-operand identity
  for (int i = 0; i < n - 1; ++i) {
    raw -= static_cast<uint32_t>((a >> i) & 1) *
           (static_cast<uint32_t>(b & ((1 << (n - 1 - i)) - 1)) << i);
  }
  // NAND->1 conversion of not(a_{n-1} b_0)
  raw += static_cast<uint32_t>(((a >> (n - 1)) & 1) & (b & 1)) << (n - 1);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int32_t* q = P.p + 2 + s * CF_SLOT_LEN;
    const int n_terms = q[0];
    if (n_terms == 0) continue;  // exact compressor: no error term
    int pos = q[1] - 1;          // bit position of the next input, A = MSB
    int idx = 0;
    if (q[2] >= 0) {
      idx |= (1 - (((a >> q[2]) & 1) & ((b >> (n - 1)) & 1))) << pos;
      --pos;
    }
    for (int t = 0; t < q[3]; ++t) {
      idx |= (((a >> q[4 + 2 * t]) & 1) & ((b >> q[5 + 2 * t]) & 1)) << pos;
      --pos;
    }
    int32_t err = 0;
    for (int t = 0; t < n_terms; ++t) {
      err += (idx == q[5 + 2 * CF_MAX_TAPS + 2 * t])
                 ? q[6 + 2 * CF_MAX_TAPS + 2 * t] : 0;
    }
    raw += static_cast<uint32_t>(err) << q[4 + 2 * CF_MAX_TAPS];
  }
  return cf_wrap(raw, 2 * n);
}

namespace {

// col[e] = f(x - 2^(n-1), b[e >> n]) with x = e & (2^n - 1): one column of
// 2^n products per coefficient b[k], int16 to width 8 (the products wrap to
// 2n <= 16 bits, so int16 is lossless) and int32 at widths 9..16. A column
// indexed by (a + 2^(n-1)) & (2^n - 1) equals f(a, b[k]) for every int32
// a, since cf_product wraps its first operand to n bits before anything
// else.
template <typename T>
__global__ void cf_columns_kernel(const int32_t* __restrict__ b,
                                  T* __restrict__ cols, long long n_entries,
                                  const CFParams cf) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n_entries) return;
  const int n = cf.p[0];
  const int32_t x = static_cast<int32_t>(e & ((1 << n) - 1)) - (1 << (n - 1));
  cols[e] = static_cast<T>(cf_product(x, b[e >> n], cf));
}

// table[e] = f(xa - 2^(n-1), xb - 2^(n-1)) with xa = e >> n, xb = e & (2^n - 1):
// the decode design's int16 product table (n <= 8), row-major in the first
// operand as core.lut.flat_lut lays it out.
__global__ void cf_table_kernel(int16_t* __restrict__ table,
                                const CFParams cf) {
  const int n = cf.p[0];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (1 << (2 * n))) return;
  const int off = 1 << (n - 1);
  table[e] = static_cast<int16_t>(
      cf_product((e >> n) - off, (e & ((1 << n) - 1)) - off, cf));
}

}  // namespace
