// Elementwise product of the paper's proposed 8-bit approximate multiplier.
//
// Replaces the TPU kernel src/repro/kernels/approx_mul/kernel.py,
// approx_mul_pallas (body _kernel): o = approx_product_i32(a, b) for every
// element of two int32 arrays of one shape. The product is the hand-derived
// closed form (src/repro/kernels/closed_form.py, approx_product_i32), not
// the parameter-driven generic form of closed_form.cuh: the two agree on
// [-128, 127]^2 but differ outside it, and this kernel must give the hand
// form's integers on every int32 input. All arithmetic is uint32, so the
// int32 wraparound of a*b and of the sums is defined; the result is the low
// 16 bits, sign-extended.
//
// Bound on the H100. About 40 integer operations per element against 8
// bytes read and 4 written: at 16.75 TOP/s INT32 and 3.35 TB/s the bytes
// bound it (12 B x 3.35e12 B/s ~ 3.6 ns per 1000 elements vs ~2.4 ns of
// operations). This design streams the flat arrays with 16-byte vector
// loads and stores (int4, four elements a thread an iteration) in a
// grid-stride loop; a tail of fewer than four elements, or arrays not
// aligned to 16 bytes, go through the scalar kernel.

#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ int32_t approx_product_i32(int32_t a_in,
                                                      int32_t b_in) {
  const uint32_t a = static_cast<uint32_t>(a_in);
  const uint32_t b = static_cast<uint32_t>(b_in);
  const uint32_t ab = a * b;
  // truncated LSP columns 0..6 (7-term masked-operand identity); a >> i of a
  // signed value and of its bits agree for i < 32 once masked to one bit
  uint32_t t = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    t += ((a >> i) & 1u) * ((b & ((1u << (7 - i)) - 1u)) << i);
  }
  // NAND->1 conversion of not(a7 b0): error +2^7 when a7 b0
  const uint32_t conv = ((a >> 7) & 1u) & (b & 1u);
  // approximate A+B+C+D+1 compressor at column 7
  const int32_t na0b7 = 1 - static_cast<int32_t>((a & 1u) & ((b >> 7) & 1u));
  const int32_t s = static_cast<int32_t>(((a >> 1) & 1u) & ((b >> 6) & 1u)) +
                    static_cast<int32_t>(((a >> 2) & 1u) & ((b >> 5) & 1u)) +
                    static_cast<int32_t>(((a >> 3) & 1u) & ((b >> 4) & 1u));
  const int32_t approx_v = 2 * (na0b7 | (s > 0 ? 1 : 0)) + 1 -
                           (na0b7 & (s == 0 ? 1 : 0));
  const int32_t e1a = approx_v - (na0b7 + s + 1);
  const uint32_t raw = ab - t + 192u + (conv << 7) +
                       (static_cast<uint32_t>(e1a) << 7);
  // wrap to 16-bit two's complement
  return static_cast<int32_t>(raw << 16) >> 16;
}

__global__ void approx_mul_vec4_kernel(const int4* __restrict__ a,
                                       const int4* __restrict__ b,
                                       int4* __restrict__ o, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const int4 x = __ldg(a + i);
    const int4 y = __ldg(b + i);
    int4 r;
    r.x = approx_product_i32(x.x, y.x);
    r.y = approx_product_i32(x.y, y.y);
    r.z = approx_product_i32(x.z, y.z);
    r.w = approx_product_i32(x.w, y.w);
    o[i] = r;
  }
}

__global__ void approx_mul_kernel(const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b,
                                  int32_t* __restrict__ o, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    o[i] = approx_product_i32(__ldg(a + i), __ldg(b + i));
  }
}

static unsigned int grid_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return static_cast<unsigned int>(blocks < (1 << 20) ? blocks : (1 << 20));
}

// a, b, o: contiguous int32 arrays of n elements on the card.
// Returns cudaGetLastError().
extern "C" int approx_mul_launch(const void* a, const void* b, void* o,
                                 int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(o)) & 15u) == 0;
  int64_t done = 0;
  if (aligned && n >= 4) {
    const int64_t n4 = n / 4;
    approx_mul_vec4_kernel<<<grid_for(n4, threads), threads, 0, s>>>(
        static_cast<const int4*>(a), static_cast<const int4*>(b),
        static_cast<int4*>(o), n4);
    done = 4 * n4;
  }
  if (done < n) {
    approx_mul_kernel<<<grid_for(n - done, threads), threads, 0, s>>>(
        static_cast<const int32_t*>(a) + done,
        static_cast<const int32_t*>(b) + done, static_cast<int32_t*>(o) + done,
        n - done);
  }
  return static_cast<int>(cudaGetLastError());
}
