// Fused prequantize + integer Lorenzo encode (SZ's Stage I+II), and the
// decode side's dequantize, for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lorenzo.py:
//   lorenzo2d_encode_kernel  <- lorenzo2d_encode (body _encode_kernel)
//   lorenzo3d_encode_kernel  <- lorenzo3d_encode (body _encode3d_kernel)
//   dequantize_kernel        <- dequantize2d and dequantize3d (body
//                               _dequant_kernel), see the note further down
//
// Each output is d = Lorenzo difference of the codes k = rint(x / (2 eb)),
// with codes outside the domain taken as 0. The arithmetic is the
// reference's, operation for operation, so the int32 codes are exact:
//   * a true IEEE float32 division by delta = 2.0f * eb (never a multiply
//     by the reciprocal; the build passes no --use_fast_math);
//   * rounding half to even (rintf), as jnp.round does;
//   * the difference formed in float32 in the reference's order, then
//     converted to int32. Below 2^23 (the device encoder's guard) every
//     intermediate is an exactly representable integer.
//
// Bound on this card: bytes. Each value is read once (4 B) and written once
// (4 B int32); the arithmetic is a handful of operations per value. The TPU
// kernel fetched halo views around (256,256) VMEM tiles; here there are no
// tiles. Each thread owns one column (2-D) or one (y, x) line (3-D) and
// walks kRun steps along the slowest axis, keeping the previous row's or
// plane's codes in registers. Neighbouring threads read neighbouring
// addresses, so loads coalesce, and the left neighbour each thread also
// reads is its neighbour's own value, served from L1. Ragged edges are
// masked per thread; nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 8;      // rows (2-D) or planes (3-D) walked per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float quant(float v, float delta) {
  return rintf(__fdiv_rn(v, delta));
}

// 2-D: grid.x enumerates (row run, column tile) pairs; one thread per column.
__global__ void lorenzo2d_encode_kernel(const float* __restrict__ x,
                                        int32_t* __restrict__ out, int64_t m,
                                        int64_t n, float delta,
                                        int64_t col_tiles) {
  const int64_t tile = blockIdx.x % col_tiles;
  const int64_t i0 = (blockIdx.x / col_tiles) * kRun;
  const int64_t j = tile * kThreads + threadIdx.x;
  if (j >= n) return;
  float up = 0.f, ul = 0.f;  // codes of the row above the run
  if (i0 > 0) {
    up = quant(x[(i0 - 1) * n + j], delta);
    if (j > 0) ul = quant(x[(i0 - 1) * n + j - 1], delta);
  }
  const int64_t i1 = i0 + kRun < m ? i0 + kRun : m;
  for (int64_t i = i0; i < i1; ++i) {
    const float k = quant(x[i * n + j], delta);
    const float left = j > 0 ? quant(x[i * n + j - 1], delta) : 0.f;
    // _encode_kernel: d = k - k_up - k_left + k_ul, left to right
    const float d = ((k - up) - left) + ul;
    out[i * n + j] = static_cast<int32_t>(d);
    up = k;
    ul = left;
  }
}

// 3-D: 32x8 threads per block over (x, y); grid.x enumerates
// (plane run, y tile, x tile) triples.
__global__ void lorenzo3d_encode_kernel(const float* __restrict__ x,
                                        int32_t* __restrict__ out, int64_t nz,
                                        int64_t m, int64_t n, float delta,
                                        int64_t x_tiles, int64_t y_tiles) {
  const int64_t bx = blockIdx.x % x_tiles;
  const int64_t rest = blockIdx.x / x_tiles;
  const int64_t by = rest % y_tiles;
  const int64_t z0 = (rest / y_tiles) * kRun;
  const int64_t j = bx * 32 + threadIdx.x;
  const int64_t i = by * 8 + threadIdx.y;
  if (i >= m || j >= n) return;
  const bool has_up = i > 0, has_left = j > 0;
  auto q = [&](int64_t z, int64_t ii, int64_t jj) {
    return quant(x[(z * m + ii) * n + jj], delta);
  };
  // codes at (y, x), (y-1, x), (y, x-1), (y-1, x-1) of the previous plane
  float p00 = 0.f, p10 = 0.f, p01 = 0.f, p11 = 0.f;
  if (z0 > 0) {
    p00 = q(z0 - 1, i, j);
    if (has_up) p10 = q(z0 - 1, i - 1, j);
    if (has_left) p01 = q(z0 - 1, i, j - 1);
    if (has_up && has_left) p11 = q(z0 - 1, i - 1, j - 1);
  }
  const int64_t z1 = z0 + kRun < nz ? z0 + kRun : nz;
  for (int64_t z = z0; z < z1; ++z) {
    const float c00 = q(z, i, j);
    const float c10 = has_up ? q(z, i - 1, j) : 0.f;
    const float c01 = has_left ? q(z, i, j - 1) : 0.f;
    const float c11 = has_up && has_left ? q(z, i - 1, j - 1) : 0.f;
    // _encode3d_kernel: one backward difference per axis, z then y then x
    const float d = ((c00 - p00) - (c10 - p10)) - ((c01 - p01) - (c11 - p11));
    out[(z * m + i) * n + j] = static_cast<int32_t>(d);
    p00 = c00;
    p10 = c10;
    p01 = c01;
    p11 = c11;
  }
}

// Dequantize (K3/K4): out = float(k) * delta, elementwise, delta = 2.0f * eb
// rounded as the encode rounds it and the int32 -> float32 conversion
// rounded to nearest even, as the reference's astype. The TPU kernel walked
// (256,256) or (8,128,256) VMEM tiles; the op has no neighbours, so here
// the rank only names the entry point and both run one flat kernel. Bound:
// bytes (4 B read, 4 B written per value, one multiply). Each thread moves
// 16 B per access (int4 in, float4 out) when both pointers are 16-byte
// aligned, over a grid-stride loop; the tail and unaligned views go scalar.
__global__ void dequantize_vec_kernel(const int4* __restrict__ k,
                                      float4* __restrict__ out, int64_t n4,
                                      float delta) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int4 v = k[i];
    out[i] = make_float4(__int2float_rn(v.x) * delta, __int2float_rn(v.y) * delta,
                         __int2float_rn(v.z) * delta, __int2float_rn(v.w) * delta);
  }
}

__global__ void dequantize_kernel(const int32_t* __restrict__ k,
                                  float* __restrict__ out, int64_t lo,
                                  int64_t n, float delta) {
  for (int64_t i = lo + blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = __int2float_rn(k[i]) * delta;
  }
}

int dequantize(const int32_t* k, float* out, int64_t n, float eb,
               cudaStream_t stream) {
  if (n <= 0) return 0;
  const float delta = 2.0f * eb;
  constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM, then stride
  const bool aligned = (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    int64_t blocks = (n4 + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
    dequantize_vec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(k), reinterpret_cast<float4*>(out), n4,
        delta);
  }
  const int64_t lo = 4 * n4;
  if (lo < n) {
    int64_t blocks = (n - lo + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
    dequantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        k, out, lo, n, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. Each launches on `stream` and returns the
// launch's cudaError_t (0 on success); nothing synchronises.
extern "C" int lorenzo2d_encode(const float* x, int32_t* out, int64_t m,
                                int64_t n, float eb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const float delta = 2.0f * eb;
  const int64_t col_tiles = (n + kThreads - 1) / kThreads;
  const int64_t blocks = col_tiles * ((m + kRun - 1) / kRun);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  lorenzo2d_encode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, out, m, n, delta, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lorenzo3d_encode(const float* x, int32_t* out, int64_t nz,
                                int64_t m, int64_t n, float eb, void* stream) {
  if (nz <= 0 || m <= 0 || n <= 0) return 0;
  const float delta = 2.0f * eb;
  const int64_t x_tiles = (n + 31) / 32, y_tiles = (m + 7) / 8;
  const int64_t blocks = x_tiles * y_tiles * ((nz + kRun - 1) / kRun);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  lorenzo3d_encode_kernel<<<static_cast<unsigned>(blocks), dim3(32, 8), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, out, nz, m, n, delta, x_tiles, y_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize2d(const int32_t* k, float* out, int64_t m, int64_t n,
                            float eb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  return dequantize(k, out, m * n, eb, static_cast<cudaStream_t>(stream));
}

extern "C" int dequantize3d(const int32_t* k, float* out, int64_t nz, int64_t m,
                            int64_t n, float eb, void* stream) {
  if (nz <= 0 || m <= 0 || n <= 0) return 0;
  return dequantize(k, out, nz * m * n, eb, static_cast<cudaStream_t>(stream));
}
