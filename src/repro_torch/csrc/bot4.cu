// Fused ZFP-style block transform + bit-plane truncation (the BOT surrogate)
// for Hopper: K5 on 4x4 blocks of a 2-D field, K6 on 4x4x4 blocks of a 3-D
// one.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bot4.py:
//   bot2d_kernel  <- bot2d_fused (body _bot_kernel)
//   bot3d_kernel  <- bot3d_fused (body _bot3d_kernel)
//
// Per block: e = ceil(log2 max(max|b|, 1e-30)); c = T(b * 2^-e) along every
// block axis; step = 2^floor(log2 max(eb / (2^e * gain^n), 2^-60));
// m = trunc(|c| / step); nsb = floor(log2 m) + 1 (0 where m < 1);
// bits = 24 + w * max nsb + sum nsb + 2 * #(nsb > 0), w = 5 (2-D) or 7 (3-D);
// recon = the inverse transform of sign(c) * (m + 0.5) * step (0 where
// m = 0), divided by 2^-e.
//
// Exactness. The plain torch version (kernels/ref.py) and this kernel take
// the same float32 steps in the same order, so they agree bit for bit:
//   * exponents from frexpf and powers of two from ldexpf, never log2f or
//     exp2f (exact at every argument, which the TPU's exp2/log2 are not);
//   * each 4-point contraction as (t0*x0 + t1*x1) + (t2*x2 + t3*x3), axes
//     first to last, with every product rounded (--fmad=false) — the order
//     of core/transforms.py::block_transform_nd and of the reference's
//     compiled dots;
//   * true IEEE divisions (__fdiv_rn) where the reference divides.
// Values outside the field count as zero (the reference pads with zeros);
// pad blocks are neither computed nor written.
//
// Bound on this card: bytes. Each value is read once and written once
// (8 B), plus one 4-byte bits value per block; the transforms cost
// 2 * n * 4 * 7 float operations per value and pair (n axes, forward and
// inverse), far below the float32 peak per byte. The TPU kernel batched
// the transforms as (nblk*4^(n-1), 4) x (4, 4) matmuls on its MXU over
// (128,256)/(8,64,256) VMEM tiles; a 4x4 product is far too small for
// Hopper's tensor cores, and TF32 would break the exactness above. Here
// each thread owns one block and keeps its 16 (2-D) or 64 (3-D) values in
// registers through every step; adjacent threads own adjacent blocks along
// the fastest axis, so each row of 4 values is one 16-byte load that
// coalesces across the warp where the row length is a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kHeaderBits = 24.0f;  // core/embedded.py BLOCK_HEADER_BITS

struct Mat4 {
  float t[16];  // T(t) row-major, float32
};

// In-place 4-point transform of v[0], v[s], v[2s], v[3s]: out_j =
// (M[j][0]*x0 + M[j][1]*x1) + (M[j][2]*x2 + M[j][3]*x3), M = T or T^T.
template <bool kInverse>
__device__ __forceinline__ void tx4(float* v, int s, const Mat4& T) {
  const float x0 = v[0], x1 = v[s], x2 = v[2 * s], x3 = v[3 * s];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float m0 = kInverse ? T.t[0 * 4 + j] : T.t[j * 4 + 0];
    const float m1 = kInverse ? T.t[1 * 4 + j] : T.t[j * 4 + 1];
    const float m2 = kInverse ? T.t[2 * 4 + j] : T.t[j * 4 + 2];
    const float m3 = kInverse ? T.t[3 * 4 + j] : T.t[j * 4 + 3];
    v[j * s] = (x0 * m0 + x1 * m1) + (x2 * m2 + x3 * m3);
  }
}

// The transform along every axis of a 4^D block held as v[(p*4 + r)*4 + c].
template <int D, bool kInverse>
__device__ __forceinline__ void transform(float* v, const Mat4& T) {
  if constexpr (D == 3) {
#pragma unroll
    for (int i = 0; i < 16; ++i) tx4<kInverse>(v + i, 16, T);  // z
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) tx4<kInverse>(v + p * 16 + c, 4, T);  // y
#pragma unroll
    for (int i = 0; i < 16; ++i) tx4<kInverse>(v + i * 4, 1, T);  // x
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) tx4<kInverse>(v + c, 4, T);  // rows
#pragma unroll
    for (int r = 0; r < 4; ++r) tx4<kInverse>(v + r * 4, 1, T);  // columns
  }
}

// ceil(log2 v) for a positive finite v, exactly
__device__ __forceinline__ int ceil_log2(float v) {
  int ex;
  const float mant = frexpf(v, &ex);  // v = mant * 2^ex, mant in [0.5, 1)
  return mant == 0.5f ? ex - 1 : ex;
}

// The block's steps on its 4^D values in v (zero outside the field):
// leaves the reconstruction in v and returns the block's bits.
template <int D>
__device__ __forceinline__ float bot_block(float* v, float eb, float gain,
                                           const Mat4& T) {
  constexpr int kN = 1 << (2 * D);
  constexpr float kW = D == 2 ? 5.0f : 7.0f;  // ceil(log2(4^D + 1))
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) mx = fmaxf(mx, fabsf(v[i]));
  const int e = ceil_log2(fmaxf(mx, 1e-30f));
  const float scale = ldexpf(1.0f, -e);
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = v[i] * scale;
  transform<D, false>(v, T);
  const float raw = fmaxf(__fdiv_rn(eb, ldexpf(1.0f, e) * gain), 0x1p-60f);
  int pex;
  frexpf(raw, &pex);
  const float step = ldexpf(1.0f, pex - 1);  // 2^floor(log2 raw)
  float maxp = 0.f, sig = 0.f, nsig = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float c = v[i];
    const float m = truncf(__fdiv_rn(fabsf(c), step));
    float nsb = 0.f;
    if (m >= 1.0f) {
      int ex;
      frexpf(m, &ex);  // floor(log2 m) + 1
      nsb = static_cast<float>(ex);
    }
    maxp = fmaxf(maxp, nsb);
    sig += nsb;
    nsig += nsb > 0.f ? 1.f : 0.f;
    const float mag = m > 0.f ? (m + 0.5f) * step : 0.f;
    v[i] = c < 0.f ? -mag : mag;
  }
  transform<D, true>(v, T);
#pragma unroll
  for (int i = 0; i < kN; ++i) v[i] = __fdiv_rn(v[i], scale);
  return ((kHeaderBits + kW * maxp) + sig) + 2.0f * nsig;
}

// One 4-value row of the field at (row offset `base`, first column j0):
// a 16-byte load when kVec (row length a multiple of 4, aligned base),
// else four masked loads; columns at or past n read as zero.
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         int64_t base, int64_t j0, int64_t n,
                                         float* v) {
  if (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(x + base + j0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = j0 + c < n ? x[base + j0 + c] : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ y, int64_t base,
                                          int64_t j0, int64_t n,
                                          const float* v) {
  if (kVec) {
    *reinterpret_cast<float4*>(y + base + j0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c < n) y[base + j0 + c] = v[c];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    bot2d_kernel(const float* __restrict__ x, float* __restrict__ recon,
                 float* __restrict__ bits, int64_t m, int64_t n, int64_t bn,
                 int64_t nblk, const float* __restrict__ eb_ptr, Mat4 T,
                 float gain) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (g >= nblk) return;
  const int64_t i0 = (g / bn) * 4, j0 = (g % bn) * 4;
  float v[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (i0 + r < m) {
      load_row<kVec>(x, (i0 + r) * n, j0, n, v + r * 4);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r * 4 + c] = 0.f;
    }
  }
  bits[g] = bot_block<2>(v, *eb_ptr, gain, T);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (i0 + r < m) store_row<kVec>(recon, (i0 + r) * n, j0, n, v + r * 4);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    bot3d_kernel(const float* __restrict__ x, float* __restrict__ recon,
                 float* __restrict__ bits, int64_t nz, int64_t m, int64_t n,
                 int64_t bm, int64_t bn, int64_t nblk,
                 const float* __restrict__ eb_ptr, Mat4 T, float gain) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (g >= nblk) return;
  const int64_t j0 = (g % bn) * 4;
  const int64_t rest = g / bn;
  const int64_t i0 = (rest % bm) * 4, z0 = (rest / bm) * 4;
  float v[64];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* row = v + (p * 4 + r) * 4;
      if (z0 + p < nz && i0 + r < m) {
        load_row<kVec>(x, ((z0 + p) * m + i0 + r) * n, j0, n, row);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) row[c] = 0.f;
      }
    }
  }
  bits[g] = bot_block<3>(v, *eb_ptr, gain, T);
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (z0 + p < nz && i0 + r < m)
        store_row<kVec>(recon, ((z0 + p) * m + i0 + r) * n, j0, n,
                        v + (p * 4 + r) * 4);
}

bool vec_ok(const float* x, const float* recon, int64_t n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(recon) % 16 == 0;
}

Mat4 mat4(const float* T) {
  Mat4 M;
  for (int i = 0; i < 16; ++i) M.t[i] = T[i];
  return M;
}

}  // namespace

// C interface, bound with ctypes. `eb` points to one float32 on the device
// (the solved bound stays on the card); `T` points to the 16 float32 entries
// of T(t) in host memory, row-major; `gain` is bot_linf_gain^n rounded to
// float32. Each launches on `stream` and returns the launch's cudaError_t
// (0 on success); nothing synchronises.
extern "C" int bot2d_fused(const float* x, float* recon, float* bits, int64_t m,
                           int64_t n, const float* eb, const float* T,
                           float gain, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t bn = (n + 3) / 4, nblk = ((m + 3) / 4) * bn;
  const int64_t blocks = (nblk + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const Mat4 M = mat4(T);
  if (vec_ok(x, recon, n)) {
    bot2d_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, recon, bits, m, n, bn, nblk, eb, M, gain);
  } else {
    bot2d_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, recon, bits, m, n, bn, nblk, eb, M, gain);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bot3d_fused(const float* x, float* recon, float* bits, int64_t nz,
                           int64_t m, int64_t n, const float* eb, const float* T,
                           float gain, void* stream) {
  if (nz <= 0 || m <= 0 || n <= 0) return 0;
  const int64_t bm = (m + 3) / 4, bn = (n + 3) / 4;
  const int64_t nblk = ((nz + 3) / 4) * bm * bn;
  const int64_t blocks = (nblk + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const Mat4 M = mat4(T);
  if (vec_ok(x, recon, n)) {
    bot3d_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, recon, bits, nz, m, n, bm, bn, nblk, eb, M, gain);
  } else {
    bot3d_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        x, recon, bits, nz, m, n, bm, bn, nblk, eb, M, gain);
  }
  return static_cast<int>(cudaGetLastError());
}
