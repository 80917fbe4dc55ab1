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
// Mapping. A block is 4^(D-1) rows of four values along the fastest axis
// (row r at i0 + r in 2-D; row (p, r) at (z0 + p, i0 + r) in 3-D), spread
// over kLanes lanes; a warp holds 32 / kLanes blocks adjacent along the
// fastest axis, and each row is one 16-byte access.
//   K5: one thread per 4x4 block, its 16 values in registers through every
//     step; a warp's access to a row covers 512 contiguous bytes.
//   K6: four lanes per 4x4x4 block; lane r holds the rows (p, r), p = 0..3
//     (16 values). The transforms along z and x run in registers; along y
//     each lane gathers the three other values of its 4-point line with
//     __shfl_sync inside its group of 4 lanes, and the block's max and the
//     max and sums of nsb are xor-shuffle reductions over the group. A
//     warp's access to a row covers 128 contiguous bytes.
// Lanes whose block lies past the end stay in the warp for the shuffles;
// values outside the field count as zero (the reference pads with zeros)
// and are neither read nor written. The code takes 1, 4 or 16 lanes per 3-D
// block and 1 or 4 per 2-D one: on an H100 the counts above ran fastest
// (one row per lane repeats the per-block steps in every lane and shuffles
// twice as much; one lane per 3-D block leaves most of the card idle).
//
// Bound on this card. Each value is read once and written once (8 B),
// plus one 4-byte bits value per block, against some 2 * n * 4 * 7 float
// operations per value (n axes, forward and inverse): the bytes bound. At
// KV page shapes (a few MB) a call is one wave of the card, so its time is
// a launch's fixed cost, then the loads, the per-lane arithmetic (a few
// hundred instructions per lane) and the stores, which overlap little.
// No tensor cores: a 4x4 contraction is far below wgmma's 64-row tile, and
// TF32 would break the exactness below. (The TPU kernel batched the
// transforms as (nblk*4^(n-1), 4) x (4, 4) matmuls on its MXU over
// (128,256)/(8,64,256) VMEM tiles.)
//
// Exactness. The plain torch version (kernels/ref.py) takes the same
// float32 steps in the same order, so kernel and plain version agree bit
// for bit:
//   * each 4-point contraction as (t0*x0 + t1*x1) + (t2*x2 + t3*x3), axes
//     first to last for the forward and the inverse transform, with every
//     product rounded (--fmad=false) — the order of
//     core/transforms.py::block_transform_nd and of the reference's compiled
//     dots. Max and the nsb sums (small integers) are exact in any order;
//     the block max propagates NaN as torch.amax and clamp_min do.
//   * exponents as frexpf gives them: read from the exponent field of a
//     normal float (the block max, clamped to >= 1e-30, is one; so are
//     raw >= 2^-60 and every m >= 1), from frexpf itself for 0, subnormals,
//     inf and NaN. Powers of two built from their bits (pow2), never log2f
//     or exp2f.
//   * the divisions by powers of two as multiplications, which round the
//     same real number once:
//       - |c| / step, step = 2^s, as |c| * 2^-s: s >= -60 (raw >= 2^-60)
//         and s <= 127 (raw finite), so 2^-s lies in [2^-127, 2^60] and is
//         a float;
//       - v / scale, scale = 2^-e, as v * 2^e where e <= 127 (one exact
//         scaling); e = 128 (the block max in (2^127, FLT_MAX]) as
//         (v * 2^127) * 2, of which the first step is exact below 2^128
//         and overflows to inf with the true product above it.
//     frexpf gives exponent 0 for inf and NaN, so for those s = -1 and e = 0.
//     The remaining true division, eb / (2^e * gain), is one per block.
//
// Shapes whose last axis is not a multiple of 4 (or unaligned tensors)
// take masked scalar accesses instead of the 16-byte ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kHeaderBits = 24.0f;  // core/embedded.py BLOCK_HEADER_BITS

struct Mat4 {
  float t[16];  // T(t) row-major, float32
};

// max(a, b), NaN if either is NaN (torch.amax / clamp_min); fmaxf drops NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// frexpf's exponent (v = mant * 2^ex, |mant| in [0.5, 1)): from the exponent
// field of a normal v, from frexpf for 0, subnormals, inf and NaN
__device__ __forceinline__ int frexp_exp(float v) {
  const int biased = (__float_as_uint(v) >> 23) & 0xff;
  if (biased == 0 || biased == 0xff) {
    int ex;
    frexpf(v, &ex);
    return ex;
  }
  return biased - 126;
}

// ceil(log2 v) for v >= 0 as frexp gives it: its exponent, less one where
// v is an exact power of two (mantissa 0.5)
__device__ __forceinline__ int ceil_log2(float v) {
  const unsigned b = __float_as_uint(v);
  const int biased = (b >> 23) & 0xff;
  if (biased == 0 || biased == 0xff) {
    int ex;
    const float mant = frexpf(v, &ex);
    return mant == 0.5f ? ex - 1 : ex;
  }
  return biased - 127 + ((b & 0x7fffffu) != 0u);
}

// 2^k as a float, exactly, from its bit pattern (as ref.pow2 builds it):
// subnormal below 2^-126, 0 below 2^-149, inf above 2^127
__device__ __forceinline__ float pow2(int k) {
  if (k > 127) return __int_as_float(0x7f800000);
  if (k >= -126) return __int_as_float((k + 127) << 23);
  return k >= -149 ? __int_as_float(1 << (k + 149)) : 0.f;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Row j of the matrix M applied along an axis, M = T (forward) or T^T
// (inverse): row[k] = M[j][k]. Picked with selects over the four rows, not
// a runtime index into the kernel's parameters.
template <bool kInverse>
__device__ __forceinline__ void mat_row(const Mat4& T, int j, float* row) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t = kInverse ? T.t[k * 4] : T.t[k];
#pragma unroll
    for (int jj = 1; jj < 4; ++jj) t = j == jj ? (kInverse ? T.t[k * 4 + jj] : T.t[jj * 4 + k]) : t;
    row[k] = t;
  }
}

// In-register 4-point transform of v[0], v[s], v[2s], v[3s]: out_j =
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

// The 4-point transform along an axis spread over lanes. The lane holds
// position j of four lines (one per column c, value v[c]) and `row` = row j
// of M; the line's value at position k lies in lane base + k * stride of
// the lane's group of G lanes.
template <int G>
__device__ __forceinline__ void tx4_lanes(float* v, const float* row, int base, int stride) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __shfl_sync(kFull, v[c], base + k * stride, G);
    v[c] = (x[0] * row[0] + x[1] * row[1]) + (x[2] * row[2] + x[3] * row[3]);
  }
}

// lanes per 2-D (K5) and per 3-D (K6) block
constexpr int kLanes2D = 1;
constexpr int kLanes3D = 4;

// A block's 4^(D-1) rows of four (row rho = 4p + r in 3-D, r in 2-D) over
// G lanes: lane l holds rows rho = i * G + l, i < 4^(D-1) / G, as
// v[4i .. 4i + 3].
template <int D, int G>
struct Lanes {
  static constexpr int kRows = (D == 2 ? 4 : 16) / G;
  static constexpr int kVals = 4 * kRows;
};

// The transform along one block axis other than the last, whose lines step
// the row index rho by S: where S >= G a line lies in the lane's own rows
// (slots S / G apart), else across lanes S apart.
template <int D, int G, int S, bool kInverse>
__device__ __forceinline__ void tx4_axis(float* v, int lane, const Mat4& T) {
  constexpr int R = Lanes<D, G>::kRows;
  if constexpr (S >= G) {
    constexpr int s = S / G;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if ((i / s) % 4 == 0)
#pragma unroll
        for (int c = 0; c < 4; ++c) tx4<kInverse>(v + 4 * i + c, 4 * s, T);
  } else {
    static_assert(G >= 4 * S, "a line lies within one lane or across four");
    const int j = (lane / S) % 4;
    float row[4];
    mat_row<kInverse>(T, j, row);
#pragma unroll
    for (int i = 0; i < R; ++i) tx4_lanes<G>(v + 4 * i, row, lane - j * S, S);
  }
}

// The transform along every block axis, first to last: z (rho step 4) and
// y (step 1) in 3-D, the rows (step 1) in 2-D, then the last axis, which
// lies within each row.
template <int D, int G, bool kInverse>
__device__ __forceinline__ void transform(float* v, int lane, const Mat4& T) {
  if constexpr (D == 3) tx4_axis<D, G, 4, kInverse>(v, lane, T);
  tx4_axis<D, G, 1, kInverse>(v, lane, T);
#pragma unroll
  for (int i = 0; i < Lanes<D, G>::kRows; ++i) tx4<kInverse>(v + 4 * i, 1, T);
}

// The block's steps on the lane's values in v (zero outside the field):
// leaves the lane's part of the reconstruction in v and returns the
// block's bits (in every lane of the block).
template <int D, int G>
__device__ __forceinline__ float bot_block(float* v, int lane, float eb, float gain,
                                           const Mat4& T) {
  constexpr int N = Lanes<D, G>::kVals;
  constexpr float kW = D == 2 ? 5.0f : 7.0f;  // ceil(log2(4^D + 1))
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) mx = max_nan(mx, fabsf(v[i]));
  const int e = ceil_log2(max_nan(group_max<G>(mx), 1e-30f));
  const float scale = pow2(-e);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = v[i] * scale;
  transform<D, G, false>(v, lane, T);
  const float raw = max_nan(__fdiv_rn(eb, pow2(e) * gain), 0x1p-60f);
  const int s = frexp_exp(raw) - 1;  // step = 2^s = 2^floor(log2 raw)
  const float step = pow2(s), inv_step = pow2(-s);
  float maxp = 0.f, sig = 0.f, nsig = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float cf = v[i];
    const float m = truncf(fabsf(cf) * inv_step);  // == |c| / step, exactly
    const float nsb = m >= 1.0f ? static_cast<float>(frexp_exp(m)) : 0.f;
    maxp = fmaxf(maxp, nsb);
    sig += nsb;
    nsig += nsb > 0.f ? 1.f : 0.f;
    const float mag = m > 0.f ? (m + 0.5f) * step : 0.f;
    v[i] = cf < 0.f ? -mag : mag;
  }
  maxp = group_max<G>(maxp);
  sig = group_sum<G>(sig);
  nsig = group_sum<G>(nsig);
  transform<D, G, true>(v, lane, T);
  // v / 2^-e: one exact scaling by 2^e, or by 2^127 and then 2 where e = 128
  if (e > 127) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (v[i] * 0x1p127f) * 2.0f;
  } else {
    const float up = pow2(e);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * up;
  }
  return ((kHeaderBits + kW * maxp) + sig) + 2.0f * nsig;
}

// quot = a / b and rem = a % b for a >= 0, b > 0; 32-bit where both fit
__device__ __forceinline__ void divmod(int64_t a, int64_t b, int64_t& quot, int64_t& rem) {
  if (a <= 0xffffffffLL && b <= 0xffffffffLL) {
    const uint32_t q32 = static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
    quot = q32;
    rem = a - static_cast<int64_t>(q32) * b;
  } else {
    quot = a / b;
    rem = a - quot * b;
  }
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

// Both kernels' launch bounds name a minimum of one thread block per SM:
// ptxas then keeps more values in registers than without one (for K6
// 91-96 against 48-56, and 3% less time on an H100).

// K5: kLanes2D lanes per 4x4 block.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    bot2d_kernel(const float* __restrict__ x, float* __restrict__ recon,
                 float* __restrict__ bits, int64_t m, int64_t n, int64_t bn,
                 int64_t nblk, const float* __restrict__ eb_ptr, Mat4 T,
                 float gain) {
  constexpr int G = kLanes2D;
  using L = Lanes<2, G>;
  const int64_t g = (blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  int64_t bi, bj;
  divmod(g, bn, bi, bj);
  const int64_t i0 = bi * 4, j0 = bj * 4;
  const bool active = g < nblk;
  float v[L::kVals];
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    const int r = i * G + lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[4 * i + c] = 0.f;
    if (active && i0 + r < m) load_row<kVec>(x, (i0 + r) * n, j0, n, v + 4 * i);
  }
  const float b = bot_block<2, G>(v, lane, *eb_ptr, gain, T);
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    const int r = i * G + lane;
    if (active && i0 + r < m) store_row<kVec>(recon, (i0 + r) * n, j0, n, v + 4 * i);
  }
  if (active && lane == 0) bits[g] = b;
}

// K6: kLanes3D lanes per 4x4x4 block.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    bot3d_kernel(const float* __restrict__ x, float* __restrict__ recon,
                 float* __restrict__ bits, int64_t nz, int64_t m, int64_t n,
                 int64_t bm, int64_t bn, int64_t nblk,
                 const float* __restrict__ eb_ptr, Mat4 T, float gain) {
  constexpr int G = kLanes3D;
  using L = Lanes<3, G>;
  const int64_t g = (blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  int64_t rest, bj, bz, bi;
  divmod(g, bn, rest, bj);
  divmod(rest, bm, bz, bi);
  const int64_t z0 = bz * 4, i0 = bi * 4, j0 = bj * 4;
  const bool active = g < nblk;
  float v[L::kVals];
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    const int rho = i * G + lane, p = rho >> 2, r = rho & 3;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[4 * i + c] = 0.f;
    if (active && z0 + p < nz && i0 + r < m)
      load_row<kVec>(x, ((z0 + p) * m + i0 + r) * n, j0, n, v + 4 * i);
  }
  const float b = bot_block<3, G>(v, lane, *eb_ptr, gain, T);
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    const int rho = i * G + lane, p = rho >> 2, r = rho & 3;
    if (active && z0 + p < nz && i0 + r < m)
      store_row<kVec>(recon, ((z0 + p) * m + i0 + r) * n, j0, n, v + 4 * i);
  }
  if (active && lane == 0) bits[g] = b;
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

// Thread blocks for `lanes` lanes, or 0 where the grid would be too large.
int64_t grid_for(int64_t lanes) {
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0 : blocks;
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
  const int64_t blocks = grid_for(nblk * kLanes2D);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
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
  const int64_t blocks = grid_for(nblk * kLanes3D);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
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
