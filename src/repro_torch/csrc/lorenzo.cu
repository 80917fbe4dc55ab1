// Fused prequantize + integer Lorenzo encode (SZ's Stage I+II), and the
// decode side's dequantize, for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lorenzo.py:
//   lorenzo2d_kernel (K1)   <- lorenzo2d_encode (body _encode_kernel)
//   lorenzo3d_kernel (K2)   <- lorenzo3d_encode (body _encode3d_kernel)
//   dequantize_kernel       <- dequantize2d and dequantize3d (body
//                              _dequant_kernel), see the note further down
//
// Each output is d = Lorenzo difference of the codes k = rint(x / (2 eb)),
// with codes outside the domain taken as 0. The arithmetic is the
// reference's, operation for operation, so the int32 codes are exact:
//   * a true IEEE float32 division by delta = 2.0f * eb (never a multiply
//     by the reciprocal; the build passes no --use_fast_math);
//   * rounding half to even (rintf), as jnp.round does;
//   * the difference formed in float32 in the reference's order (2-D
//     ((k - up) - left) + ul; 3-D one backward difference per axis, z then
//     y then x), with no contracted multiply-adds (--fmad=false), so that
//     it rounds as the reference's does above 2^24;
//   * the float -> int32 conversion by static_cast (cvt.rzi.s32.f32):
//     truncated, saturated at the int32 limits, NaN -> 0, as XLA's astype.
//
// Bound on this card: bytes. Each value is read once (4 B) and written
// once (4 B int32). The TPU kernel fetched halo views around (256,256)
// VMEM tiles. What holds a Hopper version back is latency, not width: the
// IEEE division compiles to a fast path and a call to a slow path behind a
// branch and a convergence barrier, so the divisions of one thread run one
// after another (~50 cycles each), and the card streams only with enough
// such chains in flight. So (sizes measured on the card, PERF.md):
//   * every value is quantized once: a lane owns V adjacent columns, V = 4
//     (one 16-byte load and store a row) where rows are 16-byte aligned
//     (n % 4 == 0, both pointers aligned), V = 1 (coalesced scalar
//     accesses) elsewhere; the left neighbour of its first column comes
//     from lane - 1 (__shfl_up_sync); the code left of the warp's strip of
//     32 V columns is quantized by one lane per row (K1) or per plane (K2)
//     and broadcast (__shfl_sync), so no lane branches around a division;
//   * short serial chains, many of them: a K1 warp takes kRun2D = 2 rows and
//     reads and quantizes the row above again (served from L2); a K2 block
//     is one warp per row of a kRows3D = 4 row tile plus one for the row
//     above, walking kRun3D = 3 planes; per plane each lane forms the z
//     difference against its registers and the block shares it through
//     shared memory, double-buffered, one __syncthreads a plane. Longer
//     runs, taller tiles and more rows per lane all measured slower;
//   * loads are issued as predicated PTX (a C++ `ok ? *p : 0` may wait at
//     the load), all of a K1 run's at once and K2's next plane before the
//     current plane's arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // dequantize
constexpr int kBlock = 128;    // K1: lanes per block, strips side by side along x
constexpr int kRun2D = 2;      // K1: rows per warp (at most 31)
constexpr int kRows3D = 4;     // K2: rows per block (one warp each, and one more)
constexpr int kRun3D = 3;      // K2: planes walked per block (at most 31)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float quant(float v, float delta) {
  return rintf(__fdiv_rn(v, delta));
}

// V consecutive floats at p (16-byte aligned when V == 4) into v where
// ok; where not, v keeps what it held. Predicated in PTX, so that nothing
// waits for the load until its value is used (for `ok ? *p : 0` the
// compiler may select, and so wait, right at the load).
template <int V>
__device__ __forceinline__ void load_if(const float* p, bool ok, float (&v)[V]) {
  if constexpr (V == 4) {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
        "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
        : "+f"(v[0]), "+f"(v[1]), "+f"(v[2]), "+f"(v[3])
        : "l"(p), "r"(static_cast<int>(ok)));
  } else {
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q ld.global.nc.f32 %0, [%1];\n\t}"
        : "+f"(v[0])
        : "l"(p), "r"(static_cast<int>(ok)));
  }
}

// V consecutive codes to p (16-byte aligned when V == 4): one 16-byte
// store (the compiler split an int4 assignment into four 4-byte stores).
template <int V>
__device__ __forceinline__ void store(int32_t* p, const int32_t (&d)[V]) {
  if constexpr (V == 4) {
    asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(p), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]));
  } else {
    p[0] = d[0];
  }
}

// K1. grid.x enumerates (row run, column tile) pairs; a column tile is
// kBlock lanes, kBlock / 32 strips side by side. Row t = 0..kRun2D of a
// lane's arrays is row i0 - 1 + t (t = 0: the row above the run). All the
// run's loads go out at once; codes outside the domain are 0.
template <int V>
__global__ void __launch_bounds__(kBlock) lorenzo2d_kernel(
    const float* __restrict__ x, int32_t* __restrict__ out, int64_t m, int64_t n,
    float delta, int64_t col_tiles) {
  constexpr int R = kRun2D;
  static_assert(R < 32, "one lane per row holds the code left of the strip");
  const int lane = threadIdx.x % 32;
  const int64_t strip = (blockIdx.x % col_tiles) * kBlock + (threadIdx.x - lane);
  const int64_t j0 = strip * V;  // the strip's first column
  if (j0 >= n) return;           // the whole strip lies past the edge
  const int64_t j = j0 + lane * V;
  const bool live = j < n;  // all V columns inside (n % V == 0)
  const int64_t i0 = (blockIdx.x / col_tiles) * R;
  const float* xr = x + (i0 - 1) * n;  // row t at xr + t n
  auto row_ok = [&](int64_t t) { return i0 - 1 + t >= 0 && i0 - 1 + t < m; };

  float v[R + 1][V] = {};
#pragma unroll
  for (int t = 0; t <= R; ++t) load_if<V>(xr + t * n + j, live && row_ok(t), v[t]);
  // lane t quantizes the value left of the strip in row t
  const bool lok = lane <= R && j0 > 0 && row_ok(lane);
  float lv[1] = {0.f};
  load_if<1>(xr + lane * n + j0 - 1, lok, lv);
  const float left_code = lok ? quant(lv[0], delta) : 0.f;

  float up[V];  // codes of the row above, and the one left of them
#pragma unroll
  for (int c = 0; c < V; ++c) up[c] = row_ok(0) ? quant(v[0][c], delta) : 0.f;
  float ul = __shfl_up_sync(kFull, up[V - 1], 1);
  {
    const float l = __shfl_sync(kFull, left_code, 0);
    if (lane == 0) ul = l;
  }
#pragma unroll
  for (int t = 1; t <= R; ++t) {
    float q[V];
#pragma unroll
    for (int c = 0; c < V; ++c) q[c] = quant(v[t][c], delta);
    float left = __shfl_up_sync(kFull, q[V - 1], 1);
    const float l = __shfl_sync(kFull, left_code, t);
    if (lane == 0) left = l;
    // _encode_kernel: d = k - k_up - k_left + k_ul, left to right
    int32_t d[V];
    d[0] = static_cast<int32_t>(((q[0] - up[0]) - left) + ul);
#pragma unroll
    for (int c = 1; c < V; ++c) d[c] = static_cast<int32_t>(((q[c] - up[c]) - q[c - 1]) + up[c - 1]);
    if (live && row_ok(t)) store<V>(out + (i0 - 1 + t) * n + j, d);
    ul = left;
#pragma unroll
    for (int c = 0; c < V; ++c) up[c] = q[c];
  }
}

// K2. A block is kRows3D + 1 warps stacked along y over one strip of
// 32 V columns: warp w on row y0 - 1 + w (warp 0 on the row above the
// tile, which it reads and quantizes but does not store). grid.x
// enumerates (plane run, row tile, strip) triples. Each lane keeps the
// previous plane's codes of its own columns; per plane it forms the z
// difference a = k - k(z - 1), shares it through shared memory
// (double-buffered, so one __syncthreads a plane) and takes the y and x
// differences with the row above and the lane to the left.
template <int V>
__global__ void __launch_bounds__(32 * (kRows3D + 1)) lorenzo3d_kernel(
    const float* __restrict__ x, int32_t* __restrict__ out, int64_t nz, int64_t m,
    int64_t n, float delta, int64_t strips, int64_t row_tiles) {
  static_assert(kRun3D < 32, "one lane per plane holds the code left of the strip");
  __shared__ float sa[2][kRows3D + 1][32 * V];  // a of each row of the tile
  __shared__ float sl[2][kRows3D + 1];          // a left of the strip
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int64_t j0 = (blockIdx.x % strips) * 32 * V;  // the strip's first column
  const int64_t j = j0 + lane * V;
  const bool live = j < n;
  const int64_t rest = blockIdx.x / strips;
  const int64_t y = (rest % row_tiles) * kRows3D - 1 + w;
  const int64_t z0 = (rest / row_tiles) * kRun3D;
  const int64_t z1 = z0 + kRun3D < nz ? z0 + kRun3D : nz;
  const bool row_ok = y >= 0 && y < m;
  const float* xj = x + y * n + j;  // this lane's columns in plane z at xj + z m n

  float nxt[V] = {}, pv[V] = {};  // the next plane's loads; the plane above the run
  auto fetch = [&](int64_t z, bool ok, float (&v)[V]) {
    load_if<V>(xj + z * m * n, ok && row_ok && live, v);
  };
  fetch(z0 - 1, z0 > 0, pv);
  fetch(z0, true, nxt);
  // lane s quantizes the value left of the strip in plane z0 - 1 + s, and
  // holds its z difference
  const int64_t zl = z0 - 1 + lane;
  const bool lok = lane <= kRun3D && j0 > 0 && row_ok && zl >= 0 && zl < z1;
  float lv[1] = {0.f};
  load_if<1>(x + (zl * m + y) * n + j0 - 1, lok, lv);
  const float kl = lok ? quant(lv[0], delta) : 0.f;
  const float al_lane = kl - __shfl_up_sync(kFull, kl, 1);
  float prev[V];  // the previous plane's codes (0 before the first)
#pragma unroll
  for (int c = 0; c < V; ++c) prev[c] = z0 > 0 && row_ok ? quant(pv[c], delta) : 0.f;
#pragma unroll
  for (int s = 0; s < kRun3D; ++s) {
    const int64_t z = z0 + s;
    if (z >= z1) break;
    const int buf = s & 1;
    float cur[V];
#pragma unroll
    for (int c = 0; c < V; ++c) cur[c] = nxt[c];
    fetch(z + 1, z + 1 < z1, nxt);  // the next plane's loads go out first
    float a[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const float k = row_ok ? quant(cur[c], delta) : 0.f;
      a[c] = k - prev[c];
      prev[c] = k;
    }
    const float al = __shfl_sync(kFull, al_lane, s + 1);  // a left of the strip
#pragma unroll
    for (int c = 0; c < V; ++c) sa[buf][w][lane * V + c] = a[c];
    if (lane == 0) sl[buf][w] = al;
    __syncthreads();
    if (w > 0) {
      // then y, then x: d = ((c00 - p00) - (c10 - p10)) - ((c01 - p01) - (c11 - p11))
      float b[V];
#pragma unroll
      for (int c = 0; c < V; ++c) b[c] = a[c] - sa[buf][w - 1][lane * V + c];
      float bl = __shfl_up_sync(kFull, b[V - 1], 1);
      if (lane == 0) bl = al - sl[buf][w - 1];
      int32_t d[V];
      d[0] = static_cast<int32_t>(b[0] - bl);
#pragma unroll
      for (int c = 1; c < V; ++c) d[c] = static_cast<int32_t>(b[c] - b[c - 1]);
      if (row_ok && live) store<V>(out + (z * m + y) * n + j, d);
    }
  }
}

// Rows of 16 bytes: n % 4 == 0 and both pointers 16-byte aligned.
bool rows_of_16_bytes(const void* a, const void* b, int64_t n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
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
  const bool vec = rows_of_16_bytes(x, out, n);
  const int64_t lanes = vec ? n / 4 : n;
  const int64_t col_tiles = (lanes + kBlock - 1) / kBlock;
  const int64_t blocks = col_tiles * ((m + kRun2D - 1) / kRun2D);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    lorenzo2d_kernel<4><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(x, out, m, n, delta, col_tiles);
  } else {
    lorenzo2d_kernel<1><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(x, out, m, n, delta, col_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lorenzo3d_encode(const float* x, int32_t* out, int64_t nz,
                                int64_t m, int64_t n, float eb, void* stream) {
  if (nz <= 0 || m <= 0 || n <= 0) return 0;
  const float delta = 2.0f * eb;
  const bool vec = rows_of_16_bytes(x, out, n);
  const int64_t strips = ((vec ? n / 4 : n) + 31) / 32;
  const int64_t row_tiles = (m + kRows3D - 1) / kRows3D;
  const int64_t blocks = strips * row_tiles * ((nz + kRun3D - 1) / kRun3D);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 threads(32, kRows3D + 1);
  if (vec) {
    lorenzo3d_kernel<4><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        x, out, nz, m, n, delta, strips, row_tiles);
  } else {
    lorenzo3d_kernel<1><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        x, out, nz, m, n, delta, strips, row_tiles);
  }
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
