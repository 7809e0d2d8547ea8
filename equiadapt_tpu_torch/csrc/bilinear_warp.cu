// Exact per-sample bilinear rotation warp (K7) for Hopper.
//
// Replaces the Pallas TPU kernel equiadapt_tpu/ops/pallas/bilinear_warp.py
// (_warp_exact_call, built by _make_kernel):
//   out(p) = x(R^{-1} (p - c) + c),  c = (H//2, W//2),
// direct 4-tap bilinear sampling with "border" (taps clamped to the edge) or
// "zeros" (out-of-range taps weigh 0) padding. The TPU kernel restructures the
// gather as band matmuls on the MXU; here each output pixel forms its sample
// point and reads its four taps directly.
//
// Numerics follow the plain version (bilinear_warp.py::_warp_center_affine ->
// ops/warp.py::bilinear_sample) operation by operation: the inverse-matrix
// table (i00, i01, i10, i11) = (r11, -r01, -r10, r00) / det, det = r00 r11 -
// r01 r10, computed on the device by `inverse_kernel` in the order of
// bilinear_warp.py::_inverse_coefficients; sx = (i00 * dx + i01 * dy) + cx
// and sy likewise, dx = j - cx, dy = i - cy (the centre's x is H//2 and its y
// W//2, the reference's convention; equal on square images); the weights
// (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy, times the 0/1 validity in "zeros"
// mode; the taps summed in that order, per channel. All arithmetic is
// __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc contracts nothing into an FMA and
// the kernel is bit-equal to the plain version. Non-finite fence: a NaN or
// infinite coefficient gives NaN weights and so a NaN pixel, and its tap
// address is built from 0, never from int(NaN); finite floors are clamped to
// [-2, size + 1] first, which keeps every out-of-range tap out of range.
//
// Bound: one read of the input and one write of the output,
// 2 * B * H * W * C * sizeof(T) bytes over the card's memory bandwidth
// (H100 SXM: 3.35 TB/s): 0.092 ms at (256, 224, 224, 3) fp32 and 0.49 ms at
// (256, 224, 224, 16) fp32. The four taps of neighbouring output pixels are
// neighbouring input pixels, so the tap re-reads mostly hit L1 and L2; what
// limits the kernel is the number of cache lines a warp's tap load touches
// (its L1 wavefronts), not device memory.
//
// Design. Two paths, chosen by the wrapper (ops/kernels/bilinear_warp.py::
// _path) from C, the dtype and the alignment:
//   word (C * sizeof(T) a multiple of 16 and both pointers 16-byte aligned;
//     C = 16 on the main path): threads move 16-byte words of V = 4 fp32 or
//     8 bf16 channels. A block is a 2-D thread map (words of a pixel,
//     pixels): threadIdx.x is the word within the pixel and threadIdx.y the
//     pixel, so consecutive lanes take consecutive words of consecutive
//     output pixels, each tap load is one 16-byte access a lane, and a warp
//     stores contiguous bytes (at C = 16 fp32, 8 whole pixels, 512 bytes).
//     The pixels of a block run along the flattened H * W plane of one
//     sample, so a row's end idles no lane (224 * 224 is a multiple of 64
//     and of 128). Each thread recomputes its pixel's sample point: a few
//     fp32 operations, fewer registers than sharing it.
//   element (every other case; C = 3 on the main path): for C <= 4 a thread
//     a pixel of a 16 x 16 output tile, C a template parameter, each warp an
//     8 x 4 patch (`warp_pixel_kernel`); the tile goes out through shared
//     memory, consecutive threads on consecutive elements. For C > 4 the
//     2-D thread map above with V = 1 (one element a thread).
// No thread divides by C.
//
// Designs tried for the element path at C = 3, slowest first (PERF.md has
// their times): one thread an element by the 2-D map; the tile's source box
// staged in shared memory (its prologue and staging cost more instructions
// than the cache lines they save); a thread a pixel along the flattened
// plane; the 8 x 4 patches kept here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive channels, aligned to their size: one 16-byte access for
// V * sizeof(T) = 16, one scalar access for V = 1
template <typename T, int V>
struct alignas(sizeof(T) * V) Unit {
  T v[V];
};

// floor(s) as an address-safe integer: 0 for non-finite s
__device__ __forceinline__ int tap_index(float fl, int size) {
  return finite(fl)
      ? static_cast<int>(fminf(fmaxf(fl, -2.0f), static_cast<float>(size + 1)))
      : 0;
}

// (B, 4) inverse-matrix table [i00, i01, i10, i11] of the (B, 2, 2) fp32
// matrices R by the adjugate over the determinant, in the plain version's
// order (bilinear_warp.py::_inverse_coefficients): one thread per sample.
__global__ void inverse_kernel(const float* __restrict__ R,
                               float* __restrict__ tab, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float r00 = R[4 * b], r01 = R[4 * b + 1];
  const float r10 = R[4 * b + 2], r11 = R[4 * b + 3];
  const float det = __fsub_rn(__fmul_rn(r00, r11), __fmul_rn(r01, r10));
  tab[4 * b] = __fdiv_rn(r11, det);
  tab[4 * b + 1] = __fdiv_rn(-r01, det);
  tab[4 * b + 2] = __fdiv_rn(-r10, det);
  tab[4 * b + 3] = __fdiv_rn(r00, det);
}

// The sample point of output pixel (i, j) of sample b: sx (column) and sy
// (row), in the plain version's operation order.
struct SamplePoint {
  float sx, sy;
  __device__ __forceinline__ SamplePoint(const float* __restrict__ tab, int b,
                                         int i, int j, int H, int W) {
    const float i00 = tab[4 * b], i01 = tab[4 * b + 1];
    const float i10 = tab[4 * b + 2], i11 = tab[4 * b + 3];
    const float cx = static_cast<float>(H / 2);
    const float cy = static_cast<float>(W / 2);
    const float dx = __fsub_rn(static_cast<float>(j), cx);
    const float dy = __fsub_rn(static_cast<float>(i), cy);
    sx = __fadd_rn(__fadd_rn(__fmul_rn(i00, dx), __fmul_rn(i01, dy)), cx);
    sy = __fadd_rn(__fadd_rn(__fmul_rn(i10, dx), __fmul_rn(i11, dy)), cy);
  }
};

// The four taps of a sample point: weights (times the 0/1 validity in
// "zeros" mode) and clamped addresses, in the order (x0, y0), (x1, y0),
// (x0, y1), (x1, y1).
struct Taps {
  float w[4];
  int xc[4], yc[4];
  __device__ __forceinline__ Taps(const SamplePoint& p, int zeros, int H, int W) {
    const float x0 = floorf(p.sx);
    const float y0 = floorf(p.sy);
    const float fx = __fsub_rn(p.sx, x0);
    const float fy = __fsub_rn(p.sy, y0);
    const float gx = __fsub_rn(1.0f, fx);
    const float gy = __fsub_rn(1.0f, fy);
    w[0] = __fmul_rn(gx, gy);
    w[1] = __fmul_rn(fx, gy);
    w[2] = __fmul_rn(gx, fy);
    w[3] = __fmul_rn(fx, fy);
    const int xi0 = tap_index(x0, W);
    const int yi0 = tap_index(y0, H);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xi = xi0 + (t & 1);
      const int yi = yi0 + (t >> 1);
      if (zeros) {
        const bool valid = xi >= 0 && xi <= W - 1 && yi >= 0 && yi <= H - 1;
        w[t] = __fmul_rn(w[t], valid ? 1.0f : 0.0f);
      }
      xc[t] = min(max(xi, 0), W - 1);
      yc[t] = min(max(yi, 0), H - 1);
    }
  }
};

// One output channel from its four tap values, in the plain version's order.
__device__ __forceinline__ float blend(const float v[4], const float w[4]) {
  float acc = __fmul_rn(v[0], w[0]);
#pragma unroll
  for (int t = 1; t < 4; ++t) acc = __fadd_rn(acc, __fmul_rn(v[t], w[t]));
  return acc;
}

// Word path and the element path's C > 4 case. grid (ceil(H * W /
// blockDim.y), B), block (units per pixel (capped), pixels).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
warp_exact_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const float* __restrict__ tab, int zeros, int H, int W,
                  int units) {
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= H * W) return;
  const int i = p / W;
  const int j = p - i * W;
  const int b = blockIdx.y;
  const Taps taps(SamplePoint(tab, b, i, j, H, W), zeros, H, W);
  using U = Unit<T, V>;
  const U* __restrict__ src = reinterpret_cast<const U*>(x);
  size_t at[4];  // in units
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    at[t] = ((static_cast<size_t>(b) * H + taps.yc[t]) * W + taps.xc[t]) * units;
  }
  U* o = reinterpret_cast<U*>(out) +
         ((static_cast<size_t>(b) * H + i) * W + j) * units;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    U tap[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) tap[t] = src[at[t] + u];
    U r;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = to_float(tap[t].v[c]);
      r.v[c] = from_float<T>(blend(v, taps.w));
    }
    o[u] = r;
  }
}

constexpr int kSide = 16;  // output tile side of the element path, C <= 4

// Element path, C <= 4. grid (ceil(W / kSide), ceil(H / kSide), B): one
// thread per pixel of a 16 x 16 output tile, each warp an 8 x 4 patch of it,
// so that a tap load of a warp, rotated into the source, touches a few short
// row segments instead of one long diagonal. A thread forms its pixel's
// sample point once and blends its C channels from the four taps; the block
// stages the tile in shared memory and writes its rows (16 * C contiguous
// elements each) with consecutive threads on consecutive elements. C is a
// template parameter, so nothing divides by a runtime value.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
warp_pixel_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const float* __restrict__ tab, int zeros, int H, int W) {
  static_assert(kSide * kSide == kThreads, "a thread a pixel of the tile");
  // raw storage: a __shared__ array of T would need T's constructor
  __shared__ __align__(16) unsigned char stage_raw[kThreads * C * sizeof(T)];
  T* stage = reinterpret_cast<T*>(stage_raw);
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kSide;
  const int j0 = blockIdx.x * kSide;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ti = (warp / 2) * 4 + lane / 8;
  const int tj = (warp % 2) * 8 + lane % 8;
  const size_t plane = static_cast<size_t>(b) * H * W * C;
  if (i0 + ti < H && j0 + tj < W) {
    const Taps taps(SamplePoint(tab, b, i0 + ti, j0 + tj, H, W), zeros, H, W);
    const T* __restrict__ src = x + plane;
    int at[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) at[t] = (taps.yc[t] * W + taps.xc[t]) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = to_float(src[at[t] + c]);
      stage[(ti * kSide + tj) * C + c] = from_float<T>(blend(v, taps.w));
    }
  }
  __syncthreads();
  const int h = min(kSide, H - i0);
  const int w = min(kSide, W - j0);
  T* o = out + plane + (static_cast<size_t>(i0) * W + j0) * C;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e / (kSide * C);
    const int k = e - r * (kSide * C);
    if (r < h && k < w * C) o[static_cast<size_t>(r) * W * C + k] = stage[e];
  }
}

template <typename T, int V>
int launch(const void* x, void* out, const float* tab, int zeros, int B,
           int H, int W, int C, cudaStream_t st) {
  const int units = C / V;
  const int per_pixel = min(units, 32);
  const dim3 block(per_pixel, kThreads / per_pixel);
  const long long pixels = static_cast<long long>(H) * W;
  const long long blocks = (pixels + block.y - 1) / block.y;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), B);
  warp_exact_kernel<T, V><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), tab, zeros, H, W, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_pixel(const void* x, void* out, const float* tab, int zeros,
                 int B, int H, int W, cudaStream_t st) {
  const dim3 grid((W + kSide - 1) / kSide, (H + kSide - 1) / kSide, B);
  warp_pixel_kernel<T, C><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), tab, zeros, H, W);
  return static_cast<int>(cudaGetLastError());
}

// the element path: a thread a pixel for C <= 4, the 2-D thread map above
// (a thread an element) otherwise
template <typename T>
int launch_element(const void* x, void* out, const float* tab, int zeros,
                   int B, int H, int W, int C, cudaStream_t st) {
  switch (C) {
    case 1: return launch_pixel<T, 1>(x, out, tab, zeros, B, H, W, st);
    case 2: return launch_pixel<T, 2>(x, out, tab, zeros, B, H, W, st);
    case 3: return launch_pixel<T, 3>(x, out, tab, zeros, B, H, W, st);
    case 4: return launch_pixel<T, 4>(x, out, tab, zeros, B, H, W, st);
    default: return launch<T, 1>(x, out, tab, zeros, B, H, W, C, st);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; R: device (B, 2, 2) fp32 matrices; tab:
// device (B, 4) fp32 scratch for their inverse table; path: 1 = word
// (C * sizeof(T) a multiple of 16, x and out 16-byte aligned), 0 = element.
// Two launches: the inverse table, then the warp. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int eqt_warp_rotate_center_exact(int dtype, const void* x, void* out,
                                            const float* R, float* tab,
                                            int zeros, int B, int H, int W,
                                            int C, int path, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || B > 65535 ||
      static_cast<long long>(H) * W * C >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  inverse_kernel<<<(B + 127) / 128, 128, 0, st>>>(R, tab, B);
  if (path == 1) {
    const int bytes = dtype == 0 ? 4 : 2;
    if ((C * bytes) % 16 != 0 || reinterpret_cast<size_t>(x) % 16 != 0 ||
        reinterpret_cast<size_t>(out) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (path != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return path ? launch<float, 4>(x, out, tab, zeros, B, H, W, C, st)
                : launch_element<float>(x, out, tab, zeros, B, H, W, C, st);
  }
  if (dtype == 1) {
    return path ? launch<__nv_bfloat16, 8>(x, out, tab, zeros, B, H, W, C, st)
                : launch_element<__nv_bfloat16>(x, out, tab, zeros, B, H, W, C, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
