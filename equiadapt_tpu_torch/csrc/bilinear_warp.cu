// Exact per-sample bilinear rotation warp (K7) for Hopper.
//
// Replaces the Pallas TPU kernel equiadapt_tpu/ops/pallas/bilinear_warp.py
// (_warp_exact_call, built by _make_kernel):
//   out(p) = x(R^{-1} (p - c) + c),  c = (H//2, W//2),
// direct 4-tap bilinear sampling with "border" (taps clamped to the edge) or
// "zeros" (out-of-range taps weigh 0) padding. The TPU kernel restructures the
// gather as band matmuls on the MXU; here each thread owns one output pixel
// (b, i, j), forms its sample point and reads its four taps directly, for all
// C channels.
//
// Numerics follow the plain version (bilinear_warp.py::_warp_center_affine ->
// ops/warp.py::bilinear_sample) operation by operation: the inverse-matrix
// table (i00, i01, i10, i11) comes from the host, computed by the same
// PyTorch code; sx = (i00 * dx + i01 * dy) + cx and sy likewise, dx = j - cx,
// dy = i - cy (the centre's x is H//2 and its y W//2, the reference's
// convention; equal on square images); the weights (1-fx)(1-fy), fx(1-fy),
// (1-fx)fy, fx fy, times the 0/1 validity in "zeros" mode; the taps summed in
// that order. All arithmetic is __fmul_rn / __fadd_rn, so nvcc contracts
// nothing into an FMA and the kernel is bit-equal to the plain version.
// Non-finite fence: a NaN or infinite coefficient gives NaN weights and so a
// NaN pixel, and its tap address is built from 0, never from int(NaN);
// finite floors are clamped to [-2, size + 1] first, which keeps every
// out-of-range tap out of range.
//
// Bound: one read of the input and one write of the output,
// 2 * B * H * W * C * sizeof(T) bytes over the card's memory bandwidth
// (H100 SXM: 3.35 TB/s): 0.092 ms at (256, 224, 224, 3) fp32 and 0.49 ms at
// (256, 224, 224, 16) fp32. A rotation's taps of neighbouring output pixels
// are neighbouring input pixels, so the four tap reads of a warp mostly hit
// the same sectors and the L2 cache; the channel loop reads and writes C
// scalars per thread (no vector accesses yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// floor(s) as an address-safe integer: 0 for non-finite s
__device__ __forceinline__ int tap_index(float fl, int size) {
  return finite(fl)
      ? static_cast<int>(fminf(fmaxf(fl, -2.0f), static_cast<float>(size + 1)))
      : 0;
}

// grid (ceil(W / kThreads), H, B): one thread per output pixel (b, i, j)
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_exact_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const float* __restrict__ tab, int zeros, int H, int W,
                  int C) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W) return;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const float i00 = tab[4 * b], i01 = tab[4 * b + 1];
  const float i10 = tab[4 * b + 2], i11 = tab[4 * b + 3];
  const float cx = static_cast<float>(H / 2);
  const float cy = static_cast<float>(W / 2);
  const float dx = __fsub_rn(static_cast<float>(j), cx);
  const float dy = __fsub_rn(static_cast<float>(i), cy);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(i00, dx), __fmul_rn(i01, dy)), cx);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(i10, dx), __fmul_rn(i11, dy)), cy);
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0);
  const float fy = __fsub_rn(sy, y0);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  float w[4] = {__fmul_rn(gx, gy), __fmul_rn(fx, gy), __fmul_rn(gx, fy),
                __fmul_rn(fx, fy)};
  const int xi0 = tap_index(x0, W);
  const int yi0 = tap_index(y0, H);
  size_t at[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int xi = xi0 + (t & 1);
    const int yi = yi0 + (t >> 1);
    if (zeros) {
      const bool valid = xi >= 0 && xi <= W - 1 && yi >= 0 && yi <= H - 1;
      w[t] = __fmul_rn(w[t], valid ? 1.0f : 0.0f);
    }
    const int xc = min(max(xi, 0), W - 1);
    const int yc = min(max(yi, 0), H - 1);
    at[t] = ((static_cast<size_t>(b) * H + yc) * W + xc) * C;
  }
  T* o = out + ((static_cast<size_t>(b) * H + i) * W + j) * C;
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(load(x + at[0] + c), w[0]);
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(load(x + at[t] + c), w[t]));
    }
    store(o + c, acc);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; tab: device (B, 4) fp32 inverse-matrix
// table. Returns the cudaError_t of the launch (0 on success).
extern "C" int eqt_warp_rotate_center_exact(int dtype, const void* x, void* out,
                                            const float* tab, int zeros, int B,
                                            int H, int W, int C, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    warp_exact_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), tab, zeros, H,
        W, C);
  } else if (dtype == 1) {
    warp_exact_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        tab, zeros, H, W, C);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
