// Continuous fast-mode rotation for Hopper: the centered quarter-turn select
// (K5) and the three-shear residual rotation (K6).
//
// Replaces the Pallas TPU kernels in equiadapt_tpu/ops/pallas/shear_rotate.py:
//   K5  pallas_rot90_centered_select (_centered_select_kernel)
//       z[b] = rot90^{k[b]}(x[b]) about the integer centre (W//2, H//2):
//       out[i, j] = rot90^k(x)[i + sy_k, j + sx_k], the shift edge-clamped
//       ("border") or zero-filled ("zeros");
//   K6  shear_rotate_residual (_make_kernel, _shear_kernel_body)
//       rotation by r[b] in [-45, 45] degrees as Sx(alpha) Sy(beta) Sx(alpha),
//       alpha = -tan(r/2), beta = sin(r), each a 1-D linear shear.
// The TPU kernels route data with exchange matmuls and masked lane rolls;
// here K5 copies words or shared-memory tiles and K6 addresses its taps
// directly.
//
// Layout: NHWC, C innermost, square planes for K5. Both kernels compute in
// fp32 and write the output dtype (float32 or bfloat16).
//
// K5: rot90 follows numpy/torch rot90 over (H, W) (counter-clockwise):
//   k = 1: z[i, j] = x[j, N-1-i];  k = 2: z[i, j] = x[N-1-i, N-1-j];
//   k = 3: z[i, j] = x[N-1-j, i].
// The per-k shifts come from the host (shear_rotate.py::_centered_shifts).
// k is taken as k & 3 (floor mod 4), so any index gives an in-range address.
// Each output element is a copy of one input element, moved as raw bits, or
// +0: the kernel is bit-equal to its plain version, NaN payloads and -0.0
// included. The index map (`QuarterTurn`) and the three launch paths (word,
// and the shared-memory tiles for C <= 4 and for other C) live in
// quarter_turn.cuh, which K3 (select_warp.cu) shares; the wrapper
// (shear_rotate.py::_select_path) chooses the path from C, the dtype and
// the alignment. No thread divides by C.
//
// K6: one launch per shear pass. Per pass, for the coordinate `var` the
// shift varies along (rows about cy for the x-shear, columns about cx for
// the y-shear): d = slope * (var - centre), k = floor(d), f = d - k, and
// out = (1 - f) * t0 + f * t1 with t0 = in[pix + k], t1 = in[pix + k + 1]
// along the shear axis; out-of-range taps take the edge value ("border")
// or 0 ("zeros") of that pass's input. The wrapper runs three launches
// through fp32 scratch buffers: the intermediate between passes stays fp32
// and only the last pass writes the output dtype. All arithmetic is
// __fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA and the
// kernel is bit-equal to its plain version given the same (alpha, beta).
// Non-finite fence: a NaN or infinite shift gives f = NaN (a NaN pixel)
// and a tap address of pix + 0; finite shifts are clamped to
// [-(size+1), size+1] before the integer conversion, which leaves every
// out-of-range tap out of range.
//
// Bound: both are streaming passes; the least traffic is one read of the
// input and one write of the output, 2 * B * H * W * C * sizeof(T) bytes over
// the card's memory bandwidth (H100 SXM: 3.35 TB/s). At the main-path shapes
// (256, 224, 224, 3) and (256, 224, 224, 16) bf16 that is 0.046 and 0.245 ms.
// K5 meets that traffic (one read, one write per element: a tile's source box
// is its own pixels, clamped); what it spends beyond it goes to the index
// work of each element and, on the tile path, the staging instructions. K6's three
// passes move 2 + 4 (pass 1), 4 + 4 (pass 2) and 4 + 2 (pass 3) bytes per
// bf16 element, 5x the bound's 4: the simple design. Keeping a (b, c) plane
// resident in shared memory across the three passes is the later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

#include "quarter_turn.cuh"

namespace {

constexpr int kThreads = 256;

// false for NaN and +-inf (IEEE comparisons: no fast-math)
__device__ __forceinline__ bool finite(float v) { return fabsf(v) <= FLT_MAX; }

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One shear pass; grid (ceil(W*C / kThreads), H, B). axis 1: x-shear, shift
// along W varying with the row h about `centre`; axis 0: y-shear, shift along
// H varying with the column w. coef is the (B, 2) (alpha, beta) table.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
shear_pass_kernel(const Tin* __restrict__ in, Tout* __restrict__ out,
                  const float* __restrict__ coef, int which, int axis,
                  float centre, int zeros, int H, int W, int C) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= W * C) return;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int w = r / C;
  const int c = r - w * C;
  const float slope = coef[2 * b + which];
  const int var = axis == 1 ? h : w;
  const int pix = axis == 1 ? w : h;
  const int size = axis == 1 ? W : H;
  const float d = __fmul_rn(slope, __fsub_rn(static_cast<float>(var), centre));
  const float fl = floorf(d);
  const float f = __fsub_rn(d, fl);
  const float lim = static_cast<float>(size + 1);
  const int k = finite(fl) ? static_cast<int>(fminf(fmaxf(fl, -lim), lim)) : 0;
  const size_t img = static_cast<size_t>(b) * H;
  float t[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int s = pix + k + q;
    if (s < 0 || s >= size) {
      if (zeros) {
        t[q] = 0.0f;
        continue;
      }
      s = min(max(s, 0), size - 1);
    }
    const size_t at = axis == 1
        ? ((img + h) * W + s) * C + c
        : ((img + s) * W + w) * C + c;
    t[q] = load(in + at);
  }
  const float v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), t[0]), __fmul_rn(f, t[1]));
  store(out + ((img + h) * W + w) * C + c, v);
}

template <typename Tin, typename Tout>
int shear_pass(const void* in, void* out, const float* coef, int which,
               int axis, float centre, int zeros, int B, int H, int W, int C,
               cudaStream_t stream) {
  const dim3 grid((W * C + kThreads - 1) / kThreads, H, B);
  shear_pass_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(in), static_cast<Tout*>(out), coef, which, axis,
      centre, zeros, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int shear_rotate(const void* z, void* out, void* s0, void* s1,
                 const float* coef, int B, int H, int W, int C, float cx,
                 float cy, int zeros, cudaStream_t st) {
  int err = shear_pass<T, float>(z, s0, coef, 0, 1, cy, zeros, B, H, W, C, st);
  if (err != 0) return err;
  err = shear_pass<float, float>(s0, s1, coef, 1, 0, cx, zeros, B, H, W, C, st);
  if (err != 0) return err;
  return shear_pass<float, T>(s1, out, coef, 0, 1, cy, zeros, B, H, W, C, st);
}

bool grid_ok(int B, int H, int W, int C) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 1 && B <= 65535 && H <= 65535 &&
         static_cast<long long>(W) * C < (1LL << 31) - kThreads;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. shifts: host array {sy0..sy3, sx0..sx3}.
// path: 1 = word (C * sizeof(T) a multiple of 16, x and out 16-byte
// aligned), 0 = tile. Returns the cudaError_t of the launch (0 on success).
extern "C" int eqt_rot90_centered_select(int dtype, const void* x, void* out,
                                         const int* k_idx, const int* shifts,
                                         int zeros, int B, int N, int C,
                                         int path, void* stream) {
  if (!grid_ok(B, N, N, C) || static_cast<long long>(N) * N * C >= (1LL << 31) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shifts s;
  for (int q = 0; q < 4; ++q) {
    s.sy[q] = shifts[q];
    s.sx[q] = shifts[4 + q];
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int bytes = dtype == 0 ? 4 : 2;
  const void* src[1] = {x};
  if (path == 0) {
    return dtype == 0
        ? rot90_tile(images<unsigned int>(src, 1, nullptr), out, k_idx, s,
                     zeros, B, N, C, st)
        : rot90_tile(images<unsigned short>(src, 1, nullptr), out, k_idx, s,
                     zeros, B, N, C, st);
  }
  if (path != 1 || (C * bytes) % 16 != 0 ||
      reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rot90_words(images<uint4>(src, 1, nullptr), out, k_idx, s, zeros,
                     B, N, C * bytes / 16, st);
}

// Three passes z -> scratch0 -> scratch1 -> out; scratch buffers are fp32
// (B, H, W, C); coef is the device (B, 2) fp32 (alpha, beta) table.
extern "C" int eqt_shear_rotate_residual(int dtype, const void* z, void* out,
                                         void* scratch0, void* scratch1,
                                         const float* coef, int B, int H, int W,
                                         int C, float cx, float cy, int zeros,
                                         void* stream) {
  if (!grid_ok(B, H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return shear_rotate<float>(z, out, scratch0, scratch1, coef, B, H, W, C, cx,
                               cy, zeros, st);
  }
  if (dtype == 1) {
    return shear_rotate<__nv_bfloat16>(z, out, scratch0, scratch1, coef, B, H,
                                       W, C, cx, cy, zeros, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
