// Multi-scale RoIAlign (torchvision's roi_align, aligned=False) over up to
// four pyramid levels in one launch, fp32 or bf16 maps, for Hopper.
//
// Replaces no TPU kernel: the JAX package pools no regions. Mask R-CNN's
// box branch pools 1,000 regions an image at 7 x 7 and its mask branch 100
// at 14 x 14, each region from the one FPN level its size picks, so one
// launch takes every region of a batch and every level: a region carries
// its image and level, and each level its pointer, strides, size and scale.
//
// Bound. Each output value is the mean of S x S bilinear samples (S = 2),
// four taps each: 16 loads for one store, gathered at positions that depend
// on the data. At the cell's shape (8,000 regions x 49 bins x 256 channels,
// bf16) the taps name 3.2 GB if none were shared, but neighbouring samples
// share most taps, so the maps' distinct pixels bound the traffic from
// memory; what the kernel can do is read each tap as part of a whole row of
// channels and keep the sample arithmetic off the critical path.
//
// Design. A block owns one output row (region r, bin row ph) and walks its
// P bins; a thread owns channels c, c + 256, ... The sample positions and
// weights of the row (S y-samples, P x S x-samples) are computed once into
// shared memory with torchvision's arithmetic in fp32 (each operation
// rounded on its own, `__fadd_rn` and friends, so that positions are
// bit-equal to PyTorch's elementwise ones); each tap is then one load a
// channel: on channels-last maps (the FPN's) a warp reads 32 consecutive
// channels of one pixel. The sum of a bin is fp32, the store in the maps'
// dtype. Any strides are read (64-bit offsets); the output is written by
// strides too (the wrapper makes it channels-last, so a warp's stores are
// contiguous).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;
constexpr int kMaxP = 32;
constexpr int kMaxS = 8;

struct Level {
  const void* data;
  long long sb, sc, sy, sx;
  int H, W;
  float scale;
};

struct Levels {
  Level l[kMaxLevels];
};

// a level by index without indexing the parameter array at run time (which
// would copy it to the stack)
__device__ __forceinline__ Level pick(const Levels& ls, int i) {
  Level out = ls.l[0];
  if (i == 1) out = ls.l[1];
  if (i == 2) out = ls.l[2];
  if (i == 3) out = ls.l[3];
  return out;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one sample's taps and weights along one axis: start + p bin + (i + .5) bin / S,
// zero weights outside [-1, size], clamped below at 0 and above at the last row
__device__ __forceinline__ void axis(float start, float bin, int p, int i, int S, int size,
                                     int* lo, int* hi, float* wl, float* wh) {
  float pos = __fadd_rn(__fadd_rn(start, __fmul_rn(static_cast<float>(p), bin)),
                        __fdiv_rn(__fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), bin),
                                  static_cast<float>(S)));
  const bool inside = pos >= -1.f && pos <= static_cast<float>(size);
  pos = fmaxf(pos, 0.f);
  int l = static_cast<int>(pos);
  int h = l + 1;
  if (l >= size - 1) {
    l = size - 1;
    h = l;
    pos = static_cast<float>(l);
  }
  const float f = __fsub_rn(pos, static_cast<float>(l));
  *lo = l;
  *hi = h;
  *wl = inside ? __fsub_rn(1.f, f) : 0.f;
  *wh = inside ? f : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    roi_align_kernel(Levels levels, const float4* __restrict__ boxes,
                     const int* __restrict__ batch, const int* __restrict__ level,
                     T* __restrict__ out, long long o_r, long long o_c, long long o_y,
                     long long o_x, int C, int P, int S) {
  __shared__ int xlo[kMaxP * kMaxS], xhi[kMaxP * kMaxS];
  __shared__ float xwl[kMaxP * kMaxS], xwh[kMaxP * kMaxS];
  __shared__ int ylo[kMaxS], yhi[kMaxS];
  __shared__ float ywl[kMaxS], ywh[kMaxS];

  const long long r = blockIdx.x;
  const int ph = blockIdx.y;
  const float4 box = boxes[r];
  const Level L = pick(levels, level[r]);
  const long long b = batch[r];

  const float xs = __fmul_rn(box.x, L.scale);
  const float xbin = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(box.z, L.scale), xs), 1.f),
                               static_cast<float>(P));
  const float ys = __fmul_rn(box.y, L.scale);
  const float ybin = __fdiv_rn(fmaxf(__fsub_rn(__fmul_rn(box.w, L.scale), ys), 1.f),
                               static_cast<float>(P));
  for (int t = threadIdx.x; t < P * S; t += blockDim.x) {
    axis(xs, xbin, t / S, t % S, S, L.W, &xlo[t], &xhi[t], &xwl[t], &xwh[t]);
  }
  if (threadIdx.x < S) {
    const int t = threadIdx.x;
    axis(ys, ybin, ph, t, S, L.H, &ylo[t], &yhi[t], &ywl[t], &ywh[t]);
  }
  __syncthreads();

  const T* base = static_cast<const T*>(L.data) + b * L.sb;
  const float inv = 1.f / static_cast<float>(S * S);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T* plane = base + static_cast<long long>(c) * L.sc;
    T* dst = out + r * o_r + static_cast<long long>(c) * o_c + ph * o_y;
    for (int pw = 0; pw < P; ++pw) {
      float acc = 0.f;
      for (int iy = 0; iy < S; ++iy) {
        const T* row_lo = plane + ylo[iy] * L.sy;
        const T* row_hi = plane + yhi[iy] * L.sy;
        const float wyl = ywl[iy], wyh = ywh[iy];
        for (int ix = 0; ix < S; ++ix) {
          const int s = pw * S + ix;
          const long long a = xlo[s] * L.sx, e = xhi[s] * L.sx;
          const float wxl = xwl[s], wxh = xwh[s];
          const float val = wyl * wxl * to_float(row_lo[a]) + wyl * wxh * to_float(row_lo[e]) +
                            wyh * wxl * to_float(row_hi[a]) + wyh * wxh * to_float(row_hi[e]);
          acc += val;
        }
      }
      store(dst + pw * o_x, acc * inv);
    }
  }
}

template <typename T>
int launch(const Levels& levels, const void* boxes, const void* batch, const void* level,
           void* out, const long long* os, int R, int C, int P, int S, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(P));
  roi_align_kernel<T><<<grid, kThreads, 0, stream>>>(
      levels, static_cast<const float4*>(boxes), static_cast<const int*>(batch),
      static_cast<const int*>(level), static_cast<T*>(out), os[0], os[1], os[2], os[3], C, P,
      S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maps: L pointers; strides: 4 a level (b, c, y, x, in elements); sizes: H, W a
// level; scales: one a level. boxes (R, 4) fp32, batch and level (R,) int32,
// out_strides (r, c, ph, pw). dtype 0 = float32, 1 = bfloat16.
extern "C" int eqt_roi_align(const void* const* maps, const long long* strides,
                             const int* sizes, const float* scales, int L, const void* boxes,
                             const void* batch, const void* level, void* out,
                             const long long* out_strides, int R, int C, int P, int S,
                             int dtype, void* stream) {
  if (L < 1 || L > kMaxLevels || R < 1 || C < 1 || P < 1 || P > kMaxP || S < 1 ||
      S > kMaxS || R > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels;
  std::memset(&levels, 0, sizeof levels);
  for (int i = 0; i < L; ++i) {
    Level& v = levels.l[i];
    v.data = maps[i];
    v.sb = strides[4 * i];
    v.sc = strides[4 * i + 1];
    v.sy = strides[4 * i + 2];
    v.sx = strides[4 * i + 3];
    v.H = sizes[2 * i];
    v.W = sizes[2 * i + 1];
    v.scale = scales[i];
    if (v.H < 1 || v.W < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(levels, boxes, batch, level, out, out_strides, R, C, P, S, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(levels, boxes, batch, level, out, out_strides, R, C, P, S, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
