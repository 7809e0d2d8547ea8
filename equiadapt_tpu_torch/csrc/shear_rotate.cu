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
// K6: Sx(alpha) Sy(beta) Sx(alpha) of each (b, c) plane. Per pass, for the
// coordinate `var` the shift varies along (rows about cy for the x-shear,
// columns about cx for the y-shear): d = slope * (var - centre),
// k = floor(d), f = d - k, and out = (1 - f) * t0 + f * t1 with
// t0 = in[pix + k], t1 = in[pix + k + 1] along the shear axis; out-of-range
// taps take the edge value ("border") or 0 ("zeros") of that pass's input.
// The intermediates stay fp32 and only the last pass writes the output
// dtype. All arithmetic is __fmul_rn / __fadd_rn, so nvcc contracts nothing
// into an FMA and the kernel is bit-equal to its plain version given the
// same (alpha, beta). Non-finite fence: a NaN or infinite shift gives
// f = NaN (a NaN pixel) and a tap address of pix + 0; finite shifts are
// clamped to [-(size+1), size+1] before the integer conversion, which
// leaves every out-of-range tap out of range.
//
// Bound: the least traffic is one read of the input and one write of the
// output, 2 * B * H * W * C * sizeof(T) bytes over the card's memory
// bandwidth (H100 SXM: 3.35 TB/s): 0.046 and 0.245 ms at the main-path
// shapes (256, 224, 224, 3) and (256, 224, 224, 16) bf16. K5 meets that
// traffic (one read, one write per element: a tile's source box is its own
// pixels, clamped); what it spends beyond it goes to the index work of each
// element and, on the tile path, the staging instructions.
//
// K6's first design ran three launches through two fp32 scratch copies of
// the batch (20 bytes moved per bf16 element against the bound's 4), one
// element a thread with a runtime division by C, the shift recomputed per
// element, and took the same time in bf16 as in fp32: 7% of the bound's
// rate. The resident path (`shear_resident_kernel`) is one launch with no
// scratch:
//   - a block owns one (b, c) plane in dynamic shared memory, fp32, rows
//     `pitch` = W | 1 floats apart (odd, so that a warp walking a column
//     touches 32 banks): 224 x 225 x 4 = 201,600 of the 232,448 bytes a
//     block may opt into, so one block an SM, 1024 threads;
//   - NHWC interleaves the channels: one channel of a 16-channel bf16
//     pixel is 2 of its 32 bytes. The blocks of a thread-block cluster own
//     consecutive channels of one sample, CS of them: one 16-byte word of
//     channels (8 bf16, 4 fp32) where that divides C, else the whole pixel
//     (C <= 8), else the largest divisor of C up to 8. A thread of the
//     cluster loads the run of CS channels of each of its pixels (16-byte
//     words where the pixel is whole words and the pointers aligned) and
//     scatters the channels into the cluster's planes through distributed
//     shared memory; the write gathers them back the same way. With CS = 1
//     a block reads its own channel and L2 serves the 16x over-read: 1.9x
//     slower at C = 16 bf16;
//   - pass 1 runs while the plane is loaded (each pixel's two taps read
//     from device memory, the row's shift formed once a pixel);
//   - passes 2 and 3 run in place, a warp a column, then a warp a row
//     (`shear_line`): lanes take 32 elements a chunk, the chunks walked
//     upwards for k >= 0 and downwards for k < 0, so that a chunk reads
//     only elements that no earlier chunk has written (a clamped "border"
//     tap reads the edge, which is written last); the chunks whose taps all
//     lie in the line run four at a time, loads before stores, with no
//     clamp; the plane is indexed by 32-bit offsets (a pointer into it cost
//     a generic-to-shared conversion, a read of the cluster CTA id, each
//     access);
//   - the plane is written once, in the output dtype.
// What bounds it now: a block's phases run in turn on its SM, one block an
// SM, and nothing overlaps them. Per-phase device timestamps of a block at
// (256, 224, 224, 16) bf16 (H100 SXM): load + pass 1 9 us, pass 2 10 us,
// pass 3 7 us, write 13 us, cluster barriers 3 us; 34 waves of 120 blocks
// (clusters of 8 fill 120 of the 132 SMs). The loads and the write move
// their bytes at about half the card's rate while the passes leave device
// memory idle.
// Planes over the shared-memory limit (H * (W | 1) * 4 > 232,448 bytes:
// about 241^2 and above) keep the three-pass kernel (`shear_pass_kernel`,
// fp32 scratch between launches); the wrapper
// (shear_rotate.py::_shear_path, _shear_cluster) chooses.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

#include "quarter_turn.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kResidentThreads = 1024;
constexpr int kResidentMaxBytes = 232448;  // opt-in shared memory a block (sm_90)
constexpr int kMaxCluster = 8;   // the portable cluster size

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

// The shift of one line of a pass: d = slope * (var - centre), k = floor(d)
// behind the non-finite fence, f = d - floor(d).
struct Shift {
  float f;
  int k;
};

__device__ __forceinline__ Shift shift_of(float slope, int var, float centre,
                                          int size) {
  const float d = __fmul_rn(slope, __fsub_rn(static_cast<float>(var), centre));
  const float fl = floorf(d);
  const float lim = static_cast<float>(size + 1);
  return {__fsub_rn(d, fl),
          finite(fl) ? static_cast<int>(fminf(fmaxf(fl, -lim), lim)) : 0};
}

__device__ __forceinline__ float lerp_rn(float f, float t0, float t1) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), t0), __fmul_rn(f, t1));
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
  const int var = axis == 1 ? h : w;
  const int pix = axis == 1 ? w : h;
  const int size = axis == 1 ? W : H;
  const Shift sh = shift_of(coef[2 * b + which], var, centre, size);
  const size_t img = static_cast<size_t>(b) * H;
  float t[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    int s = pix + sh.k + q;
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
  store(out + ((img + h) * W + w) * C + c, lerp_rn(sh.f, t[0], t[1]));
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

// --- resident path ---------------------------------------------------------

// A run of CS channels of one pixel as loaded: 16-byte words where the run
// and the pixel are whole words and the pointers aligned (kWords), else CS
// elements; read as fp32 channel by channel.
template <typename T, int CS, bool kWords>
struct Run;

template <typename T, int CS>
struct Run<T, CS, true> {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // a word's
  uint4 word[CS / kPer];

  __device__ __forceinline__ void read(const T* p) {
    const uint4* wp = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int u = 0; u < CS / kPer; ++u) word[u] = __ldg(wp + u);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < CS / kPer; ++u) word[u] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ float get(int q) const {
    const uint4& x = word[q / kPer];
    const int e = q % kPer;
    if constexpr (kPer == 4) {
      return __uint_as_float(e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w);
    } else {  // bf16 pairs, the lower index in the low half
      const unsigned int pair = (e >> 1) == 0 ? x.x : (e >> 1) == 1 ? x.y
                              : (e >> 1) == 2 ? x.z : x.w;
      return __uint_as_float((e & 1) ? pair & 0xffff0000u : pair << 16);
    }
  }
};

template <typename T, int CS>
struct Run<T, CS, false> {
  T v[CS];

  __device__ __forceinline__ void read(const T* p) {
#pragma unroll
    for (int q = 0; q < CS; ++q) v[q] = p[q];
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < CS; ++q) v[q] = T(0.0f);
  }
  __device__ __forceinline__ float get(int q) const { return load(&v[q]); }
};

// Tap s of a row (`row` points at the cluster's first channel of pixel 0):
// out-of-range pixels are edge-clamped or 0.
template <typename T, int CS, bool kWords>
__device__ __forceinline__ void load_tap(Run<T, CS, kWords>& run,
                                         const T* __restrict__ row, int s,
                                         int W, int C, int zeros) {
  if (s < 0 || s >= W) {
    if (zeros) {
      run.zero();
      return;
    }
    s = min(max(s, 0), W - 1);
  }
  run.read(row + s * C);
}

__device__ __forceinline__ unsigned int bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Write CS fp32 values as the channels of one pixel run, in T.
template <typename T, int CS, bool kWords>
__device__ __forceinline__ void store_run(T* __restrict__ p,
                                          const float (&v)[CS]) {
  if constexpr (kWords) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    uint4* wp = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int u = 0; u < CS / kPer; ++u) {
      unsigned int part[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kPer == 4) {
          part[e] = __float_as_uint(v[u * 4 + e]);
        } else {
          part[e] = bf16_bits(v[u * 8 + 2 * e]) |
                    (bf16_bits(v[u * 8 + 2 * e + 1]) << 16);
        }
      }
      wp[u] = make_uint4(part[0], part[1], part[2], part[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < CS; ++q) store(p + q, v[q]);
  }
}

// The pixels a thread of the cluster takes, kItemsFor at a time: g,
// g + nt, ..., as (h, w) advanced by (dh, dw) with a carry, no division
// per pixel. Two where a run holds in 4 registers, else one: more would
// spill at 64 registers a thread.
template <typename T, int CS, bool kWords>
constexpr int kItemsFor =
    (kWords ? CS * static_cast<int>(sizeof(T)) / 4 : CS) <= 4 ? 2 : 1;

struct Walk {
  int h, w;
  const int dh, dw, W;

  __device__ Walk(int g, int nt, int W_)
      : dh(nt / W_), dw(nt - (nt / W_) * W_), W(W_) {
    h = g / W_;
    w = g - h * W_;
  }
  __device__ __forceinline__ void next() {
    w += dw;
    h += dh;
    if (w >= W) {
      w -= W;
      ++h;
    }
  }
};

// The resident plane: H rows of `pitch` fp32 (dynamic shared memory).
// Indexed by 32-bit offsets from the array itself, so that an access is one
// shared-memory instruction with no generic-address conversion.
extern __shared__ float resident_plane[];

// One shear of a line of `len` fp32 values of the plane in place, by one
// warp: v[p] := (1 - f) v[p + k] + f v[p + k + 1], element p at offset
// base + p * step. Lanes take 32 elements a chunk; the chunks are walked
// upwards for k >= 0 and downwards for k < 0, so that a chunk reads only
// elements that no earlier chunk has written. So the loads of several
// chunks can go before their stores, and a lane's stores need no barrier
// after them: no later chunk reads what they write. The chunks whose taps
// all lie in the line (the most) run kGroup at a time with no clamp; the
// edge chunks, one at a time, clamp or zero their taps.
constexpr int kGroup = 4;

struct Line {
  int base, step, len, k, zeros, lane;
  float f, a;

  // chunks j, j + dir, ... (n of them), all taps in the line
  __device__ __forceinline__ void inner(int j, int dir, int n) const {
    float* const plane = resident_plane;
    for (int m = 0; m < n; m += kGroup) {
      float t0[kGroup], t1[kGroup];
      int at[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int p = (j + dir * (m + g)) * 32 + lane;
        at[g] = m + g < n && p < len ? base + p * step : -1;
        if (m + g < n) {
          const int src = base + (p + k) * step;
          t0[g] = plane[src];
          t1[g] = plane[src + step];
        }
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (at[g] >= 0) plane[at[g]] = __fadd_rn(__fmul_rn(a, t0[g]), __fmul_rn(f, t1[g]));
      }
    }
  }

  // chunks j, j + dir, ... (n of them), taps clamped ("border") or zeroed
  __device__ __forceinline__ void edge(int j, int dir, int n) const {
    float* const plane = resident_plane;
    for (int m = 0; m < n; ++m) {
      const int p = (j + dir * m) * 32 + lane;
      const int s0 = p + k;
      float t0 = plane[base + min(max(s0, 0), len - 1) * step];
      float t1 = plane[base + min(max(s0 + 1, 0), len - 1) * step];
      if (zeros) {
        t0 = s0 >= 0 && s0 < len ? t0 : 0.0f;
        t1 = s0 + 1 >= 0 && s0 + 1 < len ? t1 : 0.0f;
      }
      __syncwarp();
      if (p < len) plane[base + p * step] = __fadd_rn(__fmul_rn(a, t0), __fmul_rn(f, t1));
    }
  }
};

__device__ __forceinline__ void shear_line(int base, int step, int len,
                                           Shift s, int zeros, int lane) {
  const int chunks = (len + 31) >> 5;
  const Line line{base, step, len, s.k, zeros, lane, s.f, __fsub_rn(1.0f, s.f)};
  // chunks with every tap in the line: 32 j + k >= 0 and 32 j + 32 + k < len
  const int lo = s.k >= 0 ? 0 : min((31 - s.k) >> 5, chunks);
  const int hi = max(lo, min(chunks, len - 33 - s.k >= 0 ? ((len - 33 - s.k) >> 5) + 1 : 0));
  if (s.k >= 0) {  // upwards: [0, lo) is empty
    line.inner(0, 1, hi);
    line.edge(hi, 1, chunks - hi);
  } else {  // downwards
    line.edge(chunks - 1, -1, chunks - hi);
    line.inner(hi - 1, -1, hi - lo);
    line.edge(lo - 1, -1, lo);
  }
}

// The block's own plane (CS = 1) or rank q's, through distributed shared
// memory.
template <int CS>
__device__ __forceinline__ float* rank_plane(float* own, int q) {
  if constexpr (CS == 1) {
    return own;
  } else {
    return cg::this_cluster().map_shared_rank(own, q);
  }
}

template <int CS>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (CS == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// grid (C, B), clusters of CS blocks along x: the block of channel c owns
// plane (b, c); rank r of a cluster is channel c0 + r. Dynamic shared
// memory: H rows of `pitch` fp32, pitch odd.
template <typename T, int CS, bool kWords>
__global__ void __launch_bounds__(kResidentThreads, 1)
shear_resident_kernel(const T* __restrict__ z, T* __restrict__ out,
                      const float* __restrict__ coef, int H, int W, int C,
                      int pitch, float cx, float cy, int zeros) {
  float* const plane = resident_plane;
  constexpr int kWarps = kResidentThreads / 32;
  int rank = 0;
  if constexpr (CS > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.y;
  const int c0 = static_cast<int>(blockIdx.x) - rank;
  const float alpha = coef[2 * b];
  const float beta = coef[2 * b + 1];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t img = static_cast<size_t>(b) * H * W * C + c0;
  const int g = rank * kResidentThreads + t;
  const int nt = CS * kResidentThreads;

  // every block of the cluster has started before any writes its plane
  if constexpr (CS > 1) cluster_barrier<CS>();
  // pass 1 (x-shear about cy) while loading: the CS channels of pixel
  // (h, w) go to the CS planes of the cluster; kItems pixels' loads first
  constexpr int kItems = kItemsFor<T, CS, kWords>;
  for (Walk p(g, nt, W); p.h < H;) {
    Run<T, CS, kWords> t0[kItems], t1[kItems];
    Shift sh[kItems];
    int at[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      at[u] = -1;
      if (p.h < H) {
        sh[u] = shift_of(alpha, p.h, cy, W);
        const T* row = z + img + static_cast<size_t>(p.h) * W * C;
        load_tap(t0[u], row, p.w + sh[u].k, W, C, zeros);
        load_tap(t1[u], row, p.w + sh[u].k + 1, W, C, zeros);
        at[u] = p.h * pitch + p.w;
        p.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (at[u] < 0) continue;
      const float a = __fsub_rn(1.0f, sh[u].f);
#pragma unroll
      for (int q = 0; q < CS; ++q) {
        rank_plane<CS>(plane, q)[at[u]] =
            __fadd_rn(__fmul_rn(a, t0[u].get(q)), __fmul_rn(sh[u].f, t1[u].get(q)));
      }
    }
  }
  cluster_barrier<CS>();

  // pass 2 (y-shear about cx), a warp a column: the odd pitch puts a
  // column's 32 rows on 32 banks
  for (int col = warp; col < W; col += kWarps) {
    shear_line(col, pitch, H, shift_of(beta, col, cx, H), zeros, lane);
  }
  __syncthreads();
  // pass 3 (x-shear about cy), a warp a row
  for (int row = warp; row < H; row += kWarps) {
    shear_line(row * pitch, 1, W, shift_of(alpha, row, cy, W), zeros, lane);
  }
  cluster_barrier<CS>();

  // the write: pixel (h, w)'s CS channels from the cluster's planes
  for (Walk p(g, nt, W); p.h < H;) {
    float v[kItems][CS];
    size_t to[kItems];
    bool live[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      live[u] = p.h < H;
      if (live[u]) {
        const int at = p.h * pitch + p.w;
#pragma unroll
        for (int q = 0; q < CS; ++q) v[u][q] = rank_plane<CS>(plane, q)[at];
        to[u] = img + (static_cast<size_t>(p.h) * W + p.w) * C;
        p.next();
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      if (live[u]) store_run<T, CS, kWords>(out + to[u], v[u]);
    }
  }
  // a plane stays until every rank of the cluster has read it
  if constexpr (CS > 1) cluster_barrier<CS>();
}

template <typename T, int CS, bool kWords>
int launch_resident(const void* z, void* out, const float* coef, int B, int H,
                    int W, int C, int pitch, int smem, float cx, float cy,
                    int zeros, cudaStream_t st) {
  auto kernel = shear_resident_kernel<T, CS, kWords>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kResidentThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(z),
                           static_cast<T*>(out), coef, H, W, C, pitch, cx, cy,
                           zeros);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CS>
int resident_words(bool words, const void* z, void* out, const float* coef,
                   int B, int H, int W, int C, int pitch, int smem, float cx,
                   float cy, int zeros, cudaStream_t st) {
  if constexpr ((CS * sizeof(T)) % 16 == 0) {
    if (words) {
      return launch_resident<T, CS, true>(z, out, coef, B, H, W, C, pitch,
                                          smem, cx, cy, zeros, st);
    }
  }
  return launch_resident<T, CS, false>(z, out, coef, B, H, W, C, pitch, smem,
                                       cx, cy, zeros, st);
}

template <typename T>
int resident(int cluster, bool words, const void* z, void* out,
             const float* coef, int B, int H, int W, int C, int pitch,
             int smem, float cx, float cy, int zeros, cudaStream_t st) {
  switch (cluster) {
#define EQT_RESIDENT(CS)                                                   \
  case CS:                                                                 \
    return resident_words<T, CS>(words, z, out, coef, B, H, W, C, pitch,   \
                                 smem, cx, cy, zeros, st);
    EQT_RESIDENT(1)
    EQT_RESIDENT(2)
    EQT_RESIDENT(3)
    EQT_RESIDENT(4)
    EQT_RESIDENT(5)
    EQT_RESIDENT(6)
    EQT_RESIDENT(7)
    EQT_RESIDENT(8)
#undef EQT_RESIDENT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The "passes" path, for planes over the shared-memory limit: three
// launches z -> scratch0 -> scratch1 -> out; scratch buffers are fp32
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

// The "resident" path: one launch, no scratch. cluster: the blocks a
// cluster (1-8, dividing C); words: 1 loads and stores 16-byte words
// (cluster * sizeof(T) and C * sizeof(T) multiples of 16, z and out 16-byte
// aligned); smem: the dynamic shared memory a block, which must be
// H * (W | 1) * 4 bytes and at most 232,448. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int eqt_shear_rotate_resident(int dtype, const void* z, void* out,
                                         const float* coef, int B, int H,
                                         int W, int C, float cx, float cy,
                                         int zeros, int cluster, int words,
                                         int smem, void* stream) {
  const int bytes = dtype == 0 ? 4 : 2;
  const int pitch = W | 1;
  const long long need = static_cast<long long>(H) * pitch * 4;
  if (B < 1 || H < 1 || W < 1 || C < 1 || B > 65535 ||
      (dtype != 0 && dtype != 1) || cluster < 1 || cluster > kMaxCluster ||
      C % cluster != 0 || need > kResidentMaxBytes || smem != need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (words != 0 &&
      ((cluster * bytes) % 16 != 0 || (C * bytes) % 16 != 0 ||
       reinterpret_cast<size_t>(z) % 16 != 0 ||
       reinterpret_cast<size_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? resident<float>(cluster, words != 0, z, out, coef, B, H, W, C, pitch,
                        smem, cx, cy, zeros, st)
      : resident<__nv_bfloat16>(cluster, words != 0, z, out, coef, B, H, W, C,
                                pitch, smem, cx, cy, zeros, st);
}
