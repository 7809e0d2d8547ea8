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
// `QuarterTurn` holds the whole index map (shift, clamp or zero fill, turn)
// and the source box of an output tile, for any kernel that loads a plane
// or a tile through it. Each output element is a copy of one input element,
// moved as raw bits, or +0: the kernel is bit-equal to its plain version,
// NaN payloads and -0.0 included. Two paths, chosen by the wrapper
// (shear_rotate.py::_select_path) from C, the dtype and the alignment:
//   word (C * sizeof(T) a multiple of 16, both pointers 16-byte aligned):
//     each thread moves one 16-byte word; a block is a 2-D thread map
//     (words of a pixel, pixels along the flattened plane), so a warp
//     stores contiguous bytes, and a transposed read is still a whole
//     pixel of 32 or 64 bytes, every sector used in full;
//   tile (every other C; C = 3 above all): one block owns a 32 x 32 output
//     tile of one sample, reads its source box (at most 32 x 32 pixels,
//     shifted by at most one and clamped) with coalesced row reads into
//     shared memory, and writes the output rows contiguously. k is uniform
//     in a block (it is per sample), so no branch diverges; k = 0 and 2
//     take the same path. For C <= 4 (`rot90_tile_c_kernel`, C a template
//     parameter) one warp takes a row: a lane loads its elements of 4 rows
//     before it stores any, the row pitch (33 C words) spreads a transposed
//     row over the banks, and on the way out lane c forms pixel c's offset
//     and the lanes copy the row's elements, consecutive lanes on
//     consecutive elements, each taking its pixel's offset by a shuffle.
//     Other C (`rot90_tile_kernel`) go through in chunks of 16 bytes a pixel
//     (4 fp32, 8 bf16: a 16.5 KB tile), threads in a 2-D map (channel of
//     the chunk, pixel), the row pitch an odd number of words.
// No thread divides by C.
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

struct Shifts {
  int sy[4];
  int sx[4];
};

// K5's index map for one sample: output pixel (i, j) reads source pixel
// (si, sj) = turn_k(clamp(i + sy_k), clamp(j + sx_k)), or is zero-filled.
struct QuarterTurn {
  int k, n, sy, sx, zeros;

  __device__ QuarterTurn(int k_idx, int n_, const Shifts& s, int zeros_)
      : k(k_idx & 3), n(n_), sy(s.sy[k_idx & 3]), sx(s.sx[k_idx & 3]),
        zeros(zeros_) {}

  // (si, sj) of the shifted, in-range pixel (ii, jj)
  __device__ __forceinline__ void turn(int ii, int jj, int& si, int& sj) const {
    switch (k) {
      case 0: si = ii; sj = jj; break;
      case 1: si = jj; sj = n - 1 - ii; break;
      case 2: si = n - 1 - ii; sj = n - 1 - jj; break;
      default: si = n - 1 - jj; sj = ii; break;
    }
  }

  // false: the pixel is zero-filled ("zeros" and the shift leaves the image)
  __device__ __forceinline__ bool source(int i, int j, int& si, int& sj) const {
    int ii = i + sy;
    int jj = j + sx;
    if (ii < 0 || ii >= n || jj < 0 || jj >= n) {
      if (zeros) return false;
      ii = min(max(ii, 0), n - 1);
      jj = min(max(jj, 0), n - 1);
    }
    turn(ii, jj, si, sj);
    return true;
  }

  // The source box [r0, r0 + nr) x [c0, c0 + nc) that holds every source
  // pixel of the output tile [i0, i0 + h) x [j0, j0 + w): the clamp is
  // monotone and moves no pair apart, so the shifted rows span at most h
  // and the columns at most w; the turn maps the two spans onto the box.
  __device__ __forceinline__ void box(int i0, int j0, int h, int w, int& r0,
                                      int& nr, int& c0, int& nc) const {
    const int ilo = min(max(i0 + sy, 0), n - 1);
    const int ihi = min(max(i0 + h - 1 + sy, 0), n - 1);
    const int jlo = min(max(j0 + sx, 0), n - 1);
    const int jhi = min(max(j0 + w - 1 + sx, 0), n - 1);
    int ra, rb, ca, cb;  // the corners' sources
    turn(ilo, jlo, ra, ca);
    turn(ihi, jhi, rb, cb);
    r0 = min(ra, rb);
    nr = max(ra, rb) - r0 + 1;
    c0 = min(ca, cb);
    nc = max(ca, cb) - c0 + 1;
  }
};

constexpr int kTile = 32;

// Raw element words: fp32 as 32-bit, bf16 as 16-bit; CH channels make the
// 16 bytes a pixel's chunk holds; the row pitch is an odd number of 4-byte
// words, so a column walk (k = 1, 3) spreads over the banks.
template <typename E>
struct TileShape {
  static constexpr int kChannels = 16 / static_cast<int>(sizeof(E));
  static constexpr int kPitch = kTile * kChannels + 4 / static_cast<int>(sizeof(E));
};

// Tile path. grid (ceil(N / kTile), ceil(N / kTile), B), block (chunk
// channels, pixels): threadIdx.x the channel within the chunk, threadIdx.y
// a pixel slot of the tile.
template <typename E>
__global__ void __launch_bounds__(kThreads)
rot90_tile_kernel(const E* __restrict__ x, E* __restrict__ out,
                  const int* __restrict__ k_idx, Shifts shifts, int zeros,
                  int N, int C) {
  using S = TileShape<E>;
  __shared__ E tile[kTile * S::kPitch];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int h = min(kTile, N - i0);
  const int w = min(kTile, N - j0);
  const QuarterTurn q(k_idx[b], N, shifts, zeros);
  int r0, nr, c0, nc;
  q.box(i0, j0, h, w, r0, nr, c0, nc);
  const size_t plane = static_cast<size_t>(b) * N * N;
  const int chunk = blockDim.x;
  const int ch = threadIdx.x;
  for (int ch0 = 0; ch0 < C; ch0 += chunk) {
    const bool active = ch < min(chunk, C - ch0);
    __syncthreads();  // every thread is done with the previous chunk
    if (active) {
      for (int e = threadIdx.y; e < kTile * kTile; e += blockDim.y) {
        const int r = e / kTile;
        const int c = e % kTile;
        if (r < nr && c < nc) {
          tile[r * S::kPitch + c * chunk + ch] =
              x[(plane + static_cast<size_t>(r0 + r) * N + (c0 + c)) * C + ch0 + ch];
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int e = threadIdx.y; e < kTile * kTile; e += blockDim.y) {
        const int r = e / kTile;
        const int c = e % kTile;
        if (r >= h || c >= w) continue;
        int si = r0, sj = c0;
        const bool copy = q.source(i0 + r, j0 + c, si, sj);
        out[(plane + static_cast<size_t>(i0 + r) * N + (j0 + c)) * C + ch0 + ch] =
            copy ? tile[(si - r0) * S::kPitch + (sj - c0) * chunk + ch] : E(0);
      }
    }
  }
}

// Tile path for C <= 4 (C known at compile time): the same tile, one warp a
// row. Staging: a lane loads up to C elements of each of its warp's 4 rows
// (the row's C-interleaved elements are contiguous in device and shared
// memory), all loads issued before the stores. Output: lane c forms the
// shared-memory offset of the row's pixel c (or -1 for a zero fill); the
// lanes then copy the row's elements, consecutive lanes on consecutive
// elements, each taking its pixel's offset from lane e / C by a shuffle.
template <typename E, int C>
__global__ void __launch_bounds__(kThreads)
rot90_tile_c_kernel(const E* __restrict__ x, E* __restrict__ out,
                    const int* __restrict__ k_idx, Shifts shifts, int zeros,
                    int N) {
  // (kTile + 1) * C 4-byte words a row: the pixels of a transposed row
  // (k = 1, 3), C words a row apart, then fall into distinct banks
  constexpr int kPitch = (kTile + 1) * C * (4 / static_cast<int>(sizeof(E)));
  constexpr int kWarps = kThreads / 32;
  constexpr int kRows = kTile / kWarps;  // rows a warp
  __shared__ E tile[kTile * kPitch];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int h = min(kTile, N - i0);
  const int w = min(kTile, N - j0);
  const QuarterTurn q(k_idx[b], N, shifts, zeros);
  int r0, nr, c0, nc;
  q.box(i0, j0, h, w, r0, nr, c0, nc);
  const E* __restrict__ src = x + static_cast<size_t>(b) * N * N * C;
  E* __restrict__ dst = out + static_cast<size_t>(b) * N * N * C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  E v[kRows][C];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < nr) {
      const E* row = src + ((r0 + r) * N + c0) * C;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int e = lane + u * 32;
        if (e < nc * C) v[rr][u] = row[e];
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp + rr * kWarps;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int e = lane + u * 32;
      if (r < nr && e < nc * C) tile[r * kPitch + e] = v[rr][u];
    }
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= h) break;  // uniform in the warp
    int si = r0, sj = c0;
    const bool copy = lane < w && q.source(i0 + r, j0 + lane, si, sj);
    const int off = copy ? (si - r0) * kPitch + (sj - c0) * C : -1;
    E* row = dst + ((i0 + r) * N + j0) * C;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int e = lane + u * 32;
      const int pix = e / C;
      const int at = __shfl_sync(0xffffffffu, off, pix);
      if (e < w * C) row[e] = at >= 0 ? tile[at + (e - pix * C)] : E(0);
    }
  }
}

// Word path. grid (ceil(N * N / blockDim.y), B), block (words of a pixel
// (capped at 32), pixels): one 16-byte word a thread.
__global__ void __launch_bounds__(kThreads)
rot90_word_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                  const int* __restrict__ k_idx, Shifts shifts, int zeros,
                  int N, int words) {
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= N * N) return;
  const int i = p / N;
  const int j = p - i * N;
  const int b = blockIdx.y;
  const QuarterTurn q(k_idx[b], N, shifts, zeros);
  int si = 0, sj = 0;
  const bool copy = q.source(i, j, si, sj);
  const size_t plane = static_cast<size_t>(b) * N * N;
  uint4* o = out + (plane + p) * words;
  const uint4* s = x + (plane + static_cast<size_t>(si) * N + sj) * words;
  for (int u = threadIdx.x; u < words; u += blockDim.x) {
    o[u] = copy ? s[u] : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename E, int C>
int rot90_tile_c(const void* x, void* out, const int* k_idx, const Shifts& s,
                 int zeros, int B, int N, cudaStream_t st) {
  const int tiles = (N + kTile - 1) / kTile;
  rot90_tile_c_kernel<E, C><<<dim3(tiles, tiles, B), kThreads, 0, st>>>(
      static_cast<const E*>(x), static_cast<E*>(out), k_idx, s, zeros, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int rot90_tile(const void* x, void* out, const int* k_idx, const Shifts& s,
               int zeros, int B, int N, int C, cudaStream_t st) {
  switch (C) {
    case 1: return rot90_tile_c<E, 1>(x, out, k_idx, s, zeros, B, N, st);
    case 2: return rot90_tile_c<E, 2>(x, out, k_idx, s, zeros, B, N, st);
    case 3: return rot90_tile_c<E, 3>(x, out, k_idx, s, zeros, B, N, st);
    case 4: return rot90_tile_c<E, 4>(x, out, k_idx, s, zeros, B, N, st);
    default: break;
  }
  const int tiles = (N + kTile - 1) / kTile;
  const int chunk = min(C, TileShape<E>::kChannels);
  const dim3 block(chunk, kThreads / chunk);
  rot90_tile_kernel<E><<<dim3(tiles, tiles, B), block, 0, st>>>(
      static_cast<const E*>(x), static_cast<E*>(out), k_idx, s, zeros, N, C);
  return static_cast<int>(cudaGetLastError());
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
  if (path == 0) {
    return dtype == 0
        ? rot90_tile<unsigned int>(x, out, k_idx, s, zeros, B, N, C, st)
        : rot90_tile<unsigned short>(x, out, k_idx, s, zeros, B, N, C, st);
  }
  if (path != 1 || (C * bytes) % 16 != 0 ||
      reinterpret_cast<size_t>(x) % 16 != 0 ||
      reinterpret_cast<size_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = C * bytes / 16;
  const int per_pixel = min(words, 32);
  const dim3 block(per_pixel, kThreads / per_pixel);
  const long long pixels = static_cast<long long>(N) * N;
  const dim3 grid(static_cast<unsigned>((pixels + block.y - 1) / block.y), B);
  rot90_word_kernel<<<grid, block, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), k_idx, s, zeros,
      N, words);
  return static_cast<int>(cudaGetLastError());
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
