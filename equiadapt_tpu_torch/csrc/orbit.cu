// Exact D4 orbit (K4) for Hopper.
//
// Replaces the Pallas TPU kernel equiadapt_tpu/ops/pallas/orbit.py
// (_orbit_pallas). For x of shape (B, N, N, C), NHWC, it writes the
// group-major orbit out of shape (G, B, N, N, C):
//   out[g, b] = hflip^{f_g}(rot90^{k_g}(x[b])),
// rot90 being numpy's and torch's counter-clockwise quarter turn over (H, W)
// (k = 1: y[i, j] = x[j, N-1-i]) and the hflip reversing W after it. The
// element table (k_g, f_g), g < G <= 8, comes packed in one int, three bits
// per element: k in bits 3g and 3g+1, f in bit 3g+2.
//
// Elements are copied as raw 2- or 4-byte words (or 16-byte words of them)
// with no arithmetic, so the output is bit-identical to the plain version
// (ops/kernels/orbit.py, torch.rot90 / torch.flip), NaN payloads and -0.0
// included.
//
// Bound: pure data movement. x is read once and the orbit written once,
// (1 + G) * B * N^2 * C * sizeof(T) bytes over the card's memory bandwidth
// (H100 SXM: 3.35 TB/s): 0.058 / 0.029 ms for (64, 224, 224, 3) fp32 / bf16
// at G = 4 and 0.038 / 0.019 ms for (128, 96, 96, 3) at G = 8.
//
// Design. Each launch reads every input word once and stores it to its G
// destinations, so the traffic is the bound's. Three paths, chosen by the
// wrapper (`_orbit_path`) from C, the dtype and the alignment, on the shared
// quarter-turn machinery of quarter_turn.cuh (K3 and K5):
//   word (C * sizeof(T) a multiple of 16, both pointers 16-byte aligned):
//     a 2-D thread map (16-byte words of a pixel, pixels of an input row);
//     a thread loads one word and stores it G times, at the output pixel
//     turn_{4-k}(a, s) of its input pixel (a, s), column mirrored for a
//     flip. A transposed store is still a whole pixel of 16 bytes or more.
//   tile, C <= 4 (C a template parameter): one block stages a 32 x 32 input
//     tile in shared memory, one warp a row, each lane loading its C
//     elements of 4 rows before it stores any; the row pitch, (32 + 1) C
//     4-byte words, spreads a transposed walk (k = 1, 3) over the banks (bf16
//     at C = 3 is a 6-byte pixel on the same pitch in words). Then, for each
//     element g, the block writes the output tile the input tile maps onto
//     (a square tile onto a square tile; a ragged edge tile onto a ragged
//     one), a warp an output row: lane v forms the shared-memory offset of
//     output pixel v once, off + u du + v dv, and the lanes copy the row's
//     C-interleaved elements, consecutive lanes on consecutive elements,
//     each taking its pixel's offset from lane e / C by a shuffle. All of a
//     warp's stores for one element are issued before the next element's.
//   chunk, other C: the same tile in chunks of 16 bytes a pixel (4 fp32,
//     8 bf16 channels), threads in a 2-D map (channel of the chunk, pixel).
// The hflip is folded into the output column map: (off, du, dv) come from
// the turn of three pixels of the output tile, so no element costs more
// than a quarter turn's offset. k and f are uniform in a block's inner
// loop, so no branch diverges, and no thread divides by a runtime value per
// element (the divisions are by the constants 32 and C). Offsets into x and
// out are 64-bit; B <= 65535 and N <= 65535 (grid dimensions).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "quarter_turn.cuh"

namespace {

constexpr int kMaxElements = 8;

// limits the wrapper (ops/kernels/orbit.py) states and checks as well
constexpr int kMaxB = 65535;
constexpr int kMaxN = 65535;

// launch paths, as the wrapper's `_orbit_path` names them
constexpr int kPathTile = 0;
constexpr int kPathWord = 1;
constexpr int kPathChunk = 2;

__device__ __forceinline__ int element_k(int table, int g) {
  return (table >> (3 * g)) & 3;
}

__device__ __forceinline__ bool element_flip(int table, int g) {
  return ((table >> (3 * g + 2)) & 1) != 0;
}

// Where element g sends the staged input tile [r0, r0 + h) x [c0, c0 + w):
// the output tile [oi0, oi0 + oh) x [oj0, oj0 + ow), and the shared-memory
// offset of its pixel (oi0 + u, oj0 + v)'s source, off + u * du + v * dv,
// for a tile of `pitch` elements a row and `pixel` elements a pixel.
struct TileMap {
  int oi0, oj0, oh, ow, off, du, dv;

  __device__ TileMap(int table, int g, int n, int r0, int c0, int h, int w,
                     int pitch, int pixel) {
    const int k = element_k(table, g);
    const bool flip = element_flip(table, g);
    switch (k) {
      case 0: oi0 = r0; oj0 = c0; oh = h; ow = w; break;
      case 1: oi0 = n - c0 - w; oj0 = r0; oh = w; ow = h; break;
      case 2: oi0 = n - r0 - h; oj0 = n - c0 - w; oh = h; ow = w; break;
      default: oi0 = c0; oj0 = n - r0 - h; oh = w; ow = h; break;
    }
    if (flip) oj0 = n - oj0 - ow;
    // the map is affine in (u, v): three pixels fix it
    off = at(k, flip, n, 0, 0, r0, c0, pitch, pixel);
    du = at(k, flip, n, 1, 0, r0, c0, pitch, pixel) - off;
    dv = at(k, flip, n, 0, 1, r0, c0, pitch, pixel) - off;
  }

  __device__ __forceinline__ int at(int k, bool flip, int n, int u, int v,
                                    int r0, int c0, int pitch,
                                    int pixel) const {
    const int j = oj0 + v;
    int si, sj;
    quarter_turn(k, n, oi0 + u, flip ? n - 1 - j : j, si, sj);
    return (si - r0) * pitch + (sj - c0) * pixel;
  }
};

// Tile path, C <= 4. grid (ceil(N / 32), ceil(N / 32), B), kQtThreads
// threads: warp w stages input rows w, w + 8, ... and writes output rows
// the same way.
template <typename E, int C>
__global__ void __launch_bounds__(kQtThreads)
orbit_tile_c_kernel(const E* __restrict__ x, E* __restrict__ out, int B,
                    int N, int G, int table) {
  // (kQtTile + 1) * C 4-byte words a row
  constexpr int kPitch = (kQtTile + 1) * C * (4 / static_cast<int>(sizeof(E)));
  constexpr int kWarps = kQtThreads / 32;
  constexpr int kRows = kQtTile / kWarps;  // rows a warp
  __shared__ E tile[kQtTile * kPitch];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kQtTile;
  const int c0 = blockIdx.x * kQtTile;
  const int h = min(kQtTile, N - r0);
  const int w = min(kQtTile, N - c0);
  const size_t image = static_cast<size_t>(N) * N * C;
  const E* __restrict__ src = x + static_cast<size_t>(b) * image;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  E v[kRows][C];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < h) {
      const E* row = src + (static_cast<size_t>(r0 + r) * N + c0) * C;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const int e = lane + u * 32;
        if (e < w * C) v[rr][u] = row[e];
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp + rr * kWarps;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int e = lane + u * 32;
      if (r < h && e < w * C) tile[r * kPitch + e] = v[rr][u];
    }
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const TileMap m(table, g, N, r0, c0, h, w, kPitch, C);
    E* __restrict__ dst = out + (static_cast<size_t>(g) * B + b) * image;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int u = warp + rr * kWarps;
      if (u >= m.oh) break;  // uniform in the warp
      const int off = m.off + u * m.du + lane * m.dv;  // read for lane < ow
      E* row = dst + (static_cast<size_t>(m.oi0 + u) * N + m.oj0) * C;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int e = lane + t * 32;
        const int pix = e / C;
        const int at = __shfl_sync(0xffffffffu, off, pix);
        if (e < m.ow * C) row[e] = tile[at + (e - pix * C)];
      }
    }
  }
}

// Chunk path, any C. grid (ceil(N / 32), ceil(N / 32), B), block (chunk
// channels, pixels): threadIdx.x the channel within the chunk, threadIdx.y
// a pixel slot of the tile.
template <typename E>
__global__ void __launch_bounds__(kQtThreads)
orbit_chunk_kernel(const E* __restrict__ x, E* __restrict__ out, int B,
                   int N, int C, int G, int table) {
  using S = TileShape<E>;
  __shared__ E tile[kQtTile * S::kPitch];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kQtTile;
  const int c0 = blockIdx.x * kQtTile;
  const int h = min(kQtTile, N - r0);
  const int w = min(kQtTile, N - c0);
  const size_t image = static_cast<size_t>(N) * N * C;
  const E* __restrict__ src = x + static_cast<size_t>(b) * image;
  const int chunk = blockDim.x;
  const int ch = threadIdx.x;
  for (int ch0 = 0; ch0 < C; ch0 += chunk) {
    const bool active = ch < min(chunk, C - ch0);
    __syncthreads();  // every thread is done with the previous chunk
    if (active) {
      for (int e = threadIdx.y; e < kQtTile * kQtTile; e += blockDim.y) {
        const int r = e / kQtTile;
        const int c = e % kQtTile;
        if (r < h && c < w) {
          tile[r * S::kPitch + c * chunk + ch] =
              src[(static_cast<size_t>(r0 + r) * N + (c0 + c)) * C + ch0 + ch];
        }
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int g = 0; g < G; ++g) {
      const TileMap m(table, g, N, r0, c0, h, w, S::kPitch, chunk);
      E* __restrict__ dst = out + (static_cast<size_t>(g) * B + b) * image;
      for (int e = threadIdx.y; e < kQtTile * kQtTile; e += blockDim.y) {
        const int u = e / kQtTile;
        const int v = e % kQtTile;
        if (u < m.oh && v < m.ow) {
          dst[(static_cast<size_t>(m.oi0 + u) * N + (m.oj0 + v)) * C + ch0 + ch] =
              tile[m.off + u * m.du + v * m.dv + ch];
        }
      }
    }
  }
}

// Word path. grid (ceil(N / blockDim.y), N, B), block (words of a pixel
// (capped at 32), pixels): thread (u, s) of block (., a, b) moves word u of
// input pixel (a, s) of sample b to its G output pixels.
__global__ void __launch_bounds__(kQtThreads)
orbit_word_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                  int B, int N, int words, int G, int table) {
  const int a = blockIdx.y;
  const int s = blockIdx.x * blockDim.y + threadIdx.y;
  if (s >= N) return;
  const int b = blockIdx.z;
  const size_t image = static_cast<size_t>(N) * N * words;
  const uint4* __restrict__ src =
      x + static_cast<size_t>(b) * image + (static_cast<size_t>(a) * N + s) * words;
  for (int u = threadIdx.x; u < words; u += blockDim.x) {
    const uint4 word = src[u];
    for (int g = 0; g < G; ++g) {
      const int k = element_k(table, g);
      int i, j;  // output pixel: the inverse turn, then the mirror
      quarter_turn((4 - k) & 3, N, a, s, i, j);
      if (element_flip(table, g)) j = N - 1 - j;
      out[(static_cast<size_t>(g) * B + b) * image +
          (static_cast<size_t>(i) * N + j) * words + u] = word;
    }
  }
}

template <typename E, int C>
int orbit_tile_c(const void* x, void* out, int B, int N, int G, int table,
                 cudaStream_t st) {
  const int tiles = (N + kQtTile - 1) / kQtTile;
  orbit_tile_c_kernel<E, C><<<dim3(tiles, tiles, B), kQtThreads, 0, st>>>(
      static_cast<const E*>(x), static_cast<E*>(out), B, N, G, table);
  return static_cast<int>(cudaGetLastError());
}

// The tile paths of raw words E (unsigned int for fp32, unsigned short for
// bf16): C <= 4 by template, other C in 16-byte chunks.
template <typename E>
int orbit_tile(const void* x, void* out, int B, int N, int C, int G, int table,
               int path, cudaStream_t st) {
  if (path == kPathTile) {
    switch (C) {
      case 1: return orbit_tile_c<E, 1>(x, out, B, N, G, table, st);
      case 2: return orbit_tile_c<E, 2>(x, out, B, N, G, table, st);
      case 3: return orbit_tile_c<E, 3>(x, out, B, N, G, table, st);
      case 4: return orbit_tile_c<E, 4>(x, out, B, N, G, table, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int tiles = (N + kQtTile - 1) / kQtTile;
  const int chunk = min(C, TileShape<E>::kChannels);
  const dim3 block(chunk, kQtThreads / chunk);
  orbit_chunk_kernel<E><<<dim3(tiles, tiles, B), block, 0, st>>>(
      static_cast<const E*>(x), static_cast<E*>(out), B, N, C, G, table);
  return static_cast<int>(cudaGetLastError());
}

int orbit_words(const void* x, void* out, int B, int N, int words, int G,
                int table, cudaStream_t st) {
  const int per_pixel = min(words, 32);
  const dim3 block(per_pixel, kQtThreads / per_pixel);
  const dim3 grid((N + block.y - 1) / block.y, N, B);
  orbit_word_kernel<<<grid, block, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), B, N, words, G,
      table);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (copied as 4- and 2-byte words);
// x: device (B, N, N, C), contiguous; out: device (G, B, N, N, C),
// contiguous; table: (k_g | f_g << 2) << 3g for g < G. path: 0 = tile
// (C <= 4), 1 = word (C * sizeof(T) a multiple of 16, x and out 16-byte
// aligned), 2 = chunk (any C). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int eqt_rot90_flip_orbit(int dtype, const void* x, void* out, int B,
                                    int N, int C, int G, int table, int path,
                                    void* stream) {
  if (B < 1 || B > kMaxB || N < 1 || N > kMaxN || C < 1 || G < 1 ||
      G > kMaxElements || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int bytes = dtype == 0 ? 4 : 2;
  if (path == kPathWord) {
    const bool aligned = reinterpret_cast<size_t>(x) % 16 == 0 &&
                         reinterpret_cast<size_t>(out) % 16 == 0;
    if ((C * bytes) % 16 != 0 || !aligned) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return orbit_words(x, out, B, N, C * bytes / 16, G, table, st);
  }
  if (path != kPathTile && path != kPathChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dtype == 0
      ? orbit_tile<unsigned int>(x, out, B, N, C, G, table, path, st)
      : orbit_tile<unsigned short>(x, out, B, N, C, G, table, path, st);
}
