// Per-sample quarter turns of NHWC images, shared by the centered
// quarter-turn select (K5, shear_rotate.cu) and the channels-last select
// (K3, select_warp.cu); the exact D4 orbit (K4, orbit.cu) takes its turn
// map, tile size and chunk shape.
//
// out[b, i, j, :] = x_b[si, sj, :], where x_b is sample b of the sample's
// source image (one source for K5; for K3 the source src_idx[b], clamped, of
// up to kMaxSources) and (si, sj) = turn_k(clamp(i + sy_k), clamp(j + sx_k))
// with k = k_idx[b] & 3 (floor mod 4), or +0 where "zeros" is set and the
// shift leaves the image. rot90 follows numpy/torch rot90 over (H, W)
// (counter-clockwise):
//   k = 1: z[i, j] = x[j, N-1-i];  k = 2: z[i, j] = x[N-1-i, N-1-j];
//   k = 3: z[i, j] = x[N-1-j, i].
// K3 passes zero shifts and no fill: a plain per-sample quarter turn.
// Elements are moved as raw words (fp32 as 32-bit, bf16 as 16-bit), so the
// output is bit-equal to the plain versions, NaN payloads and -0.0
// included. Three paths, chosen by the wrappers from C, the dtype and the
// alignment:
//   word (C * sizeof(T) a multiple of 16, every pointer 16-byte aligned):
//     each thread moves one 16-byte word; a block is a 2-D thread map
//     (words of a pixel, pixels along the flattened plane), so a warp
//     stores contiguous bytes, and a transposed read is still a whole
//     pixel of 32 or 64 bytes, every sector used in full;
//   tile, C <= 4 (`rot90_tile_c_kernel`, C a template parameter): one block
//     owns a 32 x 32 output tile of one sample and reads its source box
//     (at most 32 x 32 pixels, shifted by at most one and clamped) with
//     coalesced row reads into shared memory, one warp a row: a lane loads
//     its elements of 4 rows before it stores any, the row pitch (33 C
//     words) spreads a transposed row over the banks, and on the way out
//     lane c forms pixel c's offset and the lanes copy the row's elements,
//     consecutive lanes on consecutive elements, each taking its pixel's
//     offset by a shuffle;
//   tile, other C (`rot90_tile_kernel`): the same tile in chunks of 16
//     bytes a pixel (4 fp32, 8 bf16: a 16.5 KB tile), threads in a 2-D map
//     (channel of the chunk, pixel), the row pitch an odd number of words.
// k and the source are uniform in a block (they are per sample), so no
// branch diverges; k = 0 and 2 take the same path. No thread divides by a
// runtime value per element. Per-sample offsets are int: the launchers
// require N * N * C < 2^31.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kQtThreads = 256;
constexpr int kQtTile = 32;
constexpr int kQtMaxSources = 4;

struct Shifts {
  int sy[4];
  int sx[4];
};

// The per-sample source images: ptr[src_idx[b]] (clamped) holds sample b;
// src_idx == nullptr means one source, ptr[0].
template <typename E>
struct Images {
  const E* ptr[kQtMaxSources];
  const int* src_idx;
  int num;

  // Picked by constant indices: a dynamic index into a kernel parameter
  // would copy the struct to local memory in every thread.
  __device__ __forceinline__ const E* of(int b) const {
    if (src_idx == nullptr) return ptr[0];
    const int s = min(max(src_idx[b], 0), num - 1);
    const E* p = ptr[0];
#pragma unroll
    for (int q = 1; q < kQtMaxSources; ++q) p = s == q ? ptr[q] : p;
    return p;
  }
};

// src[0 .. num) of raw words E, picked per sample by src_idx (nullptr: one
// source)
template <typename E>
Images<E> images(const void* const* src, int num, const int* src_idx) {
  Images<E> im;
  for (int s = 0; s < kQtMaxSources; ++s) {
    im.ptr[s] = static_cast<const E*>(src[s < num ? s : 0]);
  }
  im.src_idx = src_idx;
  im.num = num;
  return im;
}

// The source pixel (si, sj) of pixel (ii, jj) of rot90^k of an n x n image
// (k in 0..3); turn_{4-k} is its inverse. Shared with the orbit (K4,
// orbit.cu).
__device__ __forceinline__ void quarter_turn(int k, int n, int ii, int jj,
                                             int& si, int& sj) {
  switch (k) {
    case 0: si = ii; sj = jj; break;
    case 1: si = jj; sj = n - 1 - ii; break;
    case 2: si = n - 1 - ii; sj = n - 1 - jj; break;
    default: si = n - 1 - jj; sj = ii; break;
  }
}

// The index map of one sample: output pixel (i, j) reads source pixel
// (si, sj) = turn_k(clamp(i + sy_k), clamp(j + sx_k)), or is zero-filled.
struct QuarterTurn {
  int k, n, sy, sx, zeros;

  __device__ QuarterTurn(int k_idx, int n_, const Shifts& s, int zeros_)
      : k(k_idx & 3), n(n_), sy(s.sy[k_idx & 3]), sx(s.sx[k_idx & 3]),
        zeros(zeros_) {}

  // (si, sj) of the shifted, in-range pixel (ii, jj)
  __device__ __forceinline__ void turn(int ii, int jj, int& si, int& sj) const {
    quarter_turn(k, n, ii, jj, si, sj);
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

// Raw element words: fp32 as 32-bit, bf16 as 16-bit; CH channels make the
// 16 bytes a pixel's chunk holds; the row pitch is an odd number of 4-byte
// words, so a column walk (k = 1, 3) spreads over the banks.
template <typename E>
struct TileShape {
  static constexpr int kChannels = 16 / static_cast<int>(sizeof(E));
  static constexpr int kPitch =
      kQtTile * kChannels + 4 / static_cast<int>(sizeof(E));
};

// Tile path, any C. grid (ceil(N / kQtTile), ceil(N / kQtTile), B), block
// (chunk channels, pixels): threadIdx.x the channel within the chunk,
// threadIdx.y a pixel slot of the tile.
template <typename E>
__global__ void __launch_bounds__(kQtThreads)
rot90_tile_kernel(Images<E> x, E* __restrict__ out,
                  const int* __restrict__ k_idx, Shifts shifts, int zeros,
                  int N, int C) {
  using S = TileShape<E>;
  __shared__ E tile[kQtTile * S::kPitch];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kQtTile;
  const int j0 = blockIdx.x * kQtTile;
  const int h = min(kQtTile, N - i0);
  const int w = min(kQtTile, N - j0);
  const QuarterTurn q(k_idx[b], N, shifts, zeros);
  int r0, nr, c0, nc;
  q.box(i0, j0, h, w, r0, nr, c0, nc);
  const size_t plane = static_cast<size_t>(b) * N * N;
  const E* __restrict__ src = x.of(b);
  const int chunk = blockDim.x;
  const int ch = threadIdx.x;
  for (int ch0 = 0; ch0 < C; ch0 += chunk) {
    const bool active = ch < min(chunk, C - ch0);
    __syncthreads();  // every thread is done with the previous chunk
    if (active) {
      for (int e = threadIdx.y; e < kQtTile * kQtTile; e += blockDim.y) {
        const int r = e / kQtTile;
        const int c = e % kQtTile;
        if (r < nr && c < nc) {
          tile[r * S::kPitch + c * chunk + ch] =
              src[(plane + static_cast<size_t>(r0 + r) * N + (c0 + c)) * C + ch0 + ch];
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int e = threadIdx.y; e < kQtTile * kQtTile; e += blockDim.y) {
        const int r = e / kQtTile;
        const int c = e % kQtTile;
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
__global__ void __launch_bounds__(kQtThreads)
rot90_tile_c_kernel(Images<E> x, E* __restrict__ out,
                    const int* __restrict__ k_idx, Shifts shifts, int zeros,
                    int N) {
  // (kQtTile + 1) * C 4-byte words a row: the pixels of a transposed row
  // (k = 1, 3), C words a row apart, then fall into distinct banks
  constexpr int kPitch = (kQtTile + 1) * C * (4 / static_cast<int>(sizeof(E)));
  constexpr int kWarps = kQtThreads / 32;
  constexpr int kRows = kQtTile / kWarps;  // rows a warp
  __shared__ E tile[kQtTile * kPitch];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kQtTile;
  const int j0 = blockIdx.x * kQtTile;
  const int h = min(kQtTile, N - i0);
  const int w = min(kQtTile, N - j0);
  const QuarterTurn q(k_idx[b], N, shifts, zeros);
  int r0, nr, c0, nc;
  q.box(i0, j0, h, w, r0, nr, c0, nc);
  const E* __restrict__ src = x.of(b) + static_cast<size_t>(b) * N * N * C;
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
__global__ void __launch_bounds__(kQtThreads)
rot90_word_kernel(Images<uint4> x, uint4* __restrict__ out,
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
  const uint4* s = x.of(b) + (plane + static_cast<size_t>(si) * N + sj) * words;
  for (int u = threadIdx.x; u < words; u += blockDim.x) {
    o[u] = copy ? s[u] : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename E, int C>
int rot90_tile_c(const Images<E>& x, void* out, const int* k_idx,
                 const Shifts& s, int zeros, int B, int N, cudaStream_t st) {
  const int tiles = (N + kQtTile - 1) / kQtTile;
  rot90_tile_c_kernel<E, C><<<dim3(tiles, tiles, B), kQtThreads, 0, st>>>(
      x, static_cast<E*>(out), k_idx, s, zeros, N);
  return static_cast<int>(cudaGetLastError());
}

// The tile path of raw words E (unsigned int for fp32, unsigned short for
// bf16).
template <typename E>
int rot90_tile(const Images<E>& x, void* out, const int* k_idx,
               const Shifts& s, int zeros, int B, int N, int C,
               cudaStream_t st) {
  switch (C) {
    case 1: return rot90_tile_c<E, 1>(x, out, k_idx, s, zeros, B, N, st);
    case 2: return rot90_tile_c<E, 2>(x, out, k_idx, s, zeros, B, N, st);
    case 3: return rot90_tile_c<E, 3>(x, out, k_idx, s, zeros, B, N, st);
    case 4: return rot90_tile_c<E, 4>(x, out, k_idx, s, zeros, B, N, st);
    default: break;
  }
  const int tiles = (N + kQtTile - 1) / kQtTile;
  const int chunk = min(C, TileShape<E>::kChannels);
  const dim3 block(chunk, kQtThreads / chunk);
  rot90_tile_kernel<E><<<dim3(tiles, tiles, B), block, 0, st>>>(
      x, static_cast<E*>(out), k_idx, s, zeros, N, C);
  return static_cast<int>(cudaGetLastError());
}

// The word path: `words` 16-byte words a pixel.
inline int rot90_words(const Images<uint4>& x, void* out, const int* k_idx,
                       const Shifts& s, int zeros, int B, int N, int words,
                       cudaStream_t st) {
  const int per_pixel = min(words, 32);
  const dim3 block(per_pixel, kQtThreads / per_pixel);
  const long long pixels = static_cast<long long>(N) * N;
  const dim3 grid(static_cast<unsigned>((pixels + block.y - 1) / block.y), B);
  rot90_word_kernel<<<grid, block, 0, st>>>(x, static_cast<uint4*>(out), k_idx,
                                            s, zeros, N, words);
  return static_cast<int>(cudaGetLastError());
}

// The launch limits of every path: grid z and y take B, the per-sample
// offsets are int.
inline bool quarter_turn_shape_ok(int B, int N, int C) {
  return B >= 1 && N >= 1 && C >= 1 && B <= 65535 &&
         static_cast<long long>(N) * N * C < (1LL << 31);
}

}  // namespace
