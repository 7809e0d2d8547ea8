// Steered rotate-select (K1) and fused rotate-select-roll (K2) for Hopper.
//
// Replaces the Pallas TPU kernels in equiadapt_tpu/ops/pallas/select_warp.py:
//   K1  _pallas_select, _pallas_selectn, _pallas_selectn_grouped
//       out[b, c] = rot90^{k[b]}(S_{src[b]}[b, c])
//   K2  _pallas_selectn_rolled
//       out[b, c] = hflip^{refl[b]}(rot90^{k[b]}(S_{src[b]}[b, roll(c, shift[b])]))
// One templated kernel serves both: K1 is K2 with no shift, no reflection
// and a fiber of one (G = n = 1).
//
// S_0..S_{num_sources-1} are NCHW-contiguous (B, C, N, N) planes: the batch
// and its static residual warps (select_warp.py::_c_n_decomposition).
// rot90 follows numpy/torch rot90 over (H, W) (counter-clockwise); the hflip
// reverses W after the rotation; output fiber g of field f reads input fiber
//   (g - shift) mod n           for g <  n  (rotations)
//   n + (g - n + shift) mod n   for g >= n  (reflections, D_n)
// with channel = f * G + g (C-major / G-minor fiber layout).
//
// Bound: both are permutations with no arithmetic, so the least traffic is
// one read of the selected plane and one write of the output plane:
// 2 * B * C * N * N * sizeof(T) bytes over the card's memory bandwidth
// (H100 SXM: 3.35 TB/s). At the main-path shapes that is 2 x 154 MB for K1
// at (256, 3, 224, 224) fp32 (0.092 ms) and 2 x 411 MB for K2 at (256, 16,
// 224, 224) bf16 (0.245 ms). Each block reads only its sample's selected
// source plane and writes its output plane once; the unselected sources
// are never read, and the rolled channel is only a different plane pointer.
//
// What bounded the first design was not the bytes: bf16 gained 1.25x over
// fp32 where the bytes allow 2x. It moved one 2- or 4-byte element a
// thread in 32 x 32 tiles of a plane (2 KB a block in bf16), each block
// reloading its four indices, and picked its source by a dynamic index
// into the kernel parameter's pointer table, which copies the table to
// local memory in every thread. The word path (`select_word_kernel`)
// answers each:
//   - a block covers a whole (b, c) plane (or, when B * C is under two
//     waves of blocks, an equal share of one): it reads (src, k, shift,
//     refl) once and picks the plane by constant indices (`Planes::of`);
//   - every thread moves 16-byte words (8 bf16, 4 fp32). k = 0 and 2 (with
//     or without the hflip) are row copies: a word, or the mirrored word
//     with its elements reversed in registers (`__byte_perm` on bf16
//     pairs);
//   - k = 1 and 3 transpose through a shared-memory tile of 8W x 8W
//     elements (W elements a word: 64 x 64 bf16, 32 x 32 fp32), read as
//     words along source rows and written as words along output rows. A
//     tile row is 8 words (128 bytes); word q of row r is stored at slot
//     q ^ ((r / W) & 7), so the 8 words of a quarter-warp's staging store
//     fill the 32 banks once, and the W-element gathers of an output word
//     (8 lanes on 8 words, 4 lanes on 4 neighbouring elements) fall on
//     distinct banks for 2-byte and 4-byte elements alike.
// No thread divides by a runtime value per element: a word's (row, word)
// comes from one float reciprocal and a correction.
// The word path needs rows of whole words (N * sizeof(T) % 16 == 0) and
// every plane pointer 16-byte aligned; the wrapper
// (select_warp.py::_rolled_path) sends anything else to the element path
// (`select_warp_kernel`), one element a thread in 32 x 32 tiles padded to
// 32 x 33, with the plane picked by the same constant indices.
//
// Indices are read by the block itself and clamped into range, so a wrong
// index cannot form an address outside the sources.
//
// K3 is K1's memory-format case for channels-last sources. It replaces the
// Pallas TPU kernel _pallas_selectn_ilv
// (equiadapt_tpu/ops/pallas/select_warp.py:503-557), which works on
// channel-interleaved (B, N, N*C) rows so that no transpose copy brackets
// the select:
//   out[b, i, j, c] = rot90^{k[b]}(S_{src[b]}[b])[i, j, c],
// S_s and out NHWC-contiguous (B, N, N, C), any C >= 1. Its bound is the
// same as K1's: one read of the selected image, one write of the output,
// 2 * B * N * N * C * sizeof(T) bytes (0.092 / 0.046 ms at (256, 224, 224,
// 3) fp32 / bf16 on an H100 SXM). It is the centered quarter turn of K5
// with no shift and no fill, so it runs K5's kernels (quarter_turn.cuh)
// with the sample's source picked per block: at C <= 4 a 32 x 32 tile
// through shared memory, one warp a row, C a template parameter, pixel
// offsets formed once a pixel and handed out by shuffles; 16-byte words
// where a pixel is whole words and every pointer is aligned; 16-byte chunks
// of a pixel otherwise. Its first design moved one 2- or 4-byte element a
// thread with two runtime divisions (by the row run and by C) each, and
// took the same time in bf16 as in fp32: the index arithmetic, not the
// bytes, bounded it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

#include "quarter_turn.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;
constexpr int kMaxSources = 4;
constexpr int kWordThreads = 256;

// The source planes, picked by constant indices: a dynamic index into a
// kernel parameter copies the struct to local memory in every thread.
template <typename E>
struct Planes {
  const E* ptr[kMaxSources];

  __device__ __forceinline__ const E* of(int s) const {
    const E* p = ptr[0];
#pragma unroll
    for (int q = 1; q < kMaxSources; ++q) p = s == q ? ptr[q] : p;
    return p;
  }
};

template <typename E>
Planes<E> planes(const void* const* src, int num_sources) {
  Planes<E> p;
  for (int s = 0; s < kMaxSources; ++s) {
    p.ptr[s] = static_cast<const E*>(src[s < num_sources ? s : 0]);
  }
  return p;
}

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// What a block needs of its sample: the clamped source, k mod 4, the flip
// and the rolled input channel of output channel c.
struct Sample {
  int s, k, cs;
  bool flip;

  __device__ Sample(const int* src_idx, const int* k_idx, const int* shift,
                    const int* refl, int num_sources, int b, int c, int G,
                    int n) {
    s = min(max(src_idx[b], 0), num_sources - 1);
    k = k_idx[b] & 3;  // floor mod 4, as the TPU kernel's k % 4
    flip = refl != nullptr && refl[b] == 1;
    cs = c;
    if (shift != nullptr) {
      const int p = c % G;
      const int sh = shift[b];
      const int q = p < n ? pmod(p - sh, n) : n + pmod(p - n + sh, n);
      cs = (c / G) * G + q;
    }
  }
};

// Element path. grid (tiles * tiles, C, B), block (kTile, kRows).
template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
select_warp_kernel(Planes<T> sources, T* __restrict__ out,
                   const int* __restrict__ src_idx,
                   const int* __restrict__ k_idx,
                   const int* __restrict__ shift,
                   const int* __restrict__ refl, int num_sources, int C, int N,
                   int G, int n, int tiles) {
  __shared__ T tile[kTile][kTile + 1];

  const int b = blockIdx.z;
  const int c = blockIdx.y;
  const int i0 = (blockIdx.x / tiles) * kTile;  // output row origin
  const int j0 = (blockIdx.x % tiles) * kTile;  // output column origin
  const Sample sm(src_idx, k_idx, shift, refl, num_sources, b, c, G, n);
  const int k = sm.k;
  const bool flip = sm.flip;

  const size_t plane = static_cast<size_t>(N) * N;
  const T* __restrict__ in =
      sources.of(sm.s) + (static_cast<size_t>(b) * C + sm.cs) * plane;
  T* __restrict__ o = out + (static_cast<size_t>(b) * C + c) * plane;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  if ((k & 1) == 0) {
    for (int r = ty; r < kTile; r += kRows) {
      const int i = i0 + r;
      const int j = j0 + tx;
      if (i < N && j < N) {
        const int jj = flip ? N - 1 - j : j;
        const int si = k == 0 ? i : N - 1 - i;
        const int sj = k == 0 ? jj : N - 1 - jj;
        o[static_cast<size_t>(i) * N + j] = in[static_cast<size_t>(si) * N + sj];
      }
    }
    return;  // k is uniform over the block: no thread reaches the barrier
  }

  // k = 1: out[i, j] = S[j', N-1-i];  k = 3: out[i, j] = S[N-1-j', i],
  // with j' = N-1-j under the flip. Lane tx walks the output row index i,
  // which is the source column: the read is coalesced.
  for (int r = ty; r < kTile; r += kRows) {
    const int i = i0 + tx;
    const int j = j0 + r;
    if (i < N && j < N) {
      const int jj = flip ? N - 1 - j : j;
      const int si = k == 1 ? jj : N - 1 - jj;
      const int sj = k == 1 ? N - 1 - i : i;
      tile[tx][r] = in[static_cast<size_t>(si) * N + sj];
    }
  }
  __syncthreads();
  for (int r = ty; r < kTile; r += kRows) {
    const int i = i0 + r;
    const int j = j0 + tx;
    if (i < N && j < N) o[static_cast<size_t>(i) * N + j] = tile[r][tx];
  }
}

// The W elements of a 16-byte word in reverse order.
template <typename E>
__device__ __forceinline__ uint4 reversed(uint4 v);
template <>
__device__ __forceinline__ uint4 reversed<unsigned int>(uint4 v) {
  return make_uint4(v.w, v.z, v.y, v.x);
}
template <>
__device__ __forceinline__ uint4 reversed<unsigned short>(uint4 v) {
  return make_uint4(__byte_perm(v.w, 0, 0x1032), __byte_perm(v.z, 0, 0x1032),
                    __byte_perm(v.y, 0, 0x1032), __byte_perm(v.x, 0, 0x1032));
}

// q = p / d, r = p % d for 0 <= p < 2^24 and d >= 1, from the float
// reciprocal: the estimate is off by at most one, which the remainder's
// range corrects.
__device__ __forceinline__ void divmod(int p, int d, float inv, int& q, int& r) {
  q = __float2int_rz(static_cast<float>(p) * inv);
  r = p - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
}

// Word path, raw elements E (unsigned int for fp32, unsigned short for
// bf16). grid (C, B, parts): the `parts` blocks of a (b, c) plane take an
// equal share of its words (k = 0, 2) or every parts-th tile (k = 1, 3);
// N a multiple of W.
template <typename E>
__global__ void __launch_bounds__(kWordThreads)
select_word_kernel(Planes<uint4> sources, uint4* __restrict__ out,
                   const int* __restrict__ src_idx,
                   const int* __restrict__ k_idx,
                   const int* __restrict__ shift,
                   const int* __restrict__ refl, int num_sources, int C, int N,
                   int G, int n) {
  constexpr int W = 16 / static_cast<int>(sizeof(E));  // elements a word
  constexpr int kSide = 8 * W;  // tile side in elements: 8 words a row
  constexpr int kBatch = 4;     // words a thread loads before it stores
  __shared__ uint4 tile[kSide * 8];

  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int part = blockIdx.z;
  const int parts = gridDim.z;
  const Sample sm(src_idx, k_idx, shift, refl, num_sources, b, c, G, n);
  const int k = sm.k;
  const int NW = N / W;  // words a row
  const int words = N * NW;
  const uint4* __restrict__ in =
      sources.of(sm.s) + (static_cast<size_t>(b) * C + sm.cs) * words;
  uint4* __restrict__ o = out + (static_cast<size_t>(b) * C + c) * words;
  const int t = threadIdx.x;

  if ((k & 1) == 0) {
    // out row i is source row i (k = 0) or N-1-i (k = 2), read forwards
    // or, for k = 2 xor the flip, as mirrored words reversed in registers
    const bool down = k == 2;
    const bool rev = down != sm.flip;
    const float inv = 1.0f / static_cast<float>(NW);
    const int share = (words + parts - 1) / parts;
    const int end = min(words, (part + 1) * share);
    for (int p0 = part * share + t; p0 < end; p0 += kBatch * kWordThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * kWordThreads;
        if (p < end) {
          int i, wj;
          divmod(p, NW, inv, i, wj);
          const int si = down ? N - 1 - i : i;
          v[u] = in[si * NW + (rev ? NW - 1 - wj : wj)];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * kWordThreads;
        if (p < end) o[p] = rev ? reversed<E>(v[u]) : v[u];
      }
    }
    return;  // k is uniform over the block: no thread reaches a barrier
  }

  // k = 1: out[i, j] = S[j', N-1-i];  k = 3: out[i, j] = S[N-1-j', i],
  // j' = N-1-j under the flip. Output tile [i0, i0+h) x [j0, j0+w) reads
  // the source box of w rows from r0 and h columns from c0; its rows run
  // backwards (rev_rows) for k = 3 xor the flip, its columns for k = 1.
  const bool rev_rows = (k == 3) != sm.flip;
  const bool rev_cols = k == 1;
  const int tiles = (N + kSide - 1) / kSide;
  const E* elems = reinterpret_cast<const E*>(tile);
  for (int tt = part; tt < tiles * tiles; tt += parts) {
    const int i0 = (tt / tiles) * kSide;
    const int j0 = (tt % tiles) * kSide;
    const int h = min(kSide, N - i0);  // multiples of W
    const int w = min(kSide, N - j0);
    const int r0 = rev_rows ? N - j0 - w : j0;
    const int c0 = rev_cols ? N - i0 - h : i0;
    // stage: lanes 8q .. 8q+7 take the 8 words of one source row
    for (int e = t; e < w * 8; e += kWordThreads) {
      const int r = e >> 3;
      const int q = e & 7;
      if (q * W < h) {
        tile[r * 8 + (q ^ ((r / W) & 7))] = in[(r0 + r) * NW + c0 / W + q];
      }
    }
    __syncthreads();
    // out: lanes 8m .. 8m+7 write the 8 words of output row ii = e >> 3;
    // word wj gathers the W elements of tile column cc, rows rr
    for (int e = t; e < h * 8; e += kWordThreads) {
      const int ii = e >> 3;
      const int wj = e & 7;
      if (wj * W >= w) continue;
      const int cc = rev_cols ? h - 1 - ii : ii;
      E v[W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int rr = rev_rows ? w - 1 - (wj * W + q) : wj * W + q;
        v[q] = elems[(rr * 8 + ((cc / W) ^ ((rr / W) & 7))) * W + cc % W];
      }
      uint4 word;
      if constexpr (W == 4) {
        word = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        word = make_uint4(v[0] | (static_cast<unsigned>(v[1]) << 16),
                          v[2] | (static_cast<unsigned>(v[3]) << 16),
                          v[4] | (static_cast<unsigned>(v[5]) << 16),
                          v[6] | (static_cast<unsigned>(v[7]) << 16));
      }
      o[(i0 + ii) * NW + j0 / W + wj] = word;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_elements(const void* const* src, int num_sources, void* out,
                    const int* src_idx, const int* k_idx, const int* shift,
                    const int* refl, int B, int C, int N, int G, int n,
                    cudaStream_t stream) {
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles * tiles, C, B);
  const dim3 block(kTile, kRows);
  select_warp_kernel<T><<<grid, block, 0, stream>>>(
      planes<T>(src, num_sources), static_cast<T*>(out), src_idx, k_idx,
      shift, refl, num_sources, C, N, G, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Blocks a plane: enough blocks for kWaveBlocks in all (a full wave of 8
// blocks on each of 132 SMs, twice), at most one per tile of the plane.
constexpr int kWaveBlocks = 2 * 8 * 132;

template <typename E>
int launch_words(const void* const* src, int num_sources, void* out,
                 const int* src_idx, const int* k_idx, const int* shift,
                 const int* refl, int B, int C, int N, int G, int n,
                 cudaStream_t stream) {
  constexpr int kSide = 8 * 16 / static_cast<int>(sizeof(E));
  const int tiles = (N + kSide - 1) / kSide;
  const long long count = static_cast<long long>(B) * C;  // planes
  const int parts = static_cast<int>(
      std::min(static_cast<long long>(tiles) * tiles,
               std::max(1LL, (kWaveBlocks + count - 1) / count)));
  select_word_kernel<E><<<dim3(C, B, parts), kWordThreads, 0, stream>>>(
      planes<uint4>(src, num_sources), static_cast<uint4*>(out), src_idx,
      k_idx, shift, refl, num_sources, C, N, G, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. shift and refl may be null (K1).
// path: 1 = word (N * sizeof(T) a multiple of 16, every source and out
// 16-byte aligned), 0 = element. Returns the cudaError_t of the launch (0
// on success).
extern "C" int eqt_select_warp(int dtype, const void* s0, const void* s1,
                               const void* s2, const void* s3, int num_sources,
                               void* out, const int* src_idx, const int* k_idx,
                               const int* shift, const int* refl, int B, int C,
                               int N, int G, int n, int path, void* stream) {
  if (num_sources < 1 || num_sources > kMaxSources || B < 1 || C < 1 ||
      N < 1 || G < 1 || n < 1 || C % G != 0 || B > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* src[kMaxSources] = {s0, s1, s2, s3};
  const auto st = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (C > 65535) return static_cast<int>(cudaErrorInvalidValue);
    return dtype == 0
        ? launch_elements<float>(src, num_sources, out, src_idx, k_idx, shift,
                                 refl, B, C, N, G, n, st)
        : launch_elements<__nv_bfloat16>(src, num_sources, out, src_idx,
                                         k_idx, shift, refl, B, C, N, G, n,
                                         st);
  }
  const int bytes = dtype == 0 ? 4 : 2;
  bool aligned = reinterpret_cast<size_t>(out) % 16 == 0;
  for (int s = 0; s < num_sources; ++s) {
    aligned = aligned && reinterpret_cast<size_t>(src[s]) % 16 == 0;
  }
  // per-plane word offsets are int, and divmod is exact below 2^24
  if (path != 1 || (N * bytes) % 16 != 0 || !aligned ||
      static_cast<long long>(N) * N * bytes / 16 >= (1LL << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dtype == 0
      ? launch_words<unsigned int>(src, num_sources, out, src_idx, k_idx,
                                   shift, refl, B, C, N, G, n, st)
      : launch_words<unsigned short>(src, num_sources, out, src_idx, k_idx,
                                     shift, refl, B, C, N, G, n, st);
}

// K3: NHWC-contiguous (B, N, N, C) sources and output. dtype as above.
// path: 1 = word (C * sizeof(T) a multiple of 16, every source and out
// 16-byte aligned), 0 = tile. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int eqt_select_warp_nhwc(int dtype, const void* s0, const void* s1,
                                    const void* s2, const void* s3,
                                    int num_sources, void* out,
                                    const int* src_idx, const int* k_idx,
                                    int B, int N, int C, int path,
                                    void* stream) {
  if (num_sources < 1 || num_sources > kMaxSources ||
      !quarter_turn_shape_ok(B, N, C) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* src[kMaxSources] = {s0, s1, s2, s3};
  const auto st = static_cast<cudaStream_t>(stream);
  const Shifts none = {{0, 0, 0, 0}, {0, 0, 0, 0}};  // a plain quarter turn
  if (path == 0) {
    return dtype == 0
        ? rot90_tile(images<unsigned int>(src, num_sources, src_idx), out,
                     k_idx, none, 0, B, N, C, st)
        : rot90_tile(images<unsigned short>(src, num_sources, src_idx), out,
                     k_idx, none, 0, B, N, C, st);
  }
  const int bytes = dtype == 0 ? 4 : 2;
  bool aligned = reinterpret_cast<size_t>(out) % 16 == 0;
  for (int s = 0; s < num_sources; ++s) {
    aligned = aligned && reinterpret_cast<size_t>(src[s]) % 16 == 0;
  }
  if (path != 1 || (C * bytes) % 16 != 0 || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rot90_words(images<uint4>(src, num_sources, src_idx), out, k_idx,
                     none, 0, B, N, C * bytes / 16, st);
}
