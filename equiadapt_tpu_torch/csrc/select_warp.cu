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
// at (256, 3, 224, 224) fp32 and 2 x 822 MB for K2 at (256, 16, 224, 224)
// fp32. The design meets that traffic: each block reads only its sample's
// selected source plane and writes its output tile once; the unselected
// sources are never read. The rolled channel is only a different plane
// pointer. Quarter turns that transpose (k = 1, 3) stage a 32 x 32 tile
// through shared memory padded to 32 x 33, so that both the global read and
// the global write run along contiguous rows (coalesced) and the shared
// memory accesses are free of bank conflicts. k = 0, 2 copy directly: their
// reads are contiguous rows, reversed for k = 2 or a flip.
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

#include <cstddef>

#include "quarter_turn.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;
constexpr int kMaxSources = 4;

template <typename T>
struct Sources {
  const T* ptr[kMaxSources];
};

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
select_warp_kernel(Sources<T> sources, T* __restrict__ out,
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

  const int s = min(max(src_idx[b], 0), num_sources - 1);
  const int k = k_idx[b] & 3;  // floor mod 4, as the TPU kernel's k % 4
  const bool flip = refl != nullptr && refl[b] == 1;
  int cs = c;
  if (shift != nullptr) {
    const int p = c % G;
    const int sh = shift[b];
    const int q = p < n ? pmod(p - sh, n) : n + pmod(p - n + sh, n);
    cs = (c / G) * G + q;
  }

  const size_t plane = static_cast<size_t>(N) * N;
  const T* __restrict__ in =
      sources.ptr[s] + (static_cast<size_t>(b) * C + cs) * plane;
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

template <typename T>
int launch(const void* const* src, int num_sources, void* out,
           const int* src_idx, const int* k_idx, const int* shift,
           const int* refl, int B, int C, int N, int G, int n,
           cudaStream_t stream) {
  Sources<T> sources;
  for (int s = 0; s < kMaxSources; ++s) {
    sources.ptr[s] = static_cast<const T*>(src[s < num_sources ? s : 0]);
  }
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles * tiles, C, B);
  const dim3 block(kTile, kRows);
  select_warp_kernel<T><<<grid, block, 0, stream>>>(
      sources, static_cast<T*>(out), src_idx, k_idx, shift, refl, num_sources,
      C, N, G, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. shift and refl may be null (K1).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int eqt_select_warp(int dtype, const void* s0, const void* s1,
                               const void* s2, const void* s3, int num_sources,
                               void* out, const int* src_idx, const int* k_idx,
                               const int* shift, const int* refl, int B, int C,
                               int N, int G, int n, void* stream) {
  if (num_sources < 1 || num_sources > kMaxSources || B < 1 || C < 1 ||
      N < 1 || G < 1 || n < 1 || C % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* src[kMaxSources] = {s0, s1, s2, s3};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(src, num_sources, out, src_idx, k_idx, shift, refl,
                         B, C, N, G, n, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(src, num_sources, out, src_idx, k_idx, shift,
                                 refl, B, C, N, G, n, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
