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
// Elements are copied as 2- or 4-byte words with no arithmetic, so the output
// is bit-identical to the plain version (ops/kernels/orbit.py,
// torch.rot90 / torch.flip), NaN payloads and -0.0 included.
//
// Bound: pure data movement. x is read once and the orbit written once,
// (1 + G) * B * N^2 * C * sizeof(T) bytes over the card's memory bandwidth
// (H100 SXM: 3.35 TB/s): 0.058 ms for (64, 224, 224, 3) fp32 at G = 4 and
// 0.038 ms for (128, 96, 96, 3) fp32 at G = 8.
//
// Design. One block per (b, 32 x 32 input tile). The block stages the tile in
// shared memory, with a coalesced read along the NHWC rows, and then, for
// each of the G elements, writes the output tile it maps onto (every D4
// element maps a square tile onto a square tile of the same size; a ragged
// edge tile maps onto a ragged tile), with stores along output rows, C
// consecutive channels per pixel. So the tile is read once for all G
// elements: the traffic the bound counts. A tile row is padded by one word so
// that the column walks of the transposing elements (k = 1, 3) spread over
// the banks. Channels are staged in chunks that keep the tile within 48 KB
// (11 fp32 or 23 bf16 channels), so any C is taken. Offsets into x and out
// are 64-bit; the grid takes B <= 65535.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxElements = 8;
constexpr int kSmemBytes = 48 * 1024;

// limits the wrapper (ops/kernels/orbit.py) states and checks as well
constexpr int kMaxB = 65535;
constexpr int kMaxN = 65535;

// channels staged per chunk: kTile rows of kTile * cc + 1 words in 48 KB
template <typename W>
struct Chunk {
  static constexpr int kChannels =
      (kSmemBytes / static_cast<int>(sizeof(W)) / kTile - 1) / kTile;
};

template <typename W>
__global__ void __launch_bounds__(kThreads)
orbit_kernel(const W* __restrict__ x, W* __restrict__ out, int B, int N, int C,
             int G, int table, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* tile = reinterpret_cast<W*>(smem_raw);

  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / tiles) * kTile;  // input tile origin
  const int c0 = (blockIdx.x % tiles) * kTile;
  const int h = min(kTile, N - r0);
  const int w = min(kTile, N - c0);
  const size_t image = static_cast<size_t>(N) * N * C;
  const W* __restrict__ src = x + static_cast<size_t>(b) * image;

  for (int ch0 = 0; ch0 < C; ch0 += Chunk<W>::kChannels) {
    const int cc = min(Chunk<W>::kChannels, C - ch0);
    const int pitch = kTile * cc + 1;  // words per staged row
    __syncthreads();  // every thread is done with the previous chunk
    // tile[r * pitch + col * cc + ch] = x[b, r0 + r, c0 + col, ch0 + ch]
    const int in_row = w * cc;
    for (int e = threadIdx.x; e < h * in_row; e += kThreads) {
      const int r = e / in_row;
      const int rest = e - r * in_row;
      const int col = rest / cc;
      const int ch = rest - col * cc;
      tile[r * pitch + col * cc + ch] =
          src[(static_cast<size_t>(r0 + r) * N + (c0 + col)) * C + ch0 + ch];
    }
    __syncthreads();

    for (int g = 0; g < G; ++g) {
      const int k = (table >> (3 * g)) & 3;
      const bool flip = ((table >> (3 * g + 2)) & 1) != 0;
      // the output rectangle [oi0, oi0 + oh) x [oj0, oj0 + ow) of the tile
      // under rot90^k, before the flip
      int oi0, oj0, oh, ow;
      switch (k) {
        case 0: oi0 = r0; oj0 = c0; oh = h; ow = w; break;
        case 1: oi0 = N - c0 - w; oj0 = r0; oh = w; ow = h; break;
        case 2: oi0 = N - r0 - h; oj0 = N - c0 - w; oh = h; ow = w; break;
        default: oi0 = c0; oj0 = N - r0 - h; oh = w; ow = h; break;
      }
      if (flip) oj0 = N - oj0 - ow;
      W* __restrict__ dst =
          out + (static_cast<size_t>(g) * B + b) * image;
      const int out_row = ow * cc;
      for (int e = threadIdx.x; e < oh * out_row; e += kThreads) {
        const int u = e / out_row;
        const int rest = e - u * out_row;
        const int v = rest / cc;
        const int ch = rest - v * cc;
        const int i = oi0 + u;
        const int j = oj0 + v;
        const int jj = flip ? N - 1 - j : j;
        int a, s;  // source pixel (row, column) of output pixel (i, j)
        switch (k) {
          case 0: a = i; s = jj; break;
          case 1: a = jj; s = N - 1 - i; break;
          case 2: a = N - 1 - i; s = N - 1 - jj; break;
          default: a = N - 1 - jj; s = i; break;
        }
        dst[(static_cast<size_t>(i) * N + j) * C + ch0 + ch] =
            tile[(a - r0) * pitch + (s - c0) * cc + ch];
      }
    }
  }
}

template <typename W>
int launch(const void* x, void* out, int B, int N, int C, int G, int table,
           cudaStream_t stream) {
  const int cc = C < Chunk<W>::kChannels ? C : Chunk<W>::kChannels;
  const size_t bytes = static_cast<size_t>(kTile) * (kTile * cc + 1) * sizeof(W);
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles) * tiles, B);
  orbit_kernel<W><<<grid, kThreads, bytes, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(out), B, N, C, G, table, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (copied as 4- and 2-byte words);
// x: device (B, N, N, C), contiguous; out: device (G, B, N, N, C),
// contiguous; table: (k_g | f_g << 2) << 3g for g < G. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int eqt_rot90_flip_orbit(int dtype, const void* x, void* out, int B,
                                    int N, int C, int G, int table,
                                    void* stream) {
  if (B < 1 || B > kMaxB || N < 1 || N > kMaxN || C < 1 || G < 1 ||
      G > kMaxElements) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<uint32_t>(x, out, B, N, C, G, table, st);
  if (dtype == 1) return launch<uint16_t>(x, out, B, N, C, G, table, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
