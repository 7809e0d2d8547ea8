// The channel contraction of a spectral convolution, fp32, for Hopper.
//
// Replaces no TPU kernel: the JAX package's SteerableConv is a plain XLA
// convolution (equiadapt_tpu/images/networks/steerable.py). It is added
// because the card measured 24.8 ms a batch for cuDNN's fp32 direct
// convolution of the so2 canonicalizer's hidden layer (80 -> 80 channels,
// kernel 9 x 9, (256, 80, 56, 56) in, 48 x 48 out), the largest device op
// of its serve cell. By the convolution theorem that layer is two real FFTs
// (torch.fft, cuFFT, fp32) around this kernel:
//   Y[b, o, f] = sum_i X[b, i, f] K[i, o, f]
// for complex64 X (B, Cin, F) and Y (B, Cout, F), the bins F = Nh (Nw/2 + 1)
// of each map contiguous (rfft2's layout, read and written by strides), and
// K (Cin, Cout, F) the conjugate spectrum of the zero-padded kernel, kept
// across calls by the caller.
//
// Bound. At the so2 shape (B 256, Cin = Cout = 80, F 56 x 29 = 1,624) the
// contraction is 8 B Cin Cout F = 2.13e10 FLOP, 0.32 ms at the card's 67
// TFLOP/s fp32 rate (no tensor core takes fp32 operands without TF32),
// against 0.62 GB of X, Y and K (0.18 ms at 3.35 TB/s): the fp32 FMA rate.
//
// Design (SIMT, a register-blocked complex product a bin). A block owns FT
// consecutive bins of BT batch rows across OT = 8 RO output channels (all
// 80 of the so2 layer at RO 10; 8 at RO 1 for its 80 -> 4 layer), 8
// warps; a thread owns one bin and 8 batch rows by RO outputs, complex
// accumulators in registers, each complex multiply-add four FMAs. A warp's
// lanes are (output group og, bin f), its batch rows one group of 8: a
// thread's outputs are og + 8 c, so the K values a warp reads for one
// input channel are 32 consecutive complex words (two conflict-free
// shared-memory wavefronts) and its X values are 4 words broadcast to the
// 8 output groups. Each X value read from shared memory feeds RO
// multiply-adds, each K value 8. The input channels stream through shared
// memory IK at a time in NSTAGE buffers, cp.async 16-byte copies (two
// bins) in flight for the next stages while one is used; a row's FT bins
// are 32 contiguous bytes, and a thread works out its copies' addresses
// once, not a stage (the integer work took about a tenth of the time).
// Blocks run the output and batch tiles of one bin tile next to each
// other, so the X and K tiles they share come from L2. At 255 registers a
// thread (one block an SM) this tile measured faster than 4 rows a thread,
// two or four blocks an SM, or registers double-buffered across input
// channels; 8 channels a stage came within 1%. Ragged batch rows, output
// channels and bins are zero-filled on the copy and masked on the store;
// offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kFT = 4;        // bins a block
constexpr int kRB = 8;        // batch rows a thread
constexpr int kWarps = 8;     // a warp: one group of kRB batch rows
constexpr int kThreads = 32 * kWarps;
constexpr int kBT = kRB * kWarps;  // batch rows a block
constexpr int kIK = 4;        // input channels a stage
constexpr int kStages = 3;
constexpr int kChunks = kFT / 2;   // 16-byte copies a row of kFT bins
static_assert(32 == 8 * kFT, "a warp's lanes: 8 output groups x kFT bins");

// strides in complex elements, in the order the wrapper passes them
struct Strides {
  long long xb, xi, ki, ko, yb, yo;
};
static_assert(sizeof(Strides) == 6 * sizeof(long long), "6 strides");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a 16-byte copy, zero-filled where pred is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int RO>
struct Layout {
  static constexpr int kOT = 8 * RO;                  // output channels a block
  static constexpr int kX = kIK * kBT * kFT;          // complex words of a stage's X tile
  static constexpr int kK = kIK * kOT * kFT;          // of its K tile
  static constexpr int kBytes = kStages * (kX + kK) * 8;
  static constexpr int kXC = kIK * kBT * kChunks;     // 16-byte copies of an X tile
  static constexpr int kKC = kIK * kOT * kChunks;     // of a K tile
  static constexpr int kXS = (kXC + kThreads - 1) / kThreads;  // a thread's X copies
  static constexpr int kKS = (kKC + kThreads - 1) / kThreads;  // its K copies
};

template <int RO>
__global__ void __launch_bounds__(kThreads, 1)
    spectral_contraction(const float2* __restrict__ x, const float2* __restrict__ k,
                         float2* __restrict__ y, Strides st, int B, int Cin, int Cout, int F,
                         int tiles_b, int tiles_o) {
  using L = Layout<RO>;
  constexpr int OT = L::kOT;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sX = reinterpret_cast<float2*>(smem);   // kStages X tiles [i][row][f]
  float2* sK = sX + kStages * L::kX;              // kStages K tiles [i][o][f]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = lane & (kFT - 1), og = lane / kFT;
  // output tiles fastest, then batch tiles: the blocks that share an X
  // tile, then those that share a K tile, run side by side
  const long long tile = blockIdx.x;
  const int o0 = static_cast<int>(tile % tiles_o) * OT;
  const long long b0 = (tile / tiles_o) % tiles_b * kBT;
  const long long f0 = tile / (static_cast<long long>(tiles_o) * tiles_b) * kFT;
  const int steps = (Cin + kIK - 1) / kIK;

  // a thread's copies, worked out once: the source at input channel 0
  // (null where the batch row, output or bins lie outside), the channel
  // within a stage (past kIK for a slot beyond the tile), the place in it
  const float2* xsrc[L::kXS];
  int xch[L::kXS], xdst[L::kXS];
#pragma unroll
  for (int j = 0; j < L::kXS; ++j) {
    const unsigned c = tid + j * kThreads;
    const unsigned half = c % kChunks, row = c / kChunks % kBT, i = c / (kChunks * kBT);
    const long long bin = f0 + 2 * half, b = b0 + row;
    xsrc[j] = c < L::kXC && b < B && bin < F ? x + b * st.xb + i * st.xi + bin : nullptr;
    xch[j] = c < L::kXC ? static_cast<int>(i) : kIK;
    xdst[j] = (i * kBT + row) * kFT + 2 * half;
  }
  const float2* ksrc[L::kKS];
  int kch[L::kKS], kdst[L::kKS];
#pragma unroll
  for (int j = 0; j < L::kKS; ++j) {
    const unsigned c = tid + j * kThreads;
    const unsigned half = c % kChunks, o = c / kChunks % OT, i = c / (kChunks * OT);
    const long long bin = f0 + 2 * half;
    ksrc[j] = c < L::kKC && o0 + static_cast<int>(o) < Cout && bin < F
                  ? k + i * st.ki + (o0 + o) * st.ko + bin
                  : nullptr;
    kch[j] = c < L::kKC ? static_cast<int>(i) : kIK;
    kdst[j] = (i * OT + o) * kFT + 2 * half;
  }
  auto load = [&](int buf, int step) {
    const int i0 = step * kIK;
#pragma unroll
    for (int j = 0; j < L::kXS; ++j) {
      if (xch[j] < kIK) {
        const bool ok = xsrc[j] != nullptr && i0 + xch[j] < Cin;
        cp_async16(sX + buf * L::kX + xdst[j], ok ? xsrc[j] + i0 * st.xi : x, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < L::kKS; ++j) {
      if (kch[j] < kIK) {
        const bool ok = ksrc[j] != nullptr && i0 + kch[j] < Cin;
        cp_async16(sK + buf * L::kK + kdst[j], ok ? ksrc[j] + i0 * st.ki : k, ok);
      }
    }
  };

  float2 acc[kRB][RO];
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
#pragma unroll
    for (int c = 0; c < RO; ++c) acc[r][c] = make_float2(0.f, 0.f);
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage has landed; every warp is done with the last one
    const int next = step + kStages - 1;
    if (next < steps) load(next % kStages, next);
    cp_async_commit();
    const float2* tX = sX + (step % kStages) * L::kX + warp * kRB * kFT + f;
    const float2* tK = sK + (step % kStages) * L::kK + og * kFT + f;
#pragma unroll
    for (int i = 0; i < kIK; ++i) {
      float2 xv[kRB], kv[RO];
#pragma unroll
      for (int r = 0; r < kRB; ++r) xv[r] = tX[(i * kBT + r) * kFT];
#pragma unroll
      for (int c = 0; c < RO; ++c) kv[c] = tK[(i * OT + 8 * c) * kFT];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
#pragma unroll
        for (int c = 0; c < RO; ++c) {
          acc[r][c].x = fmaf(xv[r].x, kv[c].x, acc[r][c].x);
          acc[r][c].x = fmaf(-xv[r].y, kv[c].y, acc[r][c].x);
          acc[r][c].y = fmaf(xv[r].x, kv[c].y, acc[r][c].y);
          acc[r][c].y = fmaf(xv[r].y, kv[c].x, acc[r][c].y);
        }
      }
    }
  }

  const long long bin = f0 + f;
  if (bin >= F) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const long long b = b0 + warp * kRB + r;
    if (b >= B) break;
#pragma unroll
    for (int c = 0; c < RO; ++c) {
      const int o = o0 + og + 8 * c;
      if (o < Cout) y[b * st.yb + o * st.yo + bin] = acc[r][c];
    }
  }
}

template <int RO>
int launch(const void* x, const void* k, void* y, const Strides& st, int B, int Cin, int Cout,
           int F, int tiles_b, int tiles_f, int tiles_o, cudaStream_t stream) {
  using L = Layout<RO>;
  if (tiles_b != (B + kBT - 1) / kBT || tiles_f != (F + kFT - 1) / kFT ||
      tiles_o != (Cout + L::kOT - 1) / L::kOT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = spectral_contraction<RO>;
  static bool allowed = false;  // the dynamic shared memory this kernel takes
  if (!allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  kernel<<<static_cast<unsigned>(tiles_b) * tiles_f * tiles_o, kThreads, L::kBytes, stream>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(k), static_cast<float2*>(y), st,
      B, Cin, Cout, F, tiles_b, tiles_o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, Cin, F), k (Cin, Cout, F) and y (B, Cout, F) complex64 by pointer,
// the bins of each row contiguous; `strides` the 6 complex-element strides
// in Strides' order (all even, the pointers 16-byte aligned, F even); ro
// the output channels a thread (1 or 10: 8 ro a block); the grid
// tiles_o x tiles_b x tiles_f blocks of 8 ro outputs, 64 batch rows and 4
// bins. Returns a cudaError_t.
extern "C" int eqt_spectral_contraction(const void* x, const void* k, void* y,
                                        const long long* strides, int B, int Cin, int Cout,
                                        int F, int ro, int tiles_b, int tiles_f, int tiles_o,
                                        void* stream) {
  if (B < 1 || Cin < 1 || Cout < 1 || F < 2 || F % 2 != 0 ||
      static_cast<long long>(tiles_b) * tiles_f * tiles_o > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  std::memcpy(&st, strides, sizeof st);
  const auto s = static_cast<cudaStream_t>(stream);
  if (ro == 1) return launch<1>(x, k, y, st, B, Cin, Cout, F, tiles_b, tiles_f, tiles_o, s);
  if (ro == 10) return launch<10>(x, k, y, st, B, Cin, Cout, F, tiles_b, tiles_f, tiles_o, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
