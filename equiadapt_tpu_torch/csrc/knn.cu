// Fused k-nearest-neighbour indices (K8) for Hopper.
//
// Replaces the Pallas TPU kernel equiadapt_tpu/ops/pallas/knn.py
// (pallas_knn_indices, body _knn_kernel). For every point q of every cloud it
// returns the k indices of the largest
//   d(q, p) = (2 <q, p> - |q|^2) - |p|^2,
// the negative squared distance, nearest first and self included: k rounds of
// first-occurrence argmax over the row, each pick masked with -inf. The
// (B, N, N) distance matrix never reaches device memory.
//
// Design. One block of kRows warps serves kRows query rows of one cloud, one
// warp per row; grid (ceil(N / kRows), B). The block stages the cloud through
// shared memory 32 points at a time: a coalesced load of the (32, D) tile,
// stored transposed as [D][33] so that lane j reads point j without bank
// conflicts. Lane j forms the distance from its warp's query to point
// 32 t + j, and the row's N distances stay in shared memory
// (kRows * N * 4 bytes). Then k rounds: each lane scans its strided slice of
// the row for (max, first index), a butterfly of warp shuffles combines the 32
// candidates, lane 0 writes the index and masks the pick.
//
// Numerics. Input is fp32 or bf16 and is widened to fp32 on load.
// - D <= 4 (coordinates): __fmul_rn / __fadd_rn in the order of the plain
//   version (ops/kernels/knn.py::knn_indices_plain, and the JAX package's
//   pointcloud/networks.py:77-83): inner = q0 p0, then inner += q_d p_d;
//   |q|^2 and |p|^2 alike; then (2 inner - |q|^2) - |p|^2. nvcc would
//   otherwise contract a*b+c into an FMA, so the indices are bit-equal to the
//   plain version only because every step is spelled out.
// - D > 4 (features): the fp32 dot product is the kernel's own, one fmaf chain
//   over d = 0 .. D-1 (no BLAS). It rounds differently from the plain
//   version's matrix product, so the two may order two points differently only
//   where their distances tie at fp32 level.
// - Selection order: NaN above every number, then the larger value, then the
//   smaller index: torch.argmax's rule, so kernel and plain version pick alike
//   whatever the values, and every index lies in [0, N).
//
// Bound. 2 B N^2 D FLOP (the distance products) over the card's fp32 rate
// (H100 SXM: 67 TFLOP/s): 0.0060 ms at D = 3, 0.128 ms at D = 64 and
// 0.256 ms at D = 128, for B = 64, N = 1024. The bytes (B N D 4 in,
// B N k 4 out) take less time at every D, so the kernel is bound by
// operations. This design feeds each FMA from shared memory (one word of the
// key tile and one broadcast word of the query) and re-reads the cloud from L2
// once per block of kRows queries; the k selection rounds scan the row k
// times. Register tiling of several queries per lane is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kRows = 8;         // query rows (warps) per block
constexpr int kTile = 32;        // points per staged tile, one per lane
constexpr int kPad = kTile + 1;  // row stride of the transposed tile

// limits the wrapper (ops/kernels/knn.py) states and checks as well
constexpr int kMaxN = 4096;
constexpr int kMaxD = 256;
constexpr int kMaxK = 128;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// true when (v1, i1) is picked over (v2, i2)
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 != n2) return n1;
  if (!n1 && v1 != v2) return v1 > v2;
  return i1 < i2;
}

// kD in 1..4: fixed-order IEEE products and sums over kD coordinates;
// kD == 0: any D, fmaf chains
template <typename T, int kD>
__global__ void __launch_bounds__(kRows * 32)
knn_kernel(const T* __restrict__ points, int* __restrict__ out, int N,
           int d_runtime, int k) {
  const int D = kD > 0 ? kD : d_runtime;
  extern __shared__ float smem[];
  float* dist = smem;                  // [kRows][N]
  float* tile = dist + kRows * N;      // [D][kPad]
  float* qrows = tile + D * kPad;      // [kRows][D], kD == 0 only
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + warp;
  const bool active = row < N;
  const T* cloud = points + static_cast<size_t>(b) * N * D;
  float* mine = dist + warp * N;
  float* qs = qrows + warp * D;

  // the query and its squared norm (every lane of the warp holds both)
  float q[kD > 0 ? kD : 1];
  float sq_q = 0.0f;
  if (active) {
    const T* qp = cloud + static_cast<size_t>(row) * D;
    if constexpr (kD > 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d) q[d] = load(qp + d);
      sq_q = __fmul_rn(q[0], q[0]);
#pragma unroll
      for (int d = 1; d < kD; ++d) sq_q = __fadd_rn(sq_q, __fmul_rn(q[d], q[d]));
    } else {
      for (int d = lane; d < D; d += 32) qs[d] = load(qp + d);
      __syncwarp();
      for (int d = 0; d < D; ++d) sq_q = fmaf(qs[d], qs[d], sq_q);
    }
  }

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int nk = min(kTile, N - t0);
    __syncthreads();  // every warp is done with the previous tile
    const T* src = cloud + static_cast<size_t>(t0) * D;
    for (int e = threadIdx.x; e < nk * D; e += kRows * 32) {
      const int j = e / D;
      tile[(e - j * D) * kPad + j] = load(src + e);
    }
    __syncthreads();
    if (!active || lane >= nk) continue;
    float inner, sq_p;
    if constexpr (kD > 0) {
      float v = tile[lane];
      inner = __fmul_rn(q[0], v);
      sq_p = __fmul_rn(v, v);
#pragma unroll
      for (int d = 1; d < kD; ++d) {
        v = tile[d * kPad + lane];
        inner = __fadd_rn(inner, __fmul_rn(q[d], v));
        sq_p = __fadd_rn(sq_p, __fmul_rn(v, v));
      }
    } else {
      inner = 0.0f;
      sq_p = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float v = tile[d * kPad + lane];
        inner = fmaf(qs[d], v, inner);
        sq_p = fmaf(v, v, sq_p);
      }
    }
    mine[t0 + lane] = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, inner), sq_q), sq_p);
  }
  if (!active) return;  // no block barrier below
  __syncwarp();

  int* o = out + (static_cast<size_t>(b) * N + row) * k;
  for (int s = 0; s < k; ++s) {
    float best = -INFINITY;
    int at = INT_MAX;  // loses to every real entry, so the pick is in range
    for (int i = lane; i < N; i += 32) {
      const float v = mine[i];
      if (better(v, i, best, at)) {
        best = v;
        at = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, at, off);
      if (better(ov, oi, best, at)) {
        best = ov;
        at = oi;
      }
    }
    if (lane == 0) {
      o[s] = at;
      mine[at] = -INFINITY;
    }
    __syncwarp();
  }
}

template <typename T, int kD>
int launch(const void* points, int* out, int B, int N, int D, int k,
           cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(kRows) * N +
                        static_cast<size_t>(D) * kPad +
                        (kD > 0 ? 0 : static_cast<size_t>(kRows) * D);
  const size_t bytes = floats * sizeof(float);
  auto kernel = knn_kernel<T, kD>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kRows - 1) / kRows, B);
  kernel<<<grid, kRows * 32, bytes, stream>>>(static_cast<const T*>(points),
                                              out, N, D, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* points, int* out, int B, int N, int D, int k,
             cudaStream_t stream) {
  switch (D) {
    case 1: return launch<T, 1>(points, out, B, N, D, k, stream);
    case 2: return launch<T, 2>(points, out, B, N, D, k, stream);
    case 3: return launch<T, 3>(points, out, B, N, D, k, stream);
    case 4: return launch<T, 4>(points, out, B, N, D, k, stream);
    default: return launch<T, 0>(points, out, B, N, D, k, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; points: device (B, N, D), contiguous;
// out: device (B, N, k) int32. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int eqt_knn_indices(int dtype, const void* points, int* out, int B,
                               int N, int D, int k, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxN || D < 1 || D > kMaxD ||
      k < 1 || k > N || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(points, out, B, N, D, k, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(points, out, B, N, D, k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
