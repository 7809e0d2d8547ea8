// Greedy non-maximum suppression of many independent segments on the device,
// fp32 boxes, for Hopper.
//
// Replaces no TPU kernel: the JAX package's MaskRCNNLite keeps its top-K
// locations and suppresses nothing. Mask R-CNN suppresses twice a batch:
// the RPN's candidates within each (image, level), at most 1,000 a segment,
// and the detections within each (image, class), 90 classes of 1,000
// proposals. torchvision's CUDA nms builds an IoU bitmask on the device and
// scans it on the host, a sync a call; here both passes stay on the card.
//
// Input: each segment's boxes sorted by descending score (the wrapper's
// stable sort: ties keep their index order), its first `count` boxes the
// valid ones. IoU(a, b) = inter / (area_a + area_b - inter), each operation
// rounded on its own (`__fmul_rn` and friends, no contraction), so the
// result equals PyTorch's elementwise arithmetic bit for bit; a box
// suppresses a later one where the IoU exceeds the threshold.
//
// Pass 1 (bitmask): a block of 64 threads owns 64 rows against 64 columns of
// one segment; the columns' boxes and areas are staged in shared memory and
// each thread writes one 64-bit word: bit j set where row i suppresses column
// j > i. Tiles left of the diagonal and tiles past the segment's count exit
// at once, so the work is count (count - 1) / 2 pairs a segment, not N^2.
//
// Pass 2 (scan): one warp a segment; lane w holds word w of the removed set
// (N <= 2048: at most 32 words). Box i is kept unless its bit is set (one
// shuffle from its word's lane); a kept box ORs its mask row into the lanes
// at and right of its word. The next row is loaded while the current one is
// decided, so a step costs a shuffle and a branch, not a load's latency.
// The scan is sequential in i by definition; segments run side by side.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

using u64 = unsigned long long;
constexpr int kTile = 64;
constexpr int kScanWarps = 4;
constexpr int kMaxWords = 32;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__global__ void __launch_bounds__(kTile)
    iou_mask_kernel(const float4* __restrict__ boxes, const int* __restrict__ counts,
                    u64* __restrict__ mask, int N, int W, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  const long long s = blockIdx.z;
  const int n = counts[s];
  const int r0 = rb * kTile, c0 = cb * kTile;
  if (cb < rb || r0 >= n || c0 >= n) return;
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const int t = threadIdx.x;
  const int ncol = min(kTile, n - c0);
  if (t < ncol) {
    const float4 b = boxes[s * N + c0 + t];
    cbox[t] = b;
    carea[t] = area(b);
  }
  __syncthreads();
  const int i = r0 + t;
  if (i >= n) return;
  const float4 a = boxes[s * N + i];
  const float aa = area(a);
  u64 bits = 0;
  for (int j = (rb == cb) ? t + 1 : 0; j < ncol; ++j) {
    const float4 b = cbox[j];
    const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
    const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(aa, carea[j]), inter);
    if (__fdiv_rn(inter, uni) > thr) bits |= 1ULL << j;
  }
  mask[(s * N + i) * W + cb] = bits;
}

__global__ void __launch_bounds__(32 * kScanWarps)
    scan_kernel(const u64* __restrict__ mask, const int* __restrict__ counts,
                unsigned char* __restrict__ keep, int S, int N, int W) {
  const long long s = static_cast<long long>(blockIdx.x) * kScanWarps + threadIdx.x / 32;
  if (s >= S) return;
  const int lane = threadIdx.x % 32;
  const int n = counts[s];
  const int words = (n + kTile - 1) / kTile;
  unsigned char* k = keep + s * N;
  for (int i = n + lane; i < N; i += 32) k[i] = 0;
  const u64* rows = mask + s * N * W;
  u64 removed = 0;
  u64 next = (n > 0 && lane < words) ? rows[lane] : 0;
  for (int i = 0; i < n; ++i) {
    const u64 cur = next;
    const int word = i / kTile;
    if (i + 1 < n) {
      const int nw = (i + 1) / kTile;
      next = (lane >= nw && lane < words) ? rows[static_cast<long long>(i + 1) * W + lane] : 0;
    }
    const u64 own = __shfl_sync(0xffffffffu, removed, word);
    const bool kept = !((own >> (i % kTile)) & 1ULL);
    if (lane == 0) k[i] = kept ? 1 : 0;
    if (kept && lane >= word && lane < words) removed |= cur;
  }
}

}  // namespace

// boxes (S, N, 4) fp32 sorted within each segment, counts (S,) int32 (the
// valid boxes first), mask scratch (S, N, ceil(N / 64)) u64, keep (S, N) u8.
extern "C" int eqt_nms_keep(const void* boxes, const void* counts, void* mask, void* keep,
                            int S, int N, float thr, void* stream) {
  const int W = (N + kTile - 1) / kTile;
  if (S < 1 || N < 1 || W > kMaxWords || S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(W, W, S);
  iou_mask_kernel<<<grid, kTile, 0, st>>>(static_cast<const float4*>(boxes),
                                          static_cast<const int*>(counts),
                                          static_cast<u64*>(mask), N, W, thr);
  const int blocks = (S + kScanWarps - 1) / kScanWarps;
  scan_kernel<<<blocks, 32 * kScanWarps, 0, st>>>(static_cast<const u64*>(mask),
                                                  static_cast<const int*>(counts),
                                                  static_cast<unsigned char*>(keep), S, N, W);
  return static_cast<int>(cudaGetLastError());
}
