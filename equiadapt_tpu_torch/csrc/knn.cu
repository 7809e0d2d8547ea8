// Fused k-nearest-neighbour indices (K8) for Hopper.
//
// Replaces the Pallas TPU kernel equiadapt_tpu/ops/pallas/knn.py
// (pallas_knn_indices, body _knn_kernel). For every point q of every cloud it
// returns the k indices of the largest
//   d(q, p) = (2 <q, p> - |q|^2) - |p|^2,
// the negative squared distance, nearest first and self included, in the
// order of k rounds of first-occurrence argmax over the row with each pick
// masked to -inf: NaN above every number, then the larger value, then the
// smaller index. The (B, N, N) distance matrix never reaches device memory.
//
// Bound. 2 B N^2 D FLOP (the distance products) over the card's fp32 rate
// (H100 SXM: 67 TFLOP/s): 0.0060 ms at D = 3, 0.128 ms at D = 64 and
// 0.256 ms at D = 128, for B = 64, N = 1024. The bytes (B N D 4 in,
// B N k 4 out) take less time at every D, so the kernel is bound by
// operations. Its first design lost most of its time elsewhere: k rounds
// that each rescanned the row of N distances (at D = 3 all of its 0.94 ms),
// |p|^2 recomputed by every warp for its own query, and one FMA fed by two
// shared-memory loads (one query a warp, one key a lane).
//
// Design. A block of W warps serves Q = W q query rows of one cloud, warp
// w the rows w q .. w q + q - 1; grid (ceil(N / Q), B).
// - Distances. The queries sit in shared memory transposed ([D][Q]). The
//   cloud streams through a 128-key tile in chunks of kDc dimensions,
//   stored transposed and XOR-swizzled ([kDc][128], `swizzled`, so the
//   staging stores and the float4 reads are free of bank conflicts but for
//   2 lanes a bank); each thread holds a q x 4 register tile (its warp's q
//   queries x its lane's 4 keys) and per dimension reads q / 4 broadcast
//   float4s of queries and one float4 of keys for 4 q FMAs. The next
//   chunk's global loads are issued into registers before the current
//   chunk is used. The tile's key norms |p|^2 are formed once, in shared
//   memory, carried from chunk to chunk. Staging divides by no runtime
//   value.
// - Selection, two routes (`by_width`):
//   * streaming (D > 4, k <= 32; 8 warps of 8 queries): per row, the warp
//     keeps the 32 best (key, index) pairs seen so far as one sorted list
//     across its lanes and admits an entry only above the row's k-th best,
//     into a 32-entry buffer; a full buffer is sorted and merged into the
//     list (`StreamRow`). No row is stored, so a block holds 64 queries
//     and each staged key feeds 8 of them.
//   * rows (D <= 4, or k > 32): each distance's order key goes to the
//     warp's rows of shared memory (Q rows of N keys, 128 KB at the
//     limits: 4 warps of 4 queries for N <= 1024 at D <= 4, 8 warps of 4
//     at D > 4, 2 warps of 4 above), and each lane keeps, per query, the
//     largest key among its own entries. Then, by each warp for its q rows
//     together (their shuffle and load chains overlap): the k-th largest
//     of the 32 lanes' best keys (a bitonic sort of 32 across the warp) is
//     a lower bound T of the k-th pick's key, since those are k distinct
//     entries (k <= 32). One pass over the row compacts the entries at or
//     above T by ballots (about 30 for random clouds at N = 1024, k = 20);
//     if they are at most 64, a bitonic sort of 64 across the warp orders
//     them and lane j writes pick j. Otherwise (heavy ties, or k > 32) k
//     rounds of a warp-wide maximum over the row pick them one by one:
//     correct for every N <= 4096 and k <= 128, and as slow as the first
//     design.
//   Either way each distance is handled a bounded number of times, not k.
//
// Order key. u(v) maps fp32 to uint32 so that the order of u is the pick
// order of v: every NaN (any payload) to 0xffffffff, above +inf; -0.0 to
// +0.0's key first, so the two tie; then sign-magnitude to a monotone
// unsigned code. The pair (u, index) packs into 64 bits as
// u << 32 | (0xffffffff - index), so the larger packed key is the pick,
// ties in u going to the smaller index, never to the order of arrival.
// -inf distances (u = 0x007fffff) are never picked: the rounds of the plain
// version mask each pick to -inf, so once the entries above -inf are spent
// every later round finds a row of -inf and picks index 0. The kernel
// writes 0 there too. `ops/kernels/knn.py::select_by_order_key` is the
// plain PyTorch model of this key and rule.
//
// Numerics. Input is fp32 or bf16 and is widened to fp32 on load.
// - D <= 4 (coordinates): __fmul_rn / __fadd_rn in the order of the plain
//   version (ops/kernels/knn.py::knn_indices_plain, and the JAX package's
//   pointcloud/networks.py:77-83): inner = q0 p0, then inner += q_d p_d;
//   |q|^2 and |p|^2 alike; then (2 inner - |q|^2) - |p|^2. nvcc would
//   otherwise contract a*b+c into an FMA, so the indices are bit-equal to the
//   plain version only because every step is spelled out.
// - D > 4 (features): each pair's sum is one fmaf chain over d = 0 .. D-1,
//   and each norm too (no BLAS, no tensor cores, no TF32). It rounds
//   differently from the plain version's matrix product, so the two may
//   order two points differently only where their distances tie at fp32
//   level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

// limits the wrapper (ops/kernels/knn.py) states and checks as well
constexpr int kMaxN = 4096;
constexpr int kMaxD = 256;
constexpr int kMaxK = 128;

constexpr int kKl = 4;                    // keys a lane (register tile columns)
constexpr int kKeyTile = 32 * kKl;        // keys staged at a time
constexpr int kCand = 64;                 // entries the fast selection sorts
constexpr int kWideN = 1024;              // the largest N of the wide blocks
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfKey = 0x007fffffu;  // order_key(-inf)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  unsigned bits = __float_as_uint(v);
  if (bits == 0x80000000u) bits = 0u;  // -0.0 ties with +0.0
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(unsigned u, int i) {
  return (static_cast<unsigned long long>(u) << 32) |
         (0xffffffffu - static_cast<unsigned>(i));
}

__device__ __forceinline__ int index_of(unsigned long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

// One compare-exchange of a bitonic network across the warp: the element of
// this lane against the one `stride` lanes away; `desc` says the block's
// direction, the lower element of a descending pair keeps the larger.
__device__ __forceinline__ unsigned long long exchange(unsigned long long v,
                                                       int stride, bool desc,
                                                       int lane) {
  const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
  const bool low = (lane & stride) == 0;
  return low == desc ? max(v, o) : min(v, o);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = max(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// The k picks of each of a warp's kRowsW rows of N order keys (row r at
// rows + r * np) into o + r * k, for the rows r < live. mine[r] is the
// largest valid order key of row r among this lane's entries (0 if none).
// The rows go through each step together, so their shuffle and load chains
// overlap.
template <int kRowsW>
__device__ void select_rows(unsigned* rows, int np, int live, int N, int k,
                            const unsigned (&mine)[kRowsW],
                            unsigned long long* cand, int* __restrict__ o,
                            int lane) {
  // t[r]: the k-th largest of the lanes' bests, a lower bound of row r's
  // k-th pick (k <= 32; else 0, which admits every entry above -inf)
  unsigned t[kRowsW];
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) t[r] = mine[r];
  if (k <= 32) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const bool low = (lane & stride) == 0;
        const bool desc = (lane & size) == 0;
#pragma unroll
        for (int r = 0; r < kRowsW; ++r) {
          const unsigned other = __shfl_xor_sync(kFull, t[r], stride);
          t[r] = low == desc ? max(t[r], other) : min(t[r], other);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) t[r] = __shfl_sync(kFull, t[r], k - 1);
  } else {
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) t[r] = 0u;
  }
  int m[kRowsW];  // entries at or above t
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) m[r] = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < N; c += 32) {
    const int i = c + lane;
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) {
      const unsigned u = i < N ? rows[r * np + i] : 0u;
      const bool take = u > kNegInfKey && u >= t[r];
      const unsigned ballot = __ballot_sync(kFull, take);
      if (take) {
        const int at = m[r] + __popc(ballot & below);
        if (at < kCand) cand[r * kCand + at] = pack(u, i);
      }
      m[r] += __popc(ballot);
    }
  }
  __syncwarp();
  unsigned long long a0[kRowsW], a1[kRowsW];
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    a0[r] = lane < m[r] && m[r] <= kCand ? cand[r * kCand + lane] : 0ull;
    a1[r] = lane + 32 < m[r] && m[r] <= kCand ? cand[r * kCand + lane + 32] : 0ull;
  }
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < kRowsW; ++r) {
        if (stride == 32) {  // the partner is the lane's other element
          const unsigned long long hi = max(a0[r], a1[r]);
          a1[r] = min(a0[r], a1[r]);
          a0[r] = hi;
        } else {
          a0[r] = exchange(a0[r], stride, (lane & size) == 0, lane);
          a1[r] = exchange(a1[r], stride, ((lane + 32) & size) == 0, lane);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    if (r >= live || m[r] > kCand) continue;  // uniform in the warp
    int* orow = o + r * k;
    if (lane < k) orow[lane] = lane < m[r] ? index_of(a0[r]) : 0;
    if (lane + 32 < k) orow[lane + 32] = lane + 32 < m[r] ? index_of(a1[r]) : 0;
    for (int j = 64 + lane; j < k; j += 32) orow[j] = 0;
  }
  // more than kCand entries at or above t (heavy ties, or k > 32): k
  // rounds of a warp-wide maximum over the row
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    if (r >= live || m[r] <= kCand) continue;
    unsigned* row = rows + r * np;
    for (int s = 0; s < k; ++s) {
      unsigned long long best = 0;
      for (int i = lane; i < N; i += 32) {
        const unsigned u = row[i];
        if (u > kNegInfKey) best = max(best, pack(u, i));
      }
      best = warp_max(best);
      if (lane == 0) {
        o[r * k + s] = best != 0 ? index_of(best) : 0;
        if (best != 0) row[index_of(best)] = 0u;  // spent: below every entry
      }
      __syncwarp();
    }
  }
}

// The 32 best of a sorted list (one key a lane, descending) and a buffer
// of n <= 32 keys, sorted: a bitonic sort of the buffer, the elementwise
// maximum of the list and the reversed buffer (the 32 best of both, as a
// bitonic sequence), then a bitonic merge.
__device__ __forceinline__ unsigned long long merge_list(
    unsigned long long list, const unsigned long long* buf, int n, int lane) {
  __syncwarp();  // the buffer's stores are visible
  unsigned long long a = lane < n ? buf[lane] : 0ull;
  __syncwarp();  // every lane has read its entry before the buffer refills
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      a = exchange(a, stride, (lane & size) == 0, lane);
    }
  }
  list = max(list, __shfl_sync(kFull, a, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    list = exchange(list, stride, true, lane);
  }
  return list;
}

// Streaming selection (kStream) of one row: the warp keeps the 32 best
// packed keys seen so far as one sorted list across its lanes (lane j the
// j-th best, 0 where empty) and admits a new entry only above the row's
// k-th best, into a 32-entry buffer in shared memory; a full buffer is
// merged into the list.
struct StreamRow {
  unsigned long long list = 0ull;  // this lane's place in the sorted list
  unsigned long long kth = 0ull;   // the k-th best so far (0: fewer)
  int n = 0;                       // entries in the buffer

  __device__ __forceinline__ void merge(const unsigned long long* buf, int k,
                                        int lane) {
    list = merge_list(list, buf, n, lane);
    kth = __shfl_sync(kFull, list, k - 1);
    n = 0;
  }

  // Offer this lane's 4 keys of the row (0: none); every lane of the warp
  // calls it. The keys go through one rolled loop, so the merge's code
  // appears once a row and not once a key.
  __device__ __forceinline__ void offer(const unsigned long long (&keys)[kKl],
                                        unsigned long long* buf, int k,
                                        int lane) {
#pragma unroll 1
    for (int j = 0; j < kKl; ++j) {
      const unsigned long long key =
          j == 0 ? keys[0] : j == 1 ? keys[1] : j == 2 ? keys[2] : keys[3];
      bool take = key > kth;
      unsigned ballot = __ballot_sync(kFull, take);
      if (ballot == 0u) continue;
      if (n + __popc(ballot) > 32) {
        merge(buf, k, lane);
        take = key > kth;
        ballot = __ballot_sync(kFull, take);
      }
      if (take) buf[n + __popc(ballot & ((1u << lane) - 1u))] = key;
      n += __popc(ballot);
    }
  }
};

// dimensions of one staged key chunk: 8 values a thread (4 dimensions at
// D <= 4)
template <int kD, int kWarps>
__host__ __device__ constexpr int chunk_dims() {
  return kD > 0 ? 4 : 8 * kWarps * 32 / kKeyTile;
}

// Staged key (kk, dimension dd) of a chunk sits at dd * kKeyTile +
// swizzled(kk, dd): an XOR of bits 2-4 of kk, so that a lane's 4 keys stay
// one aligned float4 and the transposed stores of a warp spread over the
// banks (at most 2 lanes a bank).
template <int kDc>
__device__ __forceinline__ int swizzled(int kk, int dd) {
  return kk ^ (((dd * (kDc == 4 ? 2 : 1)) & 7) << 2);
}

template <int kD, int kWarps, int kQw, bool kStream>
size_t smem_bytes(int N, int D) {
  constexpr int kQ = kWarps * kQw;
  const size_t np = kStream ? 0 : static_cast<size_t>((N + 3) & ~3);
  return 4 * (kQ * np + static_cast<size_t>(D) * (kQ + 4) +
              chunk_dims<kD, kWarps>() * kKeyTile + kKeyTile + kQ) +
         8 * static_cast<size_t>(kQ) * (kStream ? 32 : kCand);
}

// kD in 1..4: D = kD, fixed-order IEEE products and sums; kD = 0: any D,
// fmaf chains. kWarps warps of kQw queries each (a kQw x 4 register tile).
// kStream: streaming selection (k <= 32), no row buffer.
template <typename T, int kD, int kWarps, int kQw, bool kStream>
__global__ void __launch_bounds__(kWarps * 32, kStream ? 2 : 1)
knn_kernel(const T* __restrict__ points, int* __restrict__ out, int N,
           int d_runtime, int k) {
  static_assert(kQw % 4 == 0, "queries a warp come in float4 groups");
  constexpr bool kExact = kD > 0;
  constexpr int kThreads = kWarps * 32;
  constexpr int kQ = kWarps * kQw;  // queries a block
  constexpr int kQPitch = kQ + 4;
  constexpr int kDc = chunk_dims<kD, kWarps>();
  constexpr int kPer = kKeyTile * kDc / kThreads;  // staged values a thread
  const int D = kExact ? kD : d_runtime;
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = kStream ? 0 : (N + 3) & ~3;
  unsigned* rows = reinterpret_cast<unsigned*>(smem);      // [kQ][np]
  float* qt = reinterpret_cast<float*>(rows + kQ * np);    // [D][kQPitch]
  float* kt = qt + D * kQPitch;                            // [kDc][kKeyTile]
  float* norms = kt + kDc * kKeyTile;                      // [kKeyTile]
  float* sqq = norms + kKeyTile;                           // [kQ]
  // [kQ][kCand], or [kQ][32] buffers with kStream
  auto* cand = reinterpret_cast<unsigned long long*>(sqq + kQ);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const T* cloud = points + static_cast<size_t>(b) * N * D;

  for (int q = warp; q < kQ; q += kWarps) {
    for (int d = lane; d < D; d += 32) {
      qt[d * kQPitch + q] =
          q0 + q < N ? load(cloud + static_cast<size_t>(q0 + q) * D + d) : 0.0f;
    }
  }
  __syncthreads();
  for (int q = tid; q < kQ; q += kThreads) {
    float s;
    if constexpr (kExact) {
      s = __fmul_rn(qt[q], qt[q]);
#pragma unroll
      for (int d = 1; d < kD; ++d) {
        const float v = qt[d * kQPitch + q];
        s = __fadd_rn(s, __fmul_rn(v, v));
      }
    } else {
      s = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float v = qt[d * kQPitch + q];
        s = fmaf(v, v, s);
      }
    }
    sqq[q] = s;
  }

  const int n_chunks = kExact ? 1 : (D + kDc - 1) / kDc;
  const int stages = ((N + kKeyTile - 1) / kKeyTile) * n_chunks;
  T pre[kPer];
  auto fetch = [&](int s) {
    const int t0 = (s / n_chunks) * kKeyTile;
    const int d0 = (s % n_chunks) * kDc;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int e = tid + p * kThreads;
      const int key = t0 + e / kDc;  // kDc is a power of two
      const int dim = d0 + e % kDc;
      pre[p] = key < N && dim < D ? cloud[static_cast<size_t>(key) * D + dim]
                                  : T(0.0f);
    }
  };

  float acc[kQw][kKl];
  unsigned best[kQw];  // this lane's largest valid order key, per query
#pragma unroll
  for (int i = 0; i < kQw; ++i) best[i] = 0u;
  StreamRow sel[kStream ? kQw : 1];
  unsigned long long* buf = cand + warp * kQw * 32;  // kStream: row i at i * 32
  fetch(0);
  for (int s = 0; s < stages; ++s) {
    const int c = s % n_chunks;
    const int t0 = (s / n_chunks) * kKeyTile;
    const int d0 = c * kDc;
    const int dc = min(kDc, D - d0);
    __syncthreads();  // every warp is done with the previous chunk
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int e = tid + p * kThreads;
      const int dd = e % kDc;
      kt[dd * kKeyTile + swizzled<kDc>(e / kDc, dd)] = load(&pre[p]);
    }
    __syncthreads();
    if (s + 1 < stages) fetch(s + 1);  // in flight while this chunk is used

    // the tile's key norms, one fixed-order sum per key across the chunks
    for (int kk = tid; kk < kKeyTile; kk += kThreads) {
      float sq;
      if constexpr (kExact) {
        sq = __fmul_rn(kt[swizzled<kDc>(kk, 0)], kt[swizzled<kDc>(kk, 0)]);
#pragma unroll
        for (int d = 1; d < kD; ++d) {
          const float v = kt[d * kKeyTile + swizzled<kDc>(kk, d)];
          sq = __fadd_rn(sq, __fmul_rn(v, v));
        }
      } else {
        sq = c == 0 ? 0.0f : norms[kk];
        for (int d = 0; d < dc; ++d) {
          const float v = kt[d * kKeyTile + swizzled<kDc>(kk, d)];
          sq = fmaf(v, v, sq);
        }
      }
      norms[kk] = sq;
    }

    auto step = [&](int dd) {
      float qa[kQw];
#pragma unroll
      for (int g = 0; g < kQw; g += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qt + (d0 + dd) * kQPitch + warp * kQw + g);
        qa[g] = qv.x;
        qa[g + 1] = qv.y;
        qa[g + 2] = qv.z;
        qa[g + 3] = qv.w;
      }
      const float4 kv = *reinterpret_cast<const float4*>(
          kt + dd * kKeyTile + swizzled<kDc>(lane * kKl, dd));
      const float ka[kKl] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < kQw; ++i) {
#pragma unroll
        for (int j = 0; j < kKl; ++j) {
          if constexpr (kExact) {
            const float prod = __fmul_rn(qa[i], ka[j]);
            acc[i][j] = dd == 0 ? prod : __fadd_rn(acc[i][j], prod);
          } else {
            acc[i][j] = fmaf(qa[i], ka[j], acc[i][j]);
          }
        }
      }
    };
    if constexpr (kExact) {
#pragma unroll
      for (int dd = 0; dd < kD; ++dd) step(dd);
    } else {
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kQw; ++i) {
#pragma unroll
          for (int j = 0; j < kKl; ++j) acc[i][j] = 0.0f;
        }
      }
      if (dc == kDc) {
#pragma unroll
        for (int dd = 0; dd < kDc; ++dd) step(dd);
      } else {
        for (int dd = 0; dd < dc; ++dd) step(dd);
      }
    }

    if (c == n_chunks - 1) {
      __syncthreads();  // the tile's norms are complete
      const float4 nv = *reinterpret_cast<const float4*>(norms + lane * kKl);
      const float na[kKl] = {nv.x, nv.y, nv.z, nv.w};
      const int key0 = t0 + lane * kKl;
#pragma unroll
      for (int i = 0; i < kQw; ++i) {
        const int q = warp * kQw + i;
        const float sq_q = sqq[q];
        unsigned u[kKl];
        unsigned long long keys[kKl];
#pragma unroll
        for (int j = 0; j < kKl; ++j) {
          u[j] = order_key(__fsub_rn(
              __fsub_rn(__fmul_rn(2.0f, acc[i][j]), sq_q), na[j]));
          const bool valid = key0 + j < N && u[j] > kNegInfKey;
          keys[j] = valid ? pack(u[j], key0 + j) : 0ull;
          if (key0 + j < N) best[i] = max(best[i], u[j]);
        }
        if constexpr (kStream) sel[i].offer(keys, buf + i * 32, k, lane);
        if (!kStream && key0 < np) {
          *reinterpret_cast<uint4*>(rows + q * np + key0) =
              make_uint4(u[0], u[1], u[2], u[3]);
        }
      }
    }
  }
  const int first = q0 + warp * kQw;  // the warp's first query
  if constexpr (kStream) {
#pragma unroll
    for (int i = 0; i < kQw; ++i) {
      if (first + i >= N) break;  // uniform in the warp
      if (sel[i].n > 0) sel[i].merge(buf + i * 32, k, lane);
      if (lane < k) {
        out[(static_cast<size_t>(b) * N + first + i) * k + lane] =
            sel[i].list != 0ull ? index_of(sel[i].list) : 0;
      }
    }
  } else {
    __syncwarp();  // a warp reads only its own rows below
#pragma unroll
    for (int i = 0; i < kQw; ++i) {
      if (best[i] <= kNegInfKey) best[i] = 0u;  // -inf is never picked
    }
    if (first < N) {
      select_rows<kQw>(rows + warp * kQw * np, np, min(kQw, N - first), N, k,
                       best, cand + warp * kQw * kCand,
                       out + (static_cast<size_t>(b) * N + first) * k, lane);
    }
  }
}

template <typename T, int kD, int kWarps, int kQw, bool kStream = false>
int launch(const void* points, int* out, int B, int N, int D, int k,
           cudaStream_t stream) {
  constexpr int kQ = kWarps * kQw;
  const size_t bytes = smem_bytes<kD, kWarps, kQw, kStream>(N, D);
  auto kernel = knn_kernel<T, kD, kWarps, kQw, kStream>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kQ - 1) / kQ, B);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(static_cast<const T*>(points),
                                               out, N, D, k);
  return static_cast<int>(cudaGetLastError());
}

// Block shapes. Streaming (D > 4, k <= 32): 8 warps of 8 queries, two
// blocks an SM. Rows: a block holds at most 32 query rows of N <= 1024 keys
// (128 KB) or 8 rows of N <= 4096; at D <= 4, 4 warps of 4 queries (16
// rows, 64 KB at N = 1024, so more blocks share an SM).
template <typename T, int kD>
int by_width(const void* points, int* out, int B, int N, int D, int k,
             cudaStream_t stream) {
  if constexpr (kD == 0) {
    if (k <= 32) return launch<T, 0, 8, 8, true>(points, out, B, N, D, k, stream);
    if (N > kWideN) return launch<T, 0, 2, 4>(points, out, B, N, D, k, stream);
    return launch<T, 0, 8, 4>(points, out, B, N, D, k, stream);
  } else {
    if (N > kWideN) return launch<T, kD, 2, 4>(points, out, B, N, D, k, stream);
    return launch<T, kD, 4, 4>(points, out, B, N, D, k, stream);
  }
}

template <typename T>
int dispatch(const void* points, int* out, int B, int N, int D, int k,
             cudaStream_t stream) {
  switch (D) {
    case 1: return by_width<T, 1>(points, out, B, N, D, k, stream);
    case 2: return by_width<T, 2>(points, out, B, N, D, k, stream);
    case 3: return by_width<T, 3>(points, out, B, N, D, k, stream);
    case 4: return by_width<T, 4>(points, out, B, N, D, k, stream);
    default: return by_width<T, 0>(points, out, B, N, D, k, stream);
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
