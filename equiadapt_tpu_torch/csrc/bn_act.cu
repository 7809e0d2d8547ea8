// Eval BatchNorm, an optional residual and ReLU in one pass over
// channels-last activations, fp32 or bf16, for Hopper.
//
// Replaces no TPU kernel: XLA fuses a ResNet's eval BatchNorm, residual add
// and ReLU into the JAX package's convolutions. PyTorch runs them as three
// to five passes of their own (BatchNorm, then the projection's BatchNorm,
// the add, the ReLU), each reading and writing the whole activation: 11.5
// ms of a served ResNet-50 batch of 256 at 224 px, more than its
// convolutions take. For y (N, C, H, W), the raw output of a convolution,
// the kernel writes
//   out = relu(y s_a + t_a [+ r] [+ r s_b + t_b])
// with s = weight / sqrt(running_var + eps) and t = bias - running_mean s
// of each BatchNorm, derived in the kernel from its fp32 parameters and
// statistics. Form 0 has no residual, form 1 adds r (the block's input),
// form 2 adds r s_b + t_b (a projection's raw output with its own
// BatchNorm). Each operation is rounded on its own in fp32 (`__fmul_rn`,
// `__fadd_rn`, no contraction into an FMA), in the order of the plain
// version's PyTorch expression, with one rounding at the store.
//
// Bound. About one operation a byte: bytes alone count. Form 0 reads and
// writes the activation once, forms 1 and 2 read two and write one; the
// floor is those bytes at 3.35 TB/s.
//
// Design. y, r and out are channels-last contiguous: rows of C channels,
// N H W rows. A thread owns 8 channels (one 16-byte word of bf16, two of
// fp32), so C % 8 == 0 and C <= 2048 (a block holds at least one whole
// row). A block is a whole number of rows' worth of threads (at most 256),
// so a thread keeps its 8 channels as it strides over rows: it derives
// their s and t once, then streams rows, loading 64 bytes of each input
// (4 rows of bf16, 2 of fp32) before it computes and stores, so that
// enough loads are in flight. Neighbouring threads touch neighbouring
// words; the grid is as many blocks as the card holds at once, or fewer
// for a small tensor. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVec = 8;            // channels a thread
constexpr int kMaxThreads = 256;   // threads a block
constexpr int kMaxVecs = kMaxThreads;  // C / kVec
constexpr int kBytesInFlight = 64;  // bytes of an input a thread loads before it computes
constexpr int kNone = 0, kIdentity = 1, kProjected = 2;

struct Affine {
  const float* weight;
  const float* bias;
  const float* mean;
  const float* var;
};

// s and t of channels c .. c + 7
__device__ __forceinline__ void channel_affine(const Affine& p, int c, float eps, float* s,
                                               float* t) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s[j] = __fdiv_rn(p.weight[c + j], __fsqrt_rn(__fadd_rn(p.var[c + j], eps)));
    t[j] = __fsub_rn(p.bias[c + j], __fmul_rn(p.mean[c + j], s[j]));
  }
}

// 8 channels of one row as 16-byte words
template <typename T>
struct Pack {
  static constexpr int kWords = static_cast<int>(sizeof(T)) * kVec / 16;
  uint4 w[kWords];
};

__device__ __forceinline__ uint32_t lane(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(uint4& v, int i, uint32_t x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

__device__ __forceinline__ float get(const Pack<float>& p, int j) {
  return __uint_as_float(lane(p.w[j / 4], j % 4));
}

__device__ __forceinline__ float get(const Pack<__nv_bfloat16>& p, int j) {
  const uint32_t x = lane(p.w[0], j / 2);
  return __uint_as_float(j % 2 ? (x & 0xffff0000u) : (x << 16));
}

__device__ __forceinline__ void put(Pack<float>& p, const float* v) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) set_lane(p.w[j / 4], j % 4, __float_as_uint(v[j]));
}

__device__ __forceinline__ void put(Pack<__nv_bfloat16>& p, const float* v) {
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
    set_lane(p.w[0], k, lo | (hi << 16));
  }
}

template <typename T>
__device__ __forceinline__ void load(Pack<T>& p, const T* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < Pack<T>::kWords; ++i) p.w[i] = __ldg(s + i);
}

template <typename T>
__device__ __forceinline__ void store(T* dst, const Pack<T>& p) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < Pack<T>::kWords; ++i) d[i] = p.w[i];
}

// torch.relu: a NaN stays NaN
__device__ __forceinline__ float relu(float v) { return (v > 0.f || v != v) ? v : 0.f; }

template <typename T, int kForm>
__global__ void __launch_bounds__(kMaxThreads)
bn_act_kernel(const T* __restrict__ y, const T* __restrict__ r, T* __restrict__ out, Affine a,
              Affine b, float eps_a, float eps_b, long long rows, int vecs) {
  constexpr int kRows = kBytesInFlight / (static_cast<int>(sizeof(T)) * kVec);
  const int per_block = blockDim.x / vecs;
  const int c = (threadIdx.x % vecs) * kVec;
  const long long C = static_cast<long long>(vecs) * kVec;
  const long long step = static_cast<long long>(gridDim.x) * per_block;
  float sa[kVec], ta[kVec], sb[kVec], tb[kVec];
  channel_affine(a, c, eps_a, sa, ta);
  if (kForm == kProjected) channel_affine(b, c, eps_b, sb, tb);
  for (long long row = static_cast<long long>(blockIdx.x) * per_block + threadIdx.x / vecs;
       row < rows; row += kRows * step) {
    Pack<T> py[kRows], pr[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long i = row + u * step;
      if (i < rows) {
        load(py[u], y + i * C + c);
        if (kForm != kNone) load(pr[u], r + i * C + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long i = row + u * step;
      if (i < rows) {
        float o[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          float v = __fadd_rn(__fmul_rn(get(py[u], j), sa[j]), ta[j]);
          if (kForm == kIdentity) v = __fadd_rn(v, get(pr[u], j));
          if (kForm == kProjected) {
            v = __fadd_rn(v, __fadd_rn(__fmul_rn(get(pr[u], j), sb[j]), tb[j]));
          }
          o[j] = relu(v);
        }
        Pack<T> po;
        put(po, o);
        store(out + i * C + c, po);
      }
    }
  }
}

template <typename T, int kForm>
int launch(const void* y, const void* r, void* out, const Affine& a, const Affine& b, float eps_a,
           float eps_b, long long rows, int vecs, cudaStream_t stream) {
  constexpr int kRows = kBytesInFlight / (static_cast<int>(sizeof(T)) * kVec);
  const int threads = vecs * (kMaxThreads / vecs);
  const int per_block = threads / vecs;
  int device = 0, sms = 0, resident = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, bn_act_kernel<T, kForm>, threads, 0);
  const long long want = (rows + static_cast<long long>(per_block) * kRows - 1) /
                         (static_cast<long long>(per_block) * kRows);
  const long long fit = static_cast<long long>(sms > 0 ? sms : 1) * (resident > 0 ? resident : 1);
  const int blocks = static_cast<int>(want < fit ? want : fit);
  bn_act_kernel<T, kForm><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(r), static_cast<T*>(out), a, b, eps_a, eps_b,
      rows, vecs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_form(int form, const void* y, const void* r, void* out, const Affine& a,
                const Affine& b, float eps_a, float eps_b, long long rows, int vecs,
                cudaStream_t stream) {
  if (form == kNone) return launch<T, kNone>(y, r, out, a, b, eps_a, eps_b, rows, vecs, stream);
  if (form == kIdentity) {
    return launch<T, kIdentity>(y, r, out, a, b, eps_a, eps_b, rows, vecs, stream);
  }
  return launch<T, kProjected>(y, r, out, a, b, eps_a, eps_b, rows, vecs, stream);
}

}  // namespace

// params: the 8 fp32 (C,) pointers weight, bias, running_mean, running_var of
// y's BatchNorm, then of r's (form 2; unread otherwise). y, r and out 16-byte
// aligned, channels-last contiguous, rows = N H W rows of `channels`.
// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int eqt_bn_act(const void* y, const void* r, void* out, const void* const* params,
                          float eps_a, float eps_b, long long rows, int channels, int form,
                          int dtype, void* stream) {
  if (rows < 0 || channels < kVec || channels % kVec != 0 || channels / kVec > kMaxVecs ||
      form < kNone || form > kProjected || dtype < 0 || dtype > 1 ||
      (form != kNone && r == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Affine a{static_cast<const float*>(params[0]), static_cast<const float*>(params[1]),
                 static_cast<const float*>(params[2]), static_cast<const float*>(params[3])};
  const Affine b{static_cast<const float*>(params[4]), static_cast<const float*>(params[5]),
                 static_cast<const float*>(params[6]), static_cast<const float*>(params[7])};
  const int vecs = channels / kVec;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_form<float>(form, y, r, out, a, b, eps_a, eps_b, rows, vecs, s);
  return launch_form<__nv_bfloat16>(form, y, r, out, a, b, eps_a, eps_b, rows, vecs, s);
}
