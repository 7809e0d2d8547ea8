// SAM's attention with its decomposed relative-position bias, fused, for
// Hopper.
//
// Replaces no TPU kernel: the JAX package writes this attention out as
// products and a softmax (equiadapt_tpu/models/sam_encoder.py), and so does
// the port's written-out path (models/sam_encoder.SamAttention._attend),
// which keeps the (B, heads, N, N) scores in device memory: 3.2 GB of bf16
// a global block of SAM ViT-B at 1024 px (B 8, 12 heads, N 4096), biased in
// place and read three more times. Here no score reaches device memory.
//
// For q, k, v (B, N, heads, HD) bf16 over an H x W token grid (N = H * W)
// and the bias tables rel_h (B, heads, N, H) and rel_w (B, heads, N, W) bf16
// (the encoder's two einsums of the unscaled q), each head's output is
//   softmax_j((q_i . k_j) / sqrt(HD) + rel_h[i, j / W] + rel_w[i, j % W]) v_j
// written as (B, N, heads * HD) bf16, the layout `proj` reads. Without
// tables (rel_h null) the bias is left out.
//
// Bound. At the global shape the two products are 4 B heads N^2 HD = 412
// GFLOP, 0.42 ms at the card's 989 TFLOP/s, against 0.30 GB of q, k, v,
// tables and output (0.09 ms at 3.35 TB/s): tensor-core FLOPs, with the
// softmax's exponentials and the bias adds (about eight operations a
// score) beside them. At the windowed shape (200 windows of 14 x 14, N 196)
// the products are 24 GFLOP and the bytes 0.27 GB: bytes, 0.08 ms.
//
// Design (FlashAttention-2's online softmax, on mma.sync). A block is 4
// warps of MT m-tiles (16 query rows each) of one (batch, head); it streams
// the keys and values in tiles of 64 through shared memory, the next tile's
// cp.async copies in flight while the current one is used (two buffers, one
// barrier a tile). q, k and v are read by their strides straight from the
// qkv linear's output, 16 bytes a copy. Both products run on the tensor
// cores (m16n8k16, bf16 operands, fp32 sums), their operands taken from
// shared memory by ldmatrix (rows padded by 16 bytes, so the eight rows of
// a matrix fall on distinct banks); each K and V fragment serves the warp's
// MT m-tiles; q's fragments stay in registers for the whole loop (the q
// tile is staged in the second K, V buffer before the loop starts). The
// scores of a tile stay in registers, P rounded to bf16 as the A operand of
// P . V from the scores' registers; the running max and sum are fp32 (the
// sum reduced across a row's four lanes once, at the end), the scale folded
// into the exponent, exp2 one MUFU instruction.
//
// The bias without a division a score: the keys are laid out in slots, H
// rows of SW (the power of two at or above W, at least 8), slot J = jh SW +
// jw, an empty slot a zero K and V row masked to -inf. An 8-slot n-tile
// then lies in one key row, so a thread's two keys of it have one rel_h
// column and rel_w columns jw, jw + 1. The block stages its rows of both
// tables once, fp32 in units of the scale (times sqrt(HD)), zero past H and
// W, the loads of a warp's rows all in flight before it stores; a row's
// pair (r, r + 8) side by side, rel_w by column pair, so a thread reads its
// rows' rel_h with one 8-byte load (again only when an n-tile starts a key
// row) and its four rel_w values with one 16-byte load, the lanes of a warp
// on distinct banks. The bias is the scores' accumulators' initial value,
// ahead of q . k on the tensor cores, so it stays off the path from the
// product to the softmax. One path serves any grid whose tables fit in
// shared memory: SAM's 64 x 64 global grid (SW = W, no empty slot) and its
// 14 x 14 windows (SW 16) alike. The output goes through the warp's rows of
// the second buffer to 16-byte stores.
//
// Two tile plans, chosen by the wrapper from N: MT 2 (128 rows a block)
// for long sequences, MT 1 (64 rows) for short ones. HD is a template
// parameter, instantiated at SAM's 64. Offsets are 64-bit; the grid is
// (B heads, query tiles), so B heads may reach 2^31 - 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kBlockN = 64;           // keys a tile
constexpr int kRowPad = 8;            // bf16 padding of a shared q/k/v row
constexpr int kTablePad = 4;          // fp32 padding of a table column
constexpr float kLog2e = 1.4426950408889634f;

// strides in elements, in the order the wrapper passes them
struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh, hb, hh, hn, wb, wh, wn, ob, on;
};
static_assert(sizeof(Strides) == 17 * sizeof(long long), "17 strides");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x, one MUFU instruction (flushes denormal results to 0; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the position of a block row in its table column: the rows r and r + 8
// (r < 8) of each group of 16 side by side
__device__ __forceinline__ int table_pos(int row) {
  return (row & ~15) + 2 * (row & 7) + ((row >> 3) & 1);
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// a block: kWarps warps of MT m-tiles (16 rows) each
template <int HD, int MT>
struct Layout {
  static constexpr int kBM = 16 * MT * kWarps;    // query rows a block
  static constexpr int kRS = HD + kRowPad;        // a shared q/k/v row, bf16
  static constexpr int kTS = kBM + kTablePad;     // a table column, fp32
  static constexpr int kChunks = HD / 8;          // 16-byte copies a row
  static_assert(kBM <= 2 * kBlockN, "the q tile lies in the second K, V buffer");
  // bytes: two buffers of a K and a V tile (the q tile in the second one
  // until the loop starts); then the tables, HP + SW columns (Slots)
  static constexpr int kFixed = 4 * kBlockN * kRS * 2;
  static int bytes(int hp, int sw, bool bias) { return kFixed + (bias ? (hp + sw) * kTS * 4 : 0); }
};

// The keys' slots: the H x W key grid laid out on H rows of SW slots (SW
// the power of two at or above W, at least 8, so an 8-key n-tile never
// spans two key rows), slot J = jh SW + jw; tiles of 64 slots, HP the slot
// rows they cover (the tables' rel_h columns, zero past H).
struct Slots {
  int lsw, tiles, hp;
  explicit Slots(int H, int W) {
    lsw = 3;
    while ((1 << lsw) < W) ++lsw;
    tiles = ((H << lsw) + kBlockN - 1) / kBlockN;
    hp = ((tiles * kBlockN) + (1 << lsw) - 1) >> lsw;
  }
};

template <int HD, int MT>
__global__ void __launch_bounds__(kThreads)
    sam_attention_fwd(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ rh,
                      const __nv_bfloat16* __restrict__ rw, __nv_bfloat16* __restrict__ out,
                      Strides st, int nh, int N, int H, int W, int lsw, int tiles, int hp,
                      float scale_log2, float inv_scale) {
  using L = Layout<HD, MT>;
  constexpr int BM = L::kBM, RS = L::kRS, TS = L::kTS, CH = L::kChunks;
  constexpr int KSTEPS = HD / 16;   // k-steps of q . k
  constexpr int DTILES = HD / 8;    // n-tiles of the output
  constexpr int NTILES = kBlockN / 8;
  constexpr int BUF = 2 * kBlockN * RS;  // a buffer: K tile, then V tile

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem);  // two buffers
  __nv_bfloat16* sQ = sKV + BUF;                                // the second
  float* sRH = reinterpret_cast<float*>(sKV + 2 * BUF);         // HP columns
  float* sRW = sRH + hp * TS;                                   // SW columns
  const int SW = 1 << lsw;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const long long bh = blockIdx.x;
  const long long b = bh / nh, h = bh % nh;
  const int m0 = blockIdx.y * BM;
  const int w0 = warp * 16 * MT;  // the warp's first row in the block
  const bool bias = rh != nullptr;
  const __nv_bfloat16* kb = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + h * st.vh;

  // tile t's slots; an empty slot (jw >= W or jh >= H) is a zero row
  auto load_kv = [&](int t, int buf) {
    __nv_bfloat16* dst = sKV + buf * BUF;
    for (int i = tid; i < kBlockN * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8, slot = t * kBlockN + r;
      const int jh = slot >> lsw, jw = slot & (SW - 1);
      const bool ok = jw < W && jh < H;
      const long long j = ok ? jh * W + jw : 0;
      cp_async16(dst + r * RS + c, kb + j * st.kn + c, ok);
      cp_async16(dst + (kBlockN + r) * RS + c, vb + j * st.vn + c, ok);
    }
  };

  // prologue: q and the first K, V tile in flight; the tables staged,
  // zero past H and W
  {
    const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
    for (int i = tid; i < BM * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8, row = m0 + r;
      const bool ok = row < N;
      cp_async16(sQ + r * RS + c, qb + (ok ? row : 0) * st.qn + c, ok);
    }
  }
  load_kv(0, 0);
  cp_async_commit();
  if (bias) {
    // a warp its 16 MT rows, a lane a column of either table; the rows'
    // loads all in flight before the first store
    constexpr int RPW = BM / kWarps;
    for (int c = lane; c < hp + SW; c += 32) {
      const bool is_h = c < hp;
      const int cc = is_h ? c : c - hp, lim = is_h ? H : W;
      const __nv_bfloat16* src = (is_h ? rh + b * st.hb + h * st.hh : rw + b * st.wb + h * st.wh) + cc;
      const long long sn = is_h ? st.hn : st.wn;
      float x[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int row = m0 + w0 + i;
        x[i] = row < N && cc < lim ? __bfloat162float(src[row * sn]) * inv_scale : 0.f;
      }
      // rel_h by column; rel_w by column pair, a row's two values side by side
      float* dst = is_h ? sRH + cc * TS : sRW + (cc >> 1) * 2 * TS + (cc & 1);
      const int step = is_h ? 1 : 2;
#pragma unroll
      for (int i = 0; i < RPW; ++i) dst[table_pos(w0 + i) * step] = x[i];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  unsigned qf[MT][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      ldsm_x4(qf[mt][ks], sQ + (w0 + mt * 16 + (lane & 15)) * RS + ks * 16 + (lane >> 4) * 8);
    }
  }
  __syncthreads();  // every warp holds its q before the second buffer is reused

  float o[MT][DTILES][4];
  float m_r[MT][2], l_r[MT][2];  // running max and sum of rows g, g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      o[mt][dt][0] = o[mt][dt][1] = o[mt][dt][2] = o[mt][dt][3] = 0.f;
    }
    m_r[mt][0] = m_r[mt][1] = -INFINITY;
    l_r[mt][0] = l_r[mt][1] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile t landed; every warp is done with tile t - 1
    }
    if (t + 1 < tiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* tK = sKV + buf * BUF;
    const __nv_bfloat16* tV = tK + kBlockN * RS;

    // the scores' accumulators start at the bias (its tables staged in
    // units of the scale, sqrt(HD)), -inf at an empty slot. An n-tile's 8
    // slots lie in key row jh, this thread's two at columns jw, jw + 1:
    // rel_h of its rows (g, g + 8) is one 8-byte load, taken again only
    // when an n-tile starts a key row, rel_w one 16-byte load
    const bool ragged = W != SW || (t + 1) * kBlockN > (H << lsw);
    float s[MT][NTILES][4];
    float2 rh2[MT];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      const int base = t * kBlockN + nt * 8;
      const int jh = base >> lsw, jw = (base & (SW - 1)) + 2 * tq;
      const bool new_row = nt == 0 || (base & (SW - 1)) == 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* a = s[mt][nt];
        a[0] = a[1] = a[2] = a[3] = 0.f;
        if (bias) {
          const int tpos = w0 + mt * 16 + 2 * g;
          if (new_row) rh2[mt] = *reinterpret_cast<const float2*>(sRH + jh * TS + tpos);
          const float4 rw4 = *reinterpret_cast<const float4*>(sRW + (jw >> 1) * 2 * TS + 2 * tpos);
          a[0] = rh2[mt].x + rw4.x;
          a[1] = rh2[mt].x + rw4.y;
          a[2] = rh2[mt].y + rw4.z;
          a[3] = rh2[mt].y + rw4.w;
        }
        if (ragged) {
          if (jh >= H || jw >= W) a[0] = a[2] = -INFINITY;
          if (jh >= H || jw + 1 >= W) a[1] = a[3] = -INFINITY;
        }
      }
    }

    // scores += q . k over HD, 16 MT x 64 a warp; each K fragment serves
    // the warp's MT m-tiles
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        unsigned kf[4];
        ldsm_x4(kf, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * RS + ks * 16 +
                        ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][ks], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qf[mt][ks], kf[2], kf[3]);
        }
      }
    }

    // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) of each
    // m-tile; scores and running max in units of the scale
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
      float alpha[2], sum[2] = {0.f, 0.f};
      float off[2];  // the row's max in log2 units, taken off in the exponent
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m_r[mt][r], mx[r]);
        alpha[r] = ex2((m_r[mt][r] - mn) * scale_log2);
        m_r[mt][r] = mn;
        off[r] = mn * scale_log2;
      }
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][nt][e] = ex2(fmaf(s[mt][nt][e], scale_log2, -off[e >> 1]));
          sum[e >> 1] += s[mt][nt][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[mt][r] = l_r[mt][r] * alpha[r] + sum[r];
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][dt][e] *= alpha[e >> 1];
      }
    }

    // o += P . V, P in bf16 from the scores' registers; each V fragment
    // serves the warp's MT m-tiles
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      unsigned pf[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pf[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pf[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pf[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pf[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        unsigned vf[4];
        ldsm_x4_trans(vf, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + dp * 16 +
                              (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * dp], pf[mt], vf[0], vf[1]);
          mma(o[mt][2 * dp + 1], pf[mt], vf[2], vf[3]);
        }
      }
    }
  }

  // normalise; the warp's rows through shared memory (the second buffer,
  // after every warp is done with the last tile), then 16-byte stores
  __syncthreads();
  __nv_bfloat16* wQ = sQ + w0 * RS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / l;
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      *reinterpret_cast<unsigned*>(wQ + (mt * 16 + g) * RS + dt * 8 + 2 * tq) =
          pack_bf16(o[mt][dt][0] * inv[0], o[mt][dt][1] * inv[0]);
      *reinterpret_cast<unsigned*>(wQ + (mt * 16 + g + 8) * RS + dt * 8 + 2 * tq) =
          pack_bf16(o[mt][dt][2] * inv[1], o[mt][dt][3] * inv[1]);
    }
  }
  __syncwarp();
  __nv_bfloat16* ob = out + b * st.ob + h * HD;
  for (int i = lane; i < 16 * MT * CH; i += 32) {
    const int r = i / CH, c = (i % CH) * 8, row = m0 + w0 + r;
    if (row < N) {
      *reinterpret_cast<int4*>(ob + row * st.on + c) =
          *reinterpret_cast<const int4*>(wQ + r * RS + c);
    }
  }
}

template <int HD, int MT>
int launch(const void* q, const void* k, const void* v, const void* rh, const void* rw,
           void* out, const Strides& st, int nh, int N, int H, int W, int grid_x, int grid_y,
           cudaStream_t stream) {
  using L = Layout<HD, MT>;
  if (grid_y != (N + L::kBM - 1) / L::kBM) return static_cast<int>(cudaErrorInvalidValue);
  const Slots sl(H, W);
  const int bytes = L::bytes(sl.hp, 1 << sl.lsw, rh != nullptr);
  auto kernel = sam_attention_fwd<HD, MT>;
  static int allowed = 0;  // the dynamic shared memory this kernel may take
  if (bytes > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = bytes;
  }
  kernel<<<dim3(grid_x, grid_y), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(rh),
      static_cast<const __nv_bfloat16*>(rw), static_cast<__nv_bfloat16*>(out), st, nh, N, H, W,
      sl.lsw, sl.tiles, sl.hp, static_cast<float>(kLog2e / std::sqrt(static_cast<double>(HD))),
      static_cast<float>(std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, rel_h, rel_w (rel_h and rel_w null without the bias) and out by
// pointer; `strides` the 17 element strides in Strides' order; hd 64; mt
// the m-tiles a warp (1 or 2); grid_x = B heads, grid_y = the query tiles
// of 64 mt rows. Returns a cudaError_t.
extern "C" int eqt_sam_attention(const void* q, const void* k, const void* v, const void* rh,
                                 const void* rw, void* out, const long long* strides, int nh,
                                 int N, int hd, int H, int W, int mt, int grid_x, int grid_y,
                                 void* stream) {
  if ((rh == nullptr) != (rw == nullptr) || nh < 1 || N < 1 || H * W != N || grid_x < 1 ||
      grid_y < 1 || grid_x % nh != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  std::memcpy(&st, strides, sizeof st);
  const auto s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && mt == 1) {
    return launch<64, 1>(q, k, v, rh, rw, out, st, nh, N, H, W, grid_x, grid_y, s);
  }
  if (hd == 64 && mt == 2) {
    return launch<64, 2>(q, k, v, rh, rw, out, st, nh, N, H, W, grid_x, grid_y, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
