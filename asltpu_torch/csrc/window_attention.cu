// Windowed self-attention with a learned relative-position bias (Video Swin's
// window sub-layers: 3D windows of up to 448 tokens, heads of 32) for Hopper
// (sm_90a), read from and written to the packed q/k/v projection; bound to
// Python with ctypes (asltpu_torch/ops/_build.py builds this file,
// asltpu_torch/ops/window_attention_kernels.py holds the wrappers, the custom
// ops, the launch counters and the plain PyTorch version they are tested
// against).
//
// Replaces no TPU kernel: the JAX package has no Video Swin. It was added for
// Video Swin-B's 24 window sub-layers (31,744 (window, head) pairs of 392
// tokens a step at batch 8), where PyTorch's memory-efficient attention took
// the bias materialised [windows, heads, 392, 392] (gathered from the table,
// plus the shift mask, padded to 400 keys and repeated over the clips), wrote
// its full-size gradient, and left that gradient to be summed over the
// windows and scattered into the table: ~3.7% of the matmuls' roofline.
//
// window_attention_fwd: qkv [N, L, 3 * H * 32] bf16, columns q; k; v, each H
//   heads of 32, N = B * nW windows clip-major; table [rows, H] fp32, the
//   bias table itself; regions [nW, L] int32 (one label a token of each of a
//   clip's windows) or none -> out [N, L, H * 32] bf16, out_rest (what
//   rounding out to bf16 left, rounded too), lse [N, H, L] fp32:
//     s_ij = q_i k_j / sqrt(32) + table[idx(i, j), h]
//            + (regions[w, i] != regions[w, j] ? -100 : 0),
//     out_i = softmax_j(s_ij) v_j, lse_i = log sum_j exp(s_ij).
//   idx(i, j) is the relative-position index of the first L tokens of the
//   full window (wd, wh, ww): with c(t) = d * R0 + h * R1 + w for token t =
//   (d, h, w), R1 = 2 ww - 1, R0 = (2 wh - 1) R1, idx(i, j) = c(i) - c(j) + C0,
//   C0 = c(wd - 1, wh - 1, ww - 1): the offset along each axis shifted to be
//   non-negative in mixed radix, which is what the index [L, L] holds, sliced
//   to a clipped window's first L positions. It is computed, never read.
// window_attention_bwd: grad_out [N, L, H * 32], qkv, out, out_rest, lse,
//   table, regions -> grad_qkv [N, L, 3 * H * 32] bf16, the gradients of q;
//   k; v in qkv's own layout, every value written once, and grad_table
//   [rows, H] fp32 (zeroed by the caller), dS summed over the pairs that
//   share a row, over the windows and over the clips. No [N, H, L, L] tensor
//   is ever written. grad_table's sums use fp32 atomics (in shared memory,
//   then one global atomic a row and block), so their order, and the last
//   bits of grad_table, vary from run to run; grad_qkv is deterministic.
//
// Rounding: products, softmax and the bias in fp32. P (and, backward, dS)
// enter their products as bf16 pairs hi + lo, two mma each, so they carry 16
// bits, and the only roundings to bf16 are the inputs' and each result's.
// The backward recomputes P from lse and takes delta = rowsum(dO * out) with
// out + out_rest, 16 bits of the output: with attention as sharp as training
// makes it, dP - delta is a small difference, and delta from the output
// rounded to bf16 (FlashAttention-2's) would carry 2^-9 of dO.out into every
// dS. dS = P * (dP - delta) (the table's gradient) and dS / sqrt(32) (for dq
// = dS k, dk = dS^T q) in fp32; dv = P^T dO.
//
// Bound: operations. A (window, head) of 392 tokens does 19.7 MFLOP forward
// (q k^T and p v) and 49.2 backward (five products; 2.5x the forward) on 75 KB
// of qkv and out: ~260 FLOP a byte forward, beside the H100's ~295 at which
// its tensor cores bound it, and 2.5x that backward. The least time is the
// matmuls at 989 TFLOP/s: 0.63 ms forward and 1.6 ms backward a step at batch
// 8 (31,744 pairs), against 0.45 + 0.7 ms for the bytes (qkv, out, their
// gradients, lse and the table once) at 3.35 TB/s. At head size 32 each score
// costs 128 FLOP of products against one exp and a bias read, so the
// exponentials and the bias's gather, not the tensor cores, set the pace.
// Measured on an H100 (PERF.md, row 6 of the kernel table): ~5% of the
// matmuls' bound; the backward is five sixths of the pair, and more than
// half of it is the table gradient's shared-memory atomics, which this card
// runs as compare-and-swap loops.
//
// Design for that bound:
// - A block takes one head of a run of consecutive windows (the grid's y is
//   the head): it stages the head's table column once, pre-scaled by log2(e),
//   and in the backward sums the table's gradient in shared memory over all
//   its windows before one global atomic a row. A token's coordinate code
//   c(t) and its region share one int in shared memory (c << 8 | region), so
//   a score's bias is one shared-memory read at c(i) - c(j) and a compare.
// - A window's q, k, v (and dO) of one head, 392 x 32 bf16 each, are copied
//   whole into shared memory with 16-byte cp.async, rows zero-filled to LP
//   (L rounded up to 16) and padded to 80 bytes so ldmatrix is
//   conflict-free. Warps take 16-row tiles in turn; the block has as many
//   warps as spreads the LP / 16 tiles evenly (13 at L = 392).
// - Tensor cores by mma.sync m16n8k16 (bf16 in, fp32 sums) on ldmatrix
//   fragments; keys in chunks of 32, the last 16 masked past L. The forward
//   keeps a running max and sum a row (online softmax), P's accumulators are
//   p.v's A operands (hi and lo) as they are; the exponentials are exp2 of
//   scores scaled by log2(e). The second product of each split operand adds
//   a third to the forward's products and two fifths to the backward's, on
//   a kernel that the exponentials, not the tensor cores, bound.
// - The backward makes two passes over the window with no atomics on
//   grad_qkv: a warp owning 16 query rows recomputes P and dP over all keys
//   and accumulates dq (and the table's gradient, one shared-memory atomic a
//   score, into one of four copies so that no two lanes of an atomic hit one
//   row); a warp owning 16 keys recomputes P^T and dP^T over all queries
//   and accumulates dk and dv. The recomputation (a second exp a score, two
//   more products) buys deterministic dq without an [L, 32] fp32 sum shared
//   by the warps. Padded query rows carry lse = +inf, so their P is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHead = 32;                                 // head size
constexpr int kRow = kHead + 8;                           // a tile's row in shared memory, bf16
constexpr float kScale = 0.17677669529663687f;            // 1 / sqrt(32)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kScaleLog2 = kScale * kLog2e;
constexpr float kMaskLog2 = -100.0f * kLog2e;             // the shift mask, in log2 units
constexpr int kMaxWarps = 14;
constexpr int kMaxLen = 448;
constexpr int kMaxRows = 4096;
// Copies of the table's gradient in shared memory, one for each column
// pair 2t of the mma accumulator layout.
constexpr int kCopies = 4;

// What a launch needs of the windows' shape.
struct Geo {
  int n_seq, len, lp, heads;
  int n_win;             // a clip's windows (regions' rows); 0 for no regions
  int rows, c0;          // the table's rows; idx(i, j) = c(i) - c(j) + c0
  int wh, ww, r0, r1;    // the full window's last two sides; the index's radices
  int per_block;         // consecutive windows a block takes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses. In the accumulator layout lane 4g + t holds rows g and
// g + 8, columns 2t and 2t + 1 of each 8-column tile; ldmatrix's lane l
// gives the address of row l % 8 of 8x8 matrix l / 8.

// A (16x16 at rows m0, columns k0) of a row-major tile.
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                       int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4(a, tile + (m0 + r + 8 * (m & 1)) * kRow + k0 + 8 * (m >> 1));
}

// B[k][n] = tile[n][k] for the 8-column tiles n0 and n0 + 8 and the k-step k0:
// b[0], b[1] for n0; b[2], b[3] for n0 + 8.
__device__ __forceinline__ void b_rows(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                       int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4(b, tile + (n0 + r + 8 * (m >> 1)) * kRow + k0 + 8 * (m & 1));
}

// B[k][n] = tile[k][n], likewise.
__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                       int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4_trans(b, tile + (k0 + r + 8 * (m & 1)) * kRow + n0 + 8 * (m >> 1));
}

// Two fp32 values as bf16 pairs hi + lo: hi rounded, lo what the rounding
// left, rounded too (16 of the fp32 values' 24 bits).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x - hf.x, y - hf.y);
}

// The A operand of k-step kk (columns 16 kk.. 16 kk + 15) from accumulators,
// split into hi + lo.
template <int NT>
__device__ __forceinline__ void a_from_acc(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&s)[NT][4], int kk) {
  split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
  split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
  split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
  split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
}

// s (16 x 8 NT) = A (16 x 32, both k-steps' fragments) times B[k][n] =
// tile[n0 + n][k], the rows n0.. of a tile.
template <int NT>
__device__ __forceinline__ void times_rows(float (&s)[NT][4], const uint32_t (&a)[2][4],
                                           const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      b_rows(b, tile, n0 + 8 * j, 16 * kk, lane);
      mma(s[j], a[kk], b[0], b[1]);
      mma(s[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x 32) += s (16 x 8 NT, as bf16 hi + lo: two products) times the
// rows n0.. n0 + 8 NT of a tile (B[k][n] = tile[n0 + k][n]).
template <int NT>
__device__ __forceinline__ void add_times_cols(float (&acc)[4][4], const float (&s)[NT][4],
                                               const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[4], lo[4];
    a_from_acc<NT>(hi, lo, s, kk);
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      b_cols(b, tile, n0 + 16 * kk, 8 * j, lane);
      mma(acc[j], lo, b[0], b[1]);
      mma(acc[j + 1], lo, b[2], b[3]);
      mma(acc[j], hi, b[0], b[1]);
      mma(acc[j + 1], hi, b[2], b[3]);
    }
  }
}

// 2^x by the special function unit (x <= 0 here; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The score's bias in log2 units: the table's row c(q) - c(k) (tab is offset
// by c0) plus the mask where the two tokens' regions differ.
template <bool kShift>
__device__ __forceinline__ float bias_log2(const float* tab, int tq, int tk) {
  float b = tab[(tq >> 8) - (tk >> 8)];
  if (kShift && ((tq ^ tk) & 255)) b += kMaskLog2;
  return b;
}

// Rows [0, len) of one 32-wide head at `src` (row stride `ld` values) into a
// tile by the whole block; rows [len, lp) zero.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t ld, int len,
                                          int lp) {
  for (int c = threadIdx.x; c < 4 * lp; c += blockDim.x) {
    const int i = c >> 2, col = (c & 3) * 8;
    const bool valid = i < len;
    cp_async16(tile + i * kRow + col, valid ? src + i * ld + col : src, valid);
  }
}

// Each token's coordinate code and, for a shifted window, its region.
__device__ __forceinline__ void load_tokens(int* tok, const int* regions, int seq,
                                            const Geo& g) {
  const int* reg = regions ? regions + static_cast<size_t>(seq % g.n_win) * g.len : nullptr;
  for (int t = threadIdx.x; t < g.lp; t += blockDim.x) {
    int v = 0;
    if (t < g.len) {
      const int d = t / (g.wh * g.ww), h = (t / g.ww) % g.wh, w = t % g.ww;
      v = (d * g.r0 + h * g.r1 + w) << 8;
      if (reg) v |= reg[t] & 255;
    }
    tok[t] = v;
  }
}

// A head's table column, scaled by log2(e), into shared memory.
__device__ __forceinline__ void load_table(float* tab, const float* table, int h,
                                           const Geo& g) {
  for (int r = threadIdx.x; r < g.rows; r += blockDim.x)
    tab[r] = table[static_cast<size_t>(r) * g.heads + h] * kLog2e;
}

// Store an accumulator tile (16 x 32) of rows m0.. (those below len), rows
// g scaled by s0 and g + 8 by s1, into a 32-wide head at `dst` (row stride
// `ld`) rounded to bf16; and, where `rest` is given, what the rounding left,
// rounded too, at the same place of `rest`.
__device__ __forceinline__ void store_rows(bf16* dst, bf16* rest, size_t ld,
                                           const float (&acc)[4][4], float s0, float s1,
                                           int m0, int len, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = m0 + g, r1 = m0 + g + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t hi, lo;
    const size_t at0 = r0 * ld + 8 * j + 2 * t, at1 = r1 * ld + 8 * j + 2 * t;
    split(acc[j][0] * s0, acc[j][1] * s0, hi, lo);
    if (r0 < len) {
      *reinterpret_cast<uint32_t*>(dst + at0) = hi;
      if (rest) *reinterpret_cast<uint32_t*>(rest + at0) = lo;
    }
    split(acc[j][2] * s1, acc[j][3] * s1, hi, lo);
    if (r1 < len) {
      *reinterpret_cast<uint32_t*>(dst + at1) = hi;
      if (rest) *reinterpret_cast<uint32_t*>(rest + at1) = lo;
    }
  }
}

struct FwdRows {
  float m[2], l[2], o[4][4];
};

// One chunk of 8 NT keys from kb for a warp's 16 query rows: the online
// softmax's update and p.v.
template <int NT, bool kShift, bool kTail>
__device__ __forceinline__ void fwd_keys(FwdRows& st, const uint32_t (&qa)[2][4],
                                         const bf16* sk, const bf16* sv, const int* tok,
                                         const float* tab, const int (&ti)[2], int kb, int len,
                                         int lane) {
  const int t = lane & 3;
  float s[NT][4];
  times_rows<NT>(s, qa, sk, kb, lane);
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = kb + 8 * j + 2 * t;
    const int2 tk = *reinterpret_cast<const int2*>(tok + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, k = e & 1;
      float v = s[j][e] * kScaleLog2 + bias_log2<kShift>(tab, ti[r], k ? tk.y : tk.x);
      if (kTail && col + k >= len) v = -INFINITY;
      s[j][e] = v;
      mx[r] = fmaxf(mx[r], v);
    }
  }
  mx[0] = row_max(mx[0]);
  mx[1] = row_max(mx[1]);
  const float alpha[2] = {exp2_approx(st.m[0] - mx[0]), exp2_approx(st.m[1] - mx[1])};
  st.m[0] = mx[0];
  st.m[1] = mx[1];
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(s[j][e] - mx[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
  }
  st.l[0] = st.l[0] * alpha[0] + sum[0];
  st.l[1] = st.l[1] * alpha[1] + sum[1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st.o[j][0] *= alpha[0];
    st.o[j][1] *= alpha[0];
    st.o[j][2] *= alpha[1];
    st.o[j][3] *= alpha[1];
  }
  add_times_cols<NT>(st.o, s, sv, kb, lane);
}

template <bool kShift>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    window_attention_fwd(const bf16* __restrict__ qkv, const float* __restrict__ table,
                         const int* __restrict__ regions, bf16* __restrict__ out,
                         bf16* __restrict__ out_rest, float* __restrict__ lse, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int h = blockIdx.y, lp = g.lp, len = g.len;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + lp * kRow;
  bf16* sv = sk + lp * kRow;
  int* tok = reinterpret_cast<int*>(sv + lp * kRow);
  float* tab = reinterpret_cast<float*>(tok + lp);
  load_table(tab, table, h, g);
  const float* tabc = tab + g.c0;
  const size_t d = static_cast<size_t>(g.heads) * kHead;
  const int first = blockIdx.x * g.per_block;
  const int last = min(g.n_seq, first + g.per_block);
  for (int seq = first; seq < last; ++seq) {
    const bf16* src = qkv + static_cast<size_t>(seq) * len * 3 * d + h * kHead;
    load_tile(sq, src, 3 * d, len, lp);
    load_tile(sk, src + d, 3 * d, len, lp);
    load_tile(sv, src + 2 * d, 3 * d, len, lp);
    load_tokens(tok, kShift ? regions : nullptr, seq, g);
    cp_async_wait_all();
    __syncthreads();
    for (int m0 = 16 * warp; m0 < lp; m0 += 16 * warps) {
      const int gr = lane >> 2;
      uint32_t qa[2][4];
      a_rows(qa[0], sq, m0, 0, lane);
      a_rows(qa[1], sq, m0, 16, lane);
      const int ti[2] = {tok[m0 + gr], tok[m0 + gr + 8]};
      FwdRows st;
      st.m[0] = st.m[1] = -INFINITY;
      st.l[0] = st.l[1] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.0f;
      int kb = 0;
      for (; kb + 32 <= len; kb += 32)
        fwd_keys<4, kShift, false>(st, qa, sk, sv, tok, tabc, ti, kb, len, lane);
      for (; kb < len; kb += 16)
        fwd_keys<2, kShift, true>(st, qa, sk, sv, tok, tabc, ti, kb, len, lane);
      const float l0 = row_sum(st.l[0]), l1 = row_sum(st.l[1]);
      const size_t at = static_cast<size_t>(seq) * len * d + h * kHead;
      store_rows(out + at, out_rest + at, d, st.o, 1.0f / l0, 1.0f / l1, m0, len, lane);
      if ((lane & 3) == 0) {
        float* row = lse + (static_cast<size_t>(seq) * g.heads + h) * len;
        if (m0 + gr < len) row[m0 + gr] = (st.m[0] + log2f(l0)) * kLn2;
        if (m0 + gr + 8 < len) row[m0 + gr + 8] = (st.m[1] + log2f(l1)) * kLn2;
      }
    }
    __syncthreads();  // every warp is done with the tiles before the next window's
  }
}

// Pass 1 of the backward, one chunk of 8 NT keys from kb for a warp's 16
// query rows: P, dP, dS; dq += dS k, the table's gradient += dS. gtab is
// this lane's copy (lane & 3): in one atomic instruction the lanes of one
// copy share the key and differ in the query, so their rows c(i) - c(j)
// differ, and the compare-and-swap loop that a shared-memory float add
// compiles to on this card never retries for a conflict inside the warp.
template <int NT, bool kShift, bool kTail>
__device__ __forceinline__ void bwd_keys(float (&dq)[4][4], const uint32_t (&qa)[2][4],
                                         const uint32_t (&da)[2][4], const bf16* sk,
                                         const bf16* sv, const int* tok, const float* tab,
                                         float* gtab, const int (&ti)[2],
                                         const float (&li)[2], const float (&di)[2], int kb,
                                         int len, int lane) {
  const int t = lane & 3;
  float s[NT][4], dp[NT][4];
  times_rows<NT>(s, qa, sk, kb, lane);
  times_rows<NT>(dp, da, sv, kb, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = kb + 8 * j + 2 * t;
    const int2 tk = *reinterpret_cast<const int2*>(tok + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, k = e & 1;
      const int tkk = k ? tk.y : tk.x;
      const float p =
          exp2_approx(s[j][e] * kScaleLog2 + bias_log2<kShift>(tab, ti[r], tkk) - li[r]);
      const float ds = p * (dp[j][e] - di[r]);
      if (!kTail || col + k < len) atomicAdd(gtab + ((ti[r] >> 8) - (tkk >> 8)), ds);
      s[j][e] = (kTail && col + k >= len) ? 0.0f : ds * kScale;
    }
  }
  add_times_cols<NT>(dq, s, sk, kb, lane);
}

// Pass 2 of the backward, one chunk of 8 NT queries from qb for a warp's 16
// keys: P^T, dP^T, dS^T; dv += P^T dO, dk += dS^T q.
template <int NT, bool kShift>
__device__ __forceinline__ void bwd_queries(float (&dk)[4][4], float (&dv)[4][4],
                                            const uint32_t (&ka)[2][4],
                                            const uint32_t (&va)[2][4], const bf16* sq,
                                            const bf16* sdo, const int* tok, const float* tab,
                                            const float* slse, const float* sdelta,
                                            const int (&tj)[2], int qb, int lane) {
  const int t = lane & 3;
  float p[NT][4], ds[NT][4];
  times_rows<NT>(p, ka, sq, qb, lane);
  times_rows<NT>(ds, va, sdo, qb, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = qb + 8 * j + 2 * t;
    const int2 tq = *reinterpret_cast<const int2*>(tok + col);
    const float2 lq = *reinterpret_cast<const float2*>(slse + col);
    const float2 dq = *reinterpret_cast<const float2*>(sdelta + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, k = e & 1;
      const float pe = exp2_approx(p[j][e] * kScaleLog2 +
                             bias_log2<kShift>(tab, k ? tq.y : tq.x, tj[r]) - (k ? lq.y : lq.x));
      ds[j][e] = pe * (ds[j][e] - (k ? dq.y : dq.x)) * kScale;
      p[j][e] = pe;
    }
  }
  add_times_cols<NT>(dv, p, sdo, qb, lane);
  add_times_cols<NT>(dk, ds, sq, qb, lane);
}

template <bool kShift>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    window_attention_bwd(const bf16* __restrict__ grad_out, const bf16* __restrict__ qkv,
                         const bf16* __restrict__ out, const bf16* __restrict__ out_rest,
                         const float* __restrict__ lse,
                         const float* __restrict__ table, const int* __restrict__ regions,
                         bf16* __restrict__ grad_qkv, float* __restrict__ grad_table, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int h = blockIdx.y, lp = g.lp, len = g.len;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + lp * kRow;
  bf16* sv = sk + lp * kRow;
  bf16* sdo = sv + lp * kRow;
  int* tok = reinterpret_cast<int*>(sdo + lp * kRow);
  float* slse = reinterpret_cast<float*>(tok + lp);  // log2 units; +inf past len
  float* sdelta = slse + lp;                          // rowsum(dO * out); 0 past len
  float* tab = sdelta + lp;
  // The table's gradient, one copy for each lane & 3 (see bwd_keys).
  float* gtab = tab + g.rows;
  load_table(tab, table, h, g);
  for (int r = threadIdx.x; r < kCopies * g.rows; r += blockDim.x) gtab[r] = 0.0f;
  const float* tabc = tab + g.c0;
  float* gtabc = gtab + (lane & 3) * g.rows + g.c0;
  const size_t d = static_cast<size_t>(g.heads) * kHead;
  const int first = blockIdx.x * g.per_block;
  const int last = min(g.n_seq, first + g.per_block);
  for (int seq = first; seq < last; ++seq) {
    const size_t row0 = static_cast<size_t>(seq) * len;
    const bf16* src = qkv + row0 * 3 * d + h * kHead;
    load_tile(sq, src, 3 * d, len, lp);
    load_tile(sk, src + d, 3 * d, len, lp);
    load_tile(sv, src + 2 * d, 3 * d, len, lp);
    load_tile(sdo, grad_out + row0 * d + h * kHead, d, len, lp);
    load_tokens(tok, kShift ? regions : nullptr, seq, g);
    const float* lrow = lse + (static_cast<size_t>(seq) * g.heads + h) * len;
    for (int i = threadIdx.x; i < lp; i += blockDim.x)
      slse[i] = i < len ? lrow[i] * kLog2e : INFINITY;
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < lp; i += blockDim.x) {
      float acc = 0.0f;
      if (i < len) {
        const size_t at = (row0 + i) * d + h * kHead;
        const uint4* o = reinterpret_cast<const uint4*>(out + at);
        const uint4* orest = reinterpret_cast<const uint4*>(out_rest + at);
        const uint4* go = reinterpret_cast<const uint4*>(sdo + i * kRow);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 a = o[c], r = orest[c], b = go[c];
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
          const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(a2[e]), xr = __bfloat1622float2(r2[e]);
            const float2 y = __bfloat1622float2(b2[e]);
            acc += (x.x + xr.x) * y.x + (x.y + xr.y) * y.y;
          }
        }
      }
      sdelta[i] = acc;
    }
    __syncthreads();
    const int gr = lane >> 2;
    bf16* dst = grad_qkv + row0 * 3 * d + h * kHead;
    // Pass 1: a warp's 16 query rows against every key.
    for (int m0 = 16 * warp; m0 < lp; m0 += 16 * warps) {
      uint32_t qa[2][4], da[2][4];
      a_rows(qa[0], sq, m0, 0, lane);
      a_rows(qa[1], sq, m0, 16, lane);
      a_rows(da[0], sdo, m0, 0, lane);
      a_rows(da[1], sdo, m0, 16, lane);
      const int ti[2] = {tok[m0 + gr], tok[m0 + gr + 8]};
      const float li[2] = {slse[m0 + gr], slse[m0 + gr + 8]};
      const float di[2] = {sdelta[m0 + gr], sdelta[m0 + gr + 8]};
      float dq[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;
      int kb = 0;
      for (; kb + 32 <= len; kb += 32)
        bwd_keys<4, kShift, false>(dq, qa, da, sk, sv, tok, tabc, gtabc, ti, li, di, kb, len,
                                   lane);
      for (; kb < len; kb += 16)
        bwd_keys<2, kShift, true>(dq, qa, da, sk, sv, tok, tabc, gtabc, ti, li, di, kb, len,
                                  lane);
      store_rows(dst, nullptr, 3 * d, dq, 1.0f, 1.0f, m0, len, lane);
    }
    // Pass 2: a warp's 16 keys against every query (padded ones give P = 0).
    for (int j0 = 16 * warp; j0 < lp; j0 += 16 * warps) {
      uint32_t ka[2][4], va[2][4];
      a_rows(ka[0], sk, j0, 0, lane);
      a_rows(ka[1], sk, j0, 16, lane);
      a_rows(va[0], sv, j0, 0, lane);
      a_rows(va[1], sv, j0, 16, lane);
      const int tj[2] = {tok[j0 + gr], tok[j0 + gr + 8]};
      float dk[4][4], dv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
        dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
      }
      int qb = 0;
      for (; qb + 32 <= lp; qb += 32)
        bwd_queries<4, kShift>(dk, dv, ka, va, sq, sdo, tok, tabc, slse, sdelta, tj, qb, lane);
      for (; qb < lp; qb += 16)
        bwd_queries<2, kShift>(dk, dv, ka, va, sq, sdo, tok, tabc, slse, sdelta, tj, qb, lane);
      store_rows(dst + d, nullptr, 3 * d, dk, 1.0f, 1.0f, j0, len, lane);
      store_rows(dst + 2 * d, nullptr, 3 * d, dv, 1.0f, 1.0f, j0, len, lane);
    }
    __syncthreads();  // every warp is done with the tiles before the next window's
  }
  for (int r = threadIdx.x; r < g.rows; r += blockDim.x) {
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < kCopies; ++c) v += gtab[c * g.rows + r];
    if (v != 0.0f) atomicAdd(grad_table + static_cast<size_t>(r) * g.heads + h, v);
  }
}

// Warps a block: as many as spread the L / 16 row tiles evenly over the
// fewest rounds of at most kMaxWarps.
int warps_of(int lp) {
  const int tiles = lp / 16;
  const int rounds = (tiles + kMaxWarps - 1) / kMaxWarps;
  return (tiles + rounds - 1) / rounds;
}

size_t fwd_smem(const Geo& g) {
  return 3 * static_cast<size_t>(g.lp) * kRow * sizeof(bf16) + g.lp * sizeof(int) +
         g.rows * sizeof(float);
}

size_t bwd_smem(const Geo& g) {
  return 4 * static_cast<size_t>(g.lp) * kRow * sizeof(bf16) +
         g.lp * (sizeof(int) + 2 * sizeof(float)) + (1 + kCopies) * g.rows * sizeof(float);
}

// The shape of a launch, or false where the kernels do not take it.
bool geometry(int n_seq, int len, int heads, int n_win, int wd, int wh, int ww, int sms,
              int blocks_per_sm, Geo* g) {
  if (n_seq < 1 || heads < 1 || len < 1 || len > kMaxLen || wd < 1 || wh < 1 || ww < 1 ||
      static_cast<long long>(wd) * wh * ww < len || n_win < 0 || (n_win && n_seq % n_win) ||
      heads > 65535)
    return false;
  g->n_seq = n_seq;
  g->len = len;
  g->lp = (len + 15) / 16 * 16;
  g->heads = heads;
  g->n_win = n_win;
  g->wh = wh;
  g->ww = ww;
  g->r1 = 2 * ww - 1;
  g->r0 = (2 * wh - 1) * g->r1;
  g->rows = (2 * wd - 1) * g->r0;
  g->c0 = (wd - 1) * g->r0 + (wh - 1) * g->r1 + (ww - 1);
  if (g->rows > kMaxRows) return false;
  // Enough blocks for several waves; more windows a block where there are
  // many, so the table is staged and its gradient flushed less often.
  const long long pairs = static_cast<long long>(n_seq) * heads;
  const long long wave = static_cast<long long>(sms > 0 ? sms : 132) * blocks_per_sm;
  g->per_block = static_cast<int>(pairs / (8 * wave));
  if (g->per_block < 1) g->per_block = 1;
  if (g->per_block > 8) g->per_block = 8;
  return true;
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (nonzero when the launch was refused or the shape is not
// taken). Pointers: qkv, grad_qkv [n_seq, len, 3 * heads * 32] and out,
// grad_out [n_seq, len, heads * 32] bf16, 16-byte aligned; lse [n_seq, heads,
// len], table and grad_table [rows, heads] fp32 with rows = (2 wd - 1)(2 wh -
// 1)(2 ww - 1); regions [n_win, len] int32 or null (n_win 0); all contiguous;
// 1 <= len <= 448 and len <= wd * wh * ww; grad_table zeroed.
int asl_window_attention_fwd(const void* qkv, const void* table, const void* regions,
                             void* out, void* out_rest, void* lse, int n_seq, int len,
                             int heads, int n_win,
                             int wd, int wh, int ww, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo g;
  if ((regions && n_win < 1) ||
      !geometry(n_seq, len, heads, regions ? n_win : 0, wd, wh, ww, sm_count(device), 2, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(g);
  const dim3 grid((n_seq + g.per_block - 1) / g.per_block, heads);
  const int threads = 32 * warps_of(g.lp);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const bf16*>(qkv);
  const auto* tb = static_cast<const float*>(table);
  const auto* rg = static_cast<const int*>(regions);
  auto* y = static_cast<bf16*>(out);
  auto* yr = static_cast<bf16*>(out_rest);
  auto* l = static_cast<float*>(lse);
  if (regions) {
    err = cudaFuncSetAttribute(window_attention_fwd<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_fwd<true><<<grid, threads, smem, s>>>(x, tb, rg, y, yr, l, g);
  } else {
    err = cudaFuncSetAttribute(window_attention_fwd<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_fwd<false><<<grid, threads, smem, s>>>(x, tb, nullptr, y, yr, l, g);
  }
  return static_cast<int>(cudaGetLastError());
}

int asl_window_attention_bwd(const void* grad_out, const void* qkv, const void* out,
                             const void* out_rest, const void* lse, const void* table,
                             const void* regions,
                             void* grad_qkv, void* grad_table, int n_seq, int len, int heads,
                             int n_win, int wd, int wh, int ww, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geo g;
  if ((regions && n_win < 1) ||
      !geometry(n_seq, len, heads, regions ? n_win : 0, wd, wh, ww, sm_count(device), 1, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(g);
  const dim3 grid((n_seq + g.per_block - 1) / g.per_block, heads);
  const int threads = 32 * warps_of(g.lp);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* go = static_cast<const bf16*>(grad_out);
  const auto* x = static_cast<const bf16*>(qkv);
  const auto* y = static_cast<const bf16*>(out);
  const auto* yr = static_cast<const bf16*>(out_rest);
  const auto* l = static_cast<const float*>(lse);
  const auto* tb = static_cast<const float*>(table);
  const auto* rg = static_cast<const int*>(regions);
  auto* gx = static_cast<bf16*>(grad_qkv);
  auto* gt = static_cast<float*>(grad_table);
  if (regions) {
    err = cudaFuncSetAttribute(window_attention_bwd<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_bwd<true><<<grid, threads, smem, s>>>(go, x, y, yr, l, tb, rg, gx, gt,
                                                          g);
  } else {
    err = cudaFuncSetAttribute(window_attention_bwd<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_bwd<false><<<grid, threads, smem, s>>>(go, x, y, yr, l, tb, nullptr, gx,
                                                           gt, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
