// Softmax attention over short sequences (1 to 32 tokens, heads of 64) for
// Hopper (sm_90a), read from and written to the packed q/k/v projection;
// bound to Python with ctypes (asltpu_torch/ops/_build.py builds this file,
// asltpu_torch/ops/short_attention_kernels.py holds the wrappers, the custom
// ops, the launch counters and the plain PyTorch version they are tested
// against).
//
// Replaces no TPU kernel: the JAX package has no TimeSformer. It was added
// for TimeSformer's temporal attention, 6,272 sequences of 16 tokens x 12
// heads a layer at batch 8, where PyTorch's fused attention backends (cuDNN's
// first) took ~14% of this function's memory bound, and splitting the packed
// projection into q, k and v views made the backward build, fill and sum three
// full-size gradients.
//
// short_attention_fwd: qkv [N, L, 3 * H * 64] bf16, columns q; k; v, each
//   H heads of 64 -> out [N, L, H * 64] bf16, out = softmax(q k^T / 8) v by
//   head, the layout the output projection reads.
// short_attention_bwd: grad_out [N, L, H * 64] and qkv -> grad_qkv [N, L,
//   3 * H * 64], the gradients of q; k; v in qkv's own layout, every value
//   written once. Nothing saved by the forward is read: a row has at most 32
//   keys, so the backward recomputes P and delta = rowsum(P * dP) (no output,
//   no log-sum-exp). No atomics: each (sequence, head) owns its rows of
//   grad_qkv, so the result is deterministic.
//
// Rounding, FlashAttention-2's: products and softmax in fp32; the forward
// rounds the unnormalised weights exp(s - max) to bf16 for p.v and divides
// by their fp32 sum, rounding the output once; the backward rounds P to bf16
// for dv = P^T dO and dS = P * (dP - delta) / 8 to bf16 for dq = dS k and
// dk = dS^T q.
//
// Bound: memory. A (sequence, head) of 16 tokens reads 6 KB and does ~0.4
// MFLOP forward (66 FLOP a byte, under a quarter of the ~295 where the H100's
// tensor cores would bound it). The least time is the bytes moved once:
// forward qkv + out, backward qkv + grad_out + grad_qkv, 11 bf16 values a
// token and model width for both directions.
//
// Design for that bound:
// - One warp a (sequence, head); a block's warps take consecutive heads, so
//   a block reads whole 128-byte lines of neighbouring columns. Each tile (q,
//   k, v, dO: L rows of 128 bytes) is copied into shared memory with 16-byte
//   cp.async, all issued before the first is waited for; rows past L are
//   zero-filled, which keeps padded products finite.
// - Tensor cores by mma.sync m16n8k16 (bf16 in, fp32 sums) on ldmatrix
//   fragments; rows padded with 16 bytes so ldmatrix hits 8 distinct bank
//   groups. L is padded to LP = 16 or 32; keys past L are masked to -inf;
//   padded query rows are computed and not stored (their dO rows are zero,
//   so they add nothing to dk and dv).
// - A row's softmax lives in the 4 lanes that hold it in the mma's
//   accumulator layout (two shuffles), and P's accumulators are p.v's A
//   operand as they are. Transposed operands (P^T, dS^T, v, k and q as B) are
//   read from shared memory with ldmatrix.trans.
// - Results go through shared memory (the dead input tiles) so every global
//   store is a 16-byte store of a whole line.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHead = 64;                                 // head size
constexpr int kRow = kHead + 8;                           // a tile's row in shared memory, bf16
constexpr float kScale = 0.125f;                          // 1 / sqrt(64)
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;  // the same for exp2

// Warps a block: 4 at LP 16, 2 at LP 32, so the backward's shared memory
// stays under the 48 KB a launch may take without an opt-in.
template <int LP> struct Plan {
  static constexpr int kWarps = LP == 16 ? 4 : 2;
  static constexpr int kTile = LP * kRow;      // bf16 of a q, k, v or dO tile
  static constexpr int kPRow = LP + 8;         // a P or dS row, bf16
  static constexpr int kPTile = LP * kPRow;
  static constexpr int kFwd = 3 * kTile;       // bf16 a warp, forward
  static constexpr int kBwd = 4 * kTile + 2 * kPTile;
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
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* tile, int stride, int m0,
                                       int k0, int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4(a, tile + (m0 + r + 8 * (m & 1)) * stride + k0 + 8 * (m >> 1));
}

// A = tile^T (16x16 at A's rows m0, columns k0): A[i][j] = tile[j][i].
__device__ __forceinline__ void a_cols(uint32_t (&a)[4], const bf16* tile, int stride, int m0,
                                       int k0, int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4_trans(a, tile + (k0 + r + 8 * (m >> 1)) * stride + m0 + 8 * (m & 1));
}

// B[k][n] = tile[n][k] for the 8-column tiles n0 and n0 + 8 and the k-step k0:
// b[0], b[1] for n0; b[2], b[3] for n0 + 8.
__device__ __forceinline__ void b_rows(uint32_t (&b)[4], const bf16* tile, int stride, int n0,
                                       int k0, int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4(b, tile + (n0 + r + 8 * (m >> 1)) * stride + k0 + 8 * (m & 1));
}

// B[k][n] = tile[k][n], likewise.
__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* tile, int stride, int k0,
                                       int n0, int lane) {
  const int r = lane & 7, m = lane >> 3;
  ldsm_x4_trans(b, tile + (k0 + r + 8 * (m & 1)) * stride + n0 + 8 * (m >> 1));
}

// Rows [0, len) of a 64-wide head at `src` (row stride `ld` values) into a
// tile; rows [len, LP) zero.
template <int LP>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t ld, int len,
                                          int lane) {
  const int c = (lane & 7) * 8;
#pragma unroll
  for (int i = lane >> 3; i < LP; i += 4) {
    const bool valid = i < len;
    cp_async16(tile + i * kRow + c, valid ? src + i * ld + c : src, valid);
  }
}

// Rows [0, len) of a tile to a 64-wide head at `dst`.
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* tile, size_t ld, int len,
                                           int lane) {
  const int c = (lane & 7) * 8;
  for (int i = lane >> 3; i < len; i += 4) {
    *reinterpret_cast<uint4*>(dst + i * ld + c) =
        *reinterpret_cast<const uint4*>(tile + i * kRow + c);
  }
}

// An accumulator tile (16 x 8 * NT, fp32) times `scale`, rounded to bf16, into
// rows m0.. of a shared tile.
template <int NT>
__device__ __forceinline__ void stage(bf16* tile, int stride, int m0, const float (&acc)[NT][4],
                                      float scale_lo, float scale_hi, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    bf16* p = tile + (m0 + g) * stride + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack(acc[j][0] * scale_lo, acc[j][1] * scale_lo);
    *reinterpret_cast<uint32_t*>(p + 8 * stride) =
        pack(acc[j][2] * scale_hi, acc[j][3] * scale_hi);
  }
}

// s = q k^T for query rows m0..m0 + 15 against all LP keys, in fp32.
template <int LP>
__device__ __forceinline__ void scores(float (&s)[LP / 8][4], const bf16* sq, const bf16* sk,
                                       int m0, int lane) {
#pragma unroll
  for (int j = 0; j < LP / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kHead; k0 += 16) {
    uint32_t a[4];
    a_rows(a, sq, kRow, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < LP / 8; j += 2) {
      uint32_t b[4];
      b_rows(b, sk, kRow, 8 * j, k0, lane);
      mma(s[j], a, b[0], b[1]);
      mma(s[j + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// s = exp(s / 8 - the row's max) over the keys [0, len), 0 past them; the
// rows' (g, g + 8) sums in sum.
template <int LP>
__device__ __forceinline__ void softmax_numerators(float (&s)[LP / 8][4], float (&sum)[2],
                                                   int len, int lane) {
  const int t = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < LP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = 8 * j + 2 * t + (e & 1) < len ? s[j][e] * kScaleLog2 : -INFINITY;
      s[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  mx[0] = row_max(mx[0]);
  mx[1] = row_max(mx[1]);
  sum[0] = sum[1] = 0.0f;
#pragma unroll
  for (int j = 0; j < LP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - mx[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
  }
  sum[0] = row_sum(sum[0]);
  sum[1] = row_sum(sum[1]);
}

// The A operand of k-step kk (keys 16 kk.. 16 kk + 15) from accumulators.
template <int LP>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&s)[LP / 8][4],
                                           int kk) {
  a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// acc (16 x 64) = A (16 x 16 KSteps) times B[k][n] = tile[k][n] read by
// b_cols; A's fragments given by `a_of(kk, a)`.
template <int KSteps, typename AOf>
__device__ __forceinline__ void times_cols(float (&acc)[8][4], AOf a_of, const bf16* tile,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KSteps; ++kk) {
    uint32_t a[4];
    a_of(kk, a);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      b_cols(b, tile, kRow, 16 * kk, 8 * j, lane);
      mma(acc[j], a, b[0], b[1]);
      mma(acc[j + 1], a, b[2], b[3]);
    }
  }
}

template <int LP>
__global__ void __launch_bounds__(Plan<LP>::kWarps * 32)
    short_attention_fwd(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n_seq,
                        int len, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * Plan<LP>::kWarps + warp;
  if (unit >= static_cast<long long>(n_seq) * heads) return;
  const int seq = static_cast<int>(unit / heads), h = static_cast<int>(unit % heads);
  const size_t d = static_cast<size_t>(heads) * kHead;
  bf16* sq = reinterpret_cast<bf16*>(smem) + warp * Plan<LP>::kFwd;
  bf16* sk = sq + Plan<LP>::kTile;
  bf16* sv = sk + Plan<LP>::kTile;
  const bf16* src = qkv + static_cast<size_t>(seq) * len * 3 * d + h * kHead;
  load_tile<LP>(sq, src, 3 * d, len, lane);
  load_tile<LP>(sk, src + d, 3 * d, len, lane);
  load_tile<LP>(sv, src + 2 * d, 3 * d, len, lane);
  cp_async_wait_all();
  __syncwarp();

#pragma unroll
  for (int m0 = 0; m0 < LP; m0 += 16) {
    float s[LP / 8][4], sum[2];
    scores<LP>(s, sq, sk, m0, lane);
    softmax_numerators<LP>(s, sum, len, lane);
    float o[8][4];
    times_cols<LP / 16>(o, [&](int kk, uint32_t(&a)[4]) { a_from_acc<LP>(a, s, kk); }, sv,
               lane);
    __syncwarp();  // every lane has read q's rows m0.. before they are overwritten
    stage<8>(sq, kRow, m0, o, 1.0f / sum[0], 1.0f / sum[1], lane);
  }
  __syncwarp();
  store_tile(out + static_cast<size_t>(seq) * len * d + h * kHead, sq, d, len, lane);
}

template <int LP>
__global__ void __launch_bounds__(Plan<LP>::kWarps * 32)
    short_attention_bwd(const bf16* __restrict__ grad_out, const bf16* __restrict__ qkv,
                        bf16* __restrict__ grad_qkv, int n_seq, int len, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * Plan<LP>::kWarps + warp;
  if (unit >= static_cast<long long>(n_seq) * heads) return;
  const int seq = static_cast<int>(unit / heads), h = static_cast<int>(unit % heads);
  const size_t d = static_cast<size_t>(heads) * kHead;
  constexpr int kP = Plan<LP>::kPRow;
  bf16* sq = reinterpret_cast<bf16*>(smem) + warp * Plan<LP>::kBwd;
  bf16* sk = sq + Plan<LP>::kTile;
  bf16* sv = sk + Plan<LP>::kTile;
  bf16* sdo = sv + Plan<LP>::kTile;
  bf16* sp = sdo + Plan<LP>::kTile;  // P, bf16
  bf16* sds = sp + Plan<LP>::kPTile;  // dS = P * (dP - delta) / 8, bf16
  const size_t row0 = static_cast<size_t>(seq) * len;
  const bf16* src = qkv + row0 * 3 * d + h * kHead;
  load_tile<LP>(sq, src, 3 * d, len, lane);
  load_tile<LP>(sk, src + d, 3 * d, len, lane);
  load_tile<LP>(sv, src + 2 * d, 3 * d, len, lane);
  load_tile<LP>(sdo, grad_out + row0 * d + h * kHead, d, len, lane);
  cp_async_wait_all();
  __syncwarp();

  // P and dS by 16 query rows.
#pragma unroll
  for (int m0 = 0; m0 < LP; m0 += 16) {
    float p[LP / 8][4], sum[2], dp[LP / 8][4];
    scores<LP>(p, sq, sk, m0, lane);
    softmax_numerators<LP>(p, sum, len, lane);
    scores<LP>(dp, sdo, sv, m0, lane);  // dP = dO v^T
    const float inv[2] = {1.0f / sum[0], 1.0f / sum[1]};
    float delta[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < LP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] *= inv[e >> 1];
        delta[e >> 1] += p[j][e] * dp[j][e];
      }
    }
    delta[0] = row_sum(delta[0]);
    delta[1] = row_sum(delta[1]);
#pragma unroll
    for (int j = 0; j < LP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - delta[e >> 1]) * kScale;
    }
    stage<LP / 8>(sp, kP, m0, p, 1.0f, 1.0f, lane);
    stage<LP / 8>(sds, kP, m0, dp, 1.0f, 1.0f, lane);
  }
  __syncwarp();

  bf16* dst = grad_qkv + row0 * 3 * d + h * kHead;
  float acc[8][4];
  // dv = P^T dO, staged in v's tile (v is no longer read).
#pragma unroll
  for (int m0 = 0; m0 < LP; m0 += 16) {
    times_cols<LP / 16>(acc,
               [&](int kk, uint32_t(&a)[4]) { a_cols(a, sp, kP, m0, 16 * kk, lane); }, sdo,
               lane);
    stage<8>(sv, kRow, m0, acc, 1.0f, 1.0f, lane);
  }
  __syncwarp();
  store_tile(dst + 2 * d, sv, 3 * d, len, lane);
  // dq = dS k, staged in dO's tile (read for the last time above).
#pragma unroll
  for (int m0 = 0; m0 < LP; m0 += 16) {
    times_cols<LP / 16>(acc,
               [&](int kk, uint32_t(&a)[4]) { a_rows(a, sds, kP, m0, 16 * kk, lane); }, sk,
               lane);
    stage<8>(sdo, kRow, m0, acc, 1.0f, 1.0f, lane);
  }
  __syncwarp();
  store_tile(dst, sdo, 3 * d, len, lane);
  // dk = dS^T q, staged in k's tile (read for the last time above).
#pragma unroll
  for (int m0 = 0; m0 < LP; m0 += 16) {
    times_cols<LP / 16>(acc,
               [&](int kk, uint32_t(&a)[4]) { a_cols(a, sds, kP, m0, 16 * kk, lane); }, sq,
               lane);
    stage<8>(sk, kRow, m0, acc, 1.0f, 1.0f, lane);
  }
  __syncwarp();
  store_tile(dst + d, sk, 3 * d, len, lane);
}

template <int LP>
int grid_of(int n_seq, int heads) {
  const long long units = static_cast<long long>(n_seq) * heads;
  return static_cast<int>((units + Plan<LP>::kWarps - 1) / Plan<LP>::kWarps);
}

bool valid(int n_seq, int len, int heads) {
  return n_seq > 0 && heads > 0 && len >= 1 && len <= 32 &&
         static_cast<long long>(n_seq) * heads < (1LL << 31);
}

template <int LP>
cudaError_t launch_fwd(const bf16* qkv, bf16* out, int n_seq, int len, int heads,
                       cudaStream_t stream) {
  constexpr int kWarps = Plan<LP>::kWarps;
  short_attention_fwd<LP><<<grid_of<LP>(n_seq, heads), kWarps * 32,
                            kWarps * Plan<LP>::kFwd * sizeof(bf16), stream>>>(qkv, out, n_seq,
                                                                              len, heads);
  return cudaGetLastError();
}

template <int LP>
cudaError_t launch_bwd(const bf16* grad_out, const bf16* qkv, bf16* grad_qkv, int n_seq,
                       int len, int heads, cudaStream_t stream) {
  constexpr int kWarps = Plan<LP>::kWarps;
  short_attention_bwd<LP><<<grid_of<LP>(n_seq, heads), kWarps * 32,
                            kWarps * Plan<LP>::kBwd * sizeof(bf16), stream>>>(
      grad_out, qkv, grad_qkv, n_seq, len, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (nonzero when the launch was refused). Pointers are
// bf16, 16-byte aligned; qkv and grad_qkv [n_seq, len, 3 * heads * 64],
// out and grad_out [n_seq, len, heads * 64], all contiguous; 1 <= len <= 32.
int asl_short_attention_fwd(const void* qkv, void* out, int n_seq, int len, int heads,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(n_seq, len, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const bf16*>(qkv);
  auto* y = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(len <= 16 ? launch_fwd<16>(x, y, n_seq, len, heads, s)
                                    : launch_fwd<32>(x, y, n_seq, len, heads, s));
}

int asl_short_attention_bwd(const void* grad_out, const void* qkv, void* grad_qkv, int n_seq,
                            int len, int heads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(n_seq, len, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* go = static_cast<const bf16*>(grad_out);
  const auto* x = static_cast<const bf16*>(qkv);
  auto* gx = static_cast<bf16*>(grad_qkv);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(len <= 16 ? launch_bwd<16>(go, x, gx, n_seq, len, heads, s)
                                    : launch_bwd<32>(go, x, gx, n_seq, len, heads, s));
}

}  // extern "C"
