// Fused stride-1 MBConv (inverted-residual) kernels for Hopper (sm_90a),
// bound to Python with ctypes (asltpu_torch/ops/_build.py builds this file,
// asltpu_torch/ops/mbconv_kernels.py holds the wrapper, its launch counter,
// its tile plans and the plain PyTorch version they are tested against).
//
// Replaces asltpu/ops/mbconv_pallas.py::fused_mbconv_s1 (body _make_kernel).
// With BN folded into the weights (fold_bn), one block of MobileNetV2 is
//
//   out = relu6(dw3x3(mask(relu6(x . w1 + b1))) + b2) . w2 + b3  (+ x)
//
// x is NHWC [N, H, W, Cin], w1 [Cin, Ce], dw [9, Ce] (row-major taps,
// dr*3+dc), w2 [Ce, Cout], all weights fp32, sums fp32, one rounding to x's
// type at the end. The residual is added when the wrapper asks for it
// (Cin == Cout). "mask" zeroes the expanded activation at the zero padding
// around the image: the expand of a zero pixel is relu6(b1), not 0, and the
// depthwise must see zeros there.
//
// What bounds it: the block's inputs and outputs are a few bytes per pixel
// (Cin + Cout values) while the work is 2*Cin*Ce + 18*Ce + 2*Ce*Cout
// operations per pixel, with Ce = 6*Cin. At the main path's shapes that is
// about 170-900 operations per byte: above the H100's ~295 for bf16 tensor
// cores only at H <= 14, so the 56^2 and 28^2 blocks are bound by bytes and
// the rest by operations (counted at the bf16 tensor-core peak, so that no
// later redesign with bf16 operands reads over 100%). Unfused, the 6x
// expanded activation would go to device memory and back twice per block.
// Both kernels keep it on the SM.
//
// Two kernels, chosen by x's type:
//
// bf16 x (the main path's type): fused_mbconv_s1_tf32_kernel, the two 1x1
// products on TF32 tensor cores through nvcuda::wmma (m16n16k8, fp32
// accumulators), the depthwise on CUDA cores. Why TF32 and not bf16
// operands: a bf16 x is exact in TF32, so only the folded weights w1, w2
// and the depthwise output (the project's A operand) are rounded, to 10
// mantissa bits. Emulated on the plain version at the 7 main-path shapes
// that moves the fp32 result by 0.046-0.059 of one bf16 ulp of the largest
// output, so the bf16 result stays within one ulp of the fp32 plain version;
// bf16 operands move it by 0.36-0.62 ulp before the final rounding
// (tests/test_torch_mbconv.py).
// One block = one image x `tr` output rows x ALL of Cout, 256 threads
// (8 warps). The block reads the input rows r0-1 .. r0+tr straight from the
// unpadded x into shared memory (fp32, zero outside the image, positions
// padded to a multiple of 16, channels to a multiple of 8; 16-byte loads
// where Cin allows). The halo columns are left out: their expand is always
// masked to zero, so the depthwise reads zero there instead. Then the block
// walks the expanded channels in chunks of kChunk = 16:
//   stage      the chunk's w1 and w2 slices (16-byte loads, rounded to TF32
//              once), taps and biases into shared memory;
//   expand     tensor cores: A = x tile (m-tiles of 16 positions, taken by
//              the warps in turn), B = the w1 chunk, stored to shared
//              memory; the same warp then adds b1, applies relu6 and zeroes
//              the rows outside the image (the position of an element in an
//              accumulator fragment is unspecified, so this is a pass over
//              shared memory, never over the x tile);
//   depthwise  CUDA cores, fp32, each thread's 9 taps and b2 in registers,
//              into the project's A tile (rounded to TF32, padded rows 0);
//   project    tensor cores: every warp owns a fixed set of (m-tile,
//              n-tile) accumulator fragments of the (tr*W) x Cout output
//              tile for the whole Ce loop (at most kMaxFrag = 10 a warp, 80
//              registers) and adds the chunk's two k-steps of 8.
// The epilogue stores each fragment to the warp's own 16x16 staging tile in
// shared memory (over the then idle expanded/depthwise tiles), adds b3 and
// the residual (from the x tile), rounds once to bf16 and writes the valid
// rows and channels. Every shared sub-buffer starts on a multiple of 8
// floats and every leading dimension is a multiple of 4 floats, as wmma's
// loads and stores require; the paddings also keep fragment loads free of
// bank conflicts. The wrapper's plan (mbconv_kernels.tf32_tile_plan) takes
// the most rows whose fragments fit 8 * kMaxFrag and whose shared memory
// lets two blocks share an SM (else one), spread evenly; Cout is never
// split. __launch_bounds__(256, 2) caps it at 128 registers, without
// spills. What holds it back (PERF.md): four barriers a chunk with short,
// latency-bound phases between them; the weight slices re-read from L2 by
// every block (most at 7^2, where they outweigh the image); both products
// fed from shared memory. No wgmma, TMA, cp.async or persistent grid yet.
//
// fp32 x: fused_mbconv_s1_fp32_kernel, the first (CUDA-core) kernel,
// unchanged: TF32 cannot meet the fp32 check (1e-4 relative). One block
// takes one image, `tr` rows and `cot` output channels (every output of the
// tile has a register accumulator, at most kMaxAcc a thread); expand, mask,
// depthwise and project in fp32 FMAs, two shared-memory loads per FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#ifdef ASL_PHASE_CLOCKS
// Built only by tools/mbconv_phases.py: thread 0 of every block of the tf32
// kernel adds the clock cycles of each phase (each ends at a barrier) to
// asl_phase_cycles[phase] and counts its block in asl_phase_cycles[6].
__device__ unsigned long long asl_phase_cycles[8];
#define PHASE_START long long phase_t0 = clock64();
#define PHASE_END(k)                                                  \
  if (threadIdx.x == 0) {                                             \
    const long long phase_t1 = clock64();                             \
    atomicAdd(&asl_phase_cycles[k], (unsigned long long)(phase_t1 - phase_t0)); \
    phase_t0 = phase_t1;                                              \
  }
#else
#define PHASE_START
#define PHASE_END(k)
#endif

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;        // expanded channels per pass
constexpr int kMaxAcc = 32;       // fp32 kernel: output accumulators per thread
constexpr int kMaxFrag = 10;      // tf32 kernel: accumulator fragments per warp
constexpr int kBatch = 2;         // tf32 kernel: vector loads in flight per thread
// Row strides (floats) of the tf32 kernel's tiles: A operands (x, expanded,
// depthwise) want a stride of 4 mod 8 and row-major B operands (w1, w2) one
// of 8 mod 16, so that no two lanes of a fragment load share a bank.
constexpr int kLe = kChunk + 4;
constexpr int kLw1 = kChunk + 8;
constexpr int kStage = 16 * 16;   // one warp's epilogue staging tile

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

template <typename I>
__host__ __device__ inline I round_up(I v, int m) {
  return (v + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// bf16 x: TF32 tensor cores.

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

struct TcShape {
  int h, w, cin, ce, cout;
  int tr;  // output rows per block
  int use_res;
  int vec_x;  // x is read 8 channels (16 bytes) at a time: Cin % 8 == 0, aligned
  int vec_w;  // w1 and w2 are read 4 floats at a time: Ce, Cout % 4 == 0, aligned
};

// bf16 pair (as the 32 bits of a uint) -> two floats, exactly.
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ float4 tf32x4(float4 v) {
  return make_float4(wmma::__float_to_tf32(v.x), wmma::__float_to_tf32(v.y),
                     wmma::__float_to_tf32(v.z), wmma::__float_to_tf32(v.w));
}

// One block's geometry; offsets and sizes in floats. Mirrored by
// mbconv_kernels.tf32_layout. The launch checks compute it in 64 bits; the
// kernel takes it in 32 (it fits once the shared memory does), so that its
// fields are read from the parameter bank and hold no registers.
template <typename I>
struct TcTile {
  I m1, m1p;      // positions of the haloed rows (tr+2)*W, padded to 16
  I m2, m2p;      // output positions tr*W, padded to 16
  I kp, lx;       // Cin padded to 8; the x tile's row stride
  I np, lw2;      // Cout padded to 16; the w2 tile's row stride
  I nt2, frags;   // output n-tiles; output fragments of the tile
  I off_es, off_ds, off_w1, off_w2, off_dw, off_b1, off_b2, off_mask, off_col;
  I total;
};

template <typename I>
__host__ __device__ inline TcTile<I> tc_tile(const TcShape& s) {
  TcTile<I> g;
  g.m1 = ((I)s.tr + 2) * s.w;
  g.m1p = round_up(g.m1, 16);
  g.m2 = (I)s.tr * s.w;
  g.m2p = round_up(g.m2, 16);
  g.kp = round_up((I)s.cin, 8);
  g.lx = g.kp + 4;
  g.np = round_up((I)s.cout, 16);
  g.lw2 = g.np + 8;
  g.nt2 = g.np / 16;
  g.frags = g.m2p / 16 * g.nt2;
  // [xs: m1p x lx][es: m1p x kLe][ds: m2p x kLe] -- es and ds hold the
  // warps' staging tiles in the epilogue -- [w1s: kp x kLw1][w2s: kChunk
  // x lw2][dws: 9 x kChunk][b1s][b2s][mask: m1p][col: m2p ints]
  const I work = (g.m1p + g.m2p) * kLe;
  const I stage = (I)kWarps * kStage;
  g.off_es = g.m1p * g.lx;
  g.off_ds = g.off_es + g.m1p * kLe;
  g.off_w1 = g.off_es + (work > stage ? work : stage);
  g.off_w2 = g.off_w1 + g.kp * kLw1;
  g.off_dw = g.off_w2 + (I)kChunk * g.lw2;
  g.off_b1 = g.off_dw + 9 * kChunk;
  g.off_b2 = g.off_b1 + kChunk;
  g.off_mask = g.off_b2 + kChunk;
  g.off_col = g.off_mask + g.m1p;
  g.total = g.off_col + g.m2p;
  return g;
}

__global__ void __launch_bounds__(kThreads, 2) fused_mbconv_s1_tf32_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ dw,
    const float* __restrict__ b2, const float* __restrict__ w2,
    const float* __restrict__ b3, __nv_bfloat16* __restrict__ out,
    const TcShape s, const TcTile<int> g) {
  extern __shared__ __align__(128) float smem[];
  const int h = s.h, w = s.w, cin = s.cin, ce = s.ce, cout = s.cout;
  const int tr = s.tr;
  const int m1 = g.m1, m1p = g.m1p, m2 = g.m2, m2p = g.m2p;
  const int kp = g.kp, lx = g.lx, np = g.np, lw2 = g.lw2, nt2 = g.nt2;
  const int frags = g.frags;
  const int row_tiles = (h + tr - 1) / tr;
  const int r0 = (int)(blockIdx.x % row_tiles) * tr;  // first output row
  const int64_t img = blockIdx.x / row_tiles;

  float* xs = smem;                 // [m1p, lx]
  float* es = smem + g.off_es;      // [m1p, kLe]
  float* ds = smem + g.off_ds;      // [m2p, kLe]
  float* w1s = smem + g.off_w1;     // [kp, kLw1]
  float* w2s = smem + g.off_w2;     // [kChunk, lw2]
  float* dws = smem + g.off_dw;     // [9, kChunk]
  float* b1s = smem + g.off_b1;     // [kChunk]
  float* b2s = smem + g.off_b2;     // [kChunk]
  float* mask = smem + g.off_mask;  // [m1p]: 1 inside the image, else 0
  int* col = reinterpret_cast<int*>(smem + g.off_col);  // [m2p]: p % W

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const __nv_bfloat16* ximg = x + img * h * w * cin;
  PHASE_START

  // The input rows r0-1 .. r0+tr (the output rows and a halo row on each
  // side); 0 outside the image, in the padded channels and in the padded
  // rows. A bf16 value is exact in TF32, so the tile is a valid A operand
  // as it stands. With vec_x, 8 channels a load and kBatch loads in flight
  // per thread; else a warp per position, a channel per lane. Then, per
  // position, whether its row lies in the image and, per output position,
  // its column (so that no loop below divides by W).
  if (s.vec_x) {
    const int g8 = kp / 8, n8 = m1p * g8;
    for (int base = t; base < n8; base += kThreads * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads, q = i / g8, g = i % g8;
        const int gr = r0 - 1 + q / w;
        v[u] = make_uint4(0, 0, 0, 0);
        if (i < n8 && q < m1 && gr >= 0 && gr < h) {
          v[u] = *reinterpret_cast<const uint4*>(
              ximg + ((int64_t)(r0 - 1) * w + q) * cin + g * 8);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < n8) {
          float4* d = reinterpret_cast<float4*>(xs + (i / g8) * lx + (i % g8) * 8);
          const float2 a = bf16x2_to_float2(v[u].x), b = bf16x2_to_float2(v[u].y);
          const float2 c = bf16x2_to_float2(v[u].z), e = bf16x2_to_float2(v[u].w);
          d[0] = make_float4(a.x, a.y, b.x, b.y);
          d[1] = make_float4(c.x, c.y, e.x, e.y);
        }
      }
    }
  } else {
    for (int q = warp; q < m1p; q += kWarps) {
      const int gr = r0 - 1 + q / w;
      const bool in = q < m1 && gr >= 0 && gr < h;
      for (int ci = lane; ci < kp; ci += 32) {
        xs[q * lx + ci] = (in && ci < cin)
            ? __bfloat162float(ximg[((int64_t)(r0 - 1) * w + q) * cin + ci]) : 0.0f;
      }
    }
  }
  for (int q = t; q < m1p; q += kThreads) {
    const int gr = r0 - 1 + q / w;
    mask[q] = (q < m1 && gr >= 0 && gr < h) ? 1.0f : 0.0f;
  }
  for (int p = t; p < m2p; p += kThreads) col[p] = p % w;

  // Output fragment f = warp + j * kWarps (m-tile f / nt2, n-tile f % nt2)
  // lives in acc[j] of warp `warp`.
  FragC acc[kMaxFrag];
#pragma unroll
  for (int j = 0; j < kMaxFrag; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int c0 = 0; c0 < ce; c0 += kChunk) {
    __syncthreads();  // the x tile is in; the last chunk's readers are done
    PHASE_END(c0 == 0 ? 0 : 4)  // prologue; project
    // This chunk's weights, rounded to TF32 once here; channels past ce,
    // rows past cin and columns past cout get zeros, so padding adds 0.
    // With vec_w, 4 floats a load and kBatch loads in flight per thread.
    if (s.vec_w) {
      constexpr int q1 = kChunk / 4;  // float4s in a row of the w1 chunk
      const int q2 = np / 4, n1 = kp * q1, n = n1 + kChunk * q2;
      for (int base = t; base < n; base += kThreads * kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = base + u * kThreads;
          v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (i < n1) {  // w1[ci, c .. c+3]
            const int ci = i / q1, c = c0 + (i % q1) * 4;
            if (ci < cin && c < ce) {
              v[u] = *reinterpret_cast<const float4*>(w1 + (int64_t)ci * ce + c);
            }
          } else if (i < n) {  // w2[c, co .. co+3]
            const int c = c0 + (i - n1) / q2, co = ((i - n1) % q2) * 4;
            if (c < ce && co < cout) {
              v[u] = *reinterpret_cast<const float4*>(w2 + (int64_t)c * cout + co);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = base + u * kThreads;
          if (i < n1) {
            *reinterpret_cast<float4*>(w1s + (i / q1) * kLw1 + (i % q1) * 4) = tf32x4(v[u]);
          } else if (i < n) {
            *reinterpret_cast<float4*>(w2s + ((i - n1) / q2) * lw2 + ((i - n1) % q2) * 4) =
                tf32x4(v[u]);
          }
        }
      }
    } else {
      const int j = t % kChunk, c = c0 + j;
      for (int ci = t / kChunk; ci < kp; ci += kThreads / kChunk) {
        w1s[ci * kLw1 + j] = (ci < cin && c < ce)
                                 ? wmma::__float_to_tf32(w1[(int64_t)ci * ce + c])
                                 : 0.0f;
      }
      for (int k = warp; k < kChunk; k += kWarps) {
        const int ck = c0 + k;
        const float* src = w2 + (int64_t)ck * cout;
        for (int co = lane; co < np; co += 32) {
          w2s[k * lw2 + co] =
              (ck < ce && co < cout) ? wmma::__float_to_tf32(src[co]) : 0.0f;
        }
      }
    }
    for (int i = t; i < 9 * kChunk; i += kThreads) {
      const int c = c0 + i % kChunk;
      dws[i] = c < ce ? dw[(i / kChunk) * ce + c] : 0.0f;
    }
    if (t < kChunk) {
      const int c = c0 + t;
      b1s[t] = c < ce ? b1[c] : 0.0f;
      b2s[t] = c < ce ? b2[c] : 0.0f;
    }
    __syncthreads();
    PHASE_END(1)  // stage

    // Expand: each warp takes m-tiles of 16 positions in turn (the chunk is
    // one n-tile), then adds b1, applies relu6 and zeroes the rows outside
    // the image (and the padded rows) in its own tile of the stored result.
    static_assert(kChunk == 16, "one n-tile a chunk");
    for (int mt = warp; mt < m1p / 16; mt += kWarps) {
      FragC e;
      wmma::fill_fragment(e, 0.0f);
      const float* a0 = xs + mt * 16 * lx;
      for (int k = 0; k < kp; k += 8) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, a0 + k, lx);
        wmma::load_matrix_sync(b, w1s + k * kLw1, kLw1);
        wmma::mma_sync(e, a, b, e);
      }
      float* eo = es + mt * 16 * kLe;
      wmma::store_matrix_sync(eo, e, kLe, wmma::mem_row_major);
      __syncwarp();
      const float bias = b1s[lane % 16];
      // Not unrolled: with the live accumulators, unrolling spills.
#pragma unroll 1
      for (int r = lane / 16; r < 16; r += 2) {
        float* v = eo + r * kLe + lane % 16;
        *v = relu6(*v + bias) * mask[mt * 16 + r];
      }
    }
    __syncthreads();
    PHASE_END(2)  // expand

    // Depthwise 3x3 in the plain version's tap order, + b2, relu6, rounded
    // to TF32 as the project's A operand. kThreads is a multiple of
    // kChunk, so each thread keeps one channel and its taps in registers.
    // The two halves of a warp take positions 4 apart (slot 8G + 2j + half
    // -> position 8G + 4*half + j): 4*kLe is 16 mod 32, so their reads and
    // writes fall in different banks.
    {
      static_assert(kLe % 8 == 4, "positions 4 apart are 16 banks apart");
      const int c = t % kChunk;
      float tap[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) tap[k] = dws[k * kChunk + c];
      const float bias = b2s[c];
      for (int slot = t / kChunk; slot < m2p; slot += kThreads / kChunk) {
        const int p = (slot & ~7) | ((slot & 1) << 2) | ((slot & 7) >> 1);
        float v = 0.0f;
        if (p < m2) {
          // Haloed row r + dr, column col + dc - 1: position p + dr*W + dc - 1;
          // the columns left and right of the image are zero.
          const float* e0 = es + (p - 1) * kLe + c;
          const bool left = col[p] > 0, right = col[p] < w - 1;
          float sum = 0.0f;
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
            for (int dc = 0; dc < 3; ++dc) {
              const float e = e0[(dr * w + dc) * kLe];
              sum = fmaf((dc == 0 && !left) || (dc == 2 && !right) ? 0.0f : e,
                         tap[dr * 3 + dc], sum);
            }
          }
          v = wmma::__float_to_tf32(relu6(sum + bias));
        }
        ds[p * kLe + c] = v;
      }
    }
    __syncthreads();
    PHASE_END(3)  // depthwise

    // Project: the chunk's k-steps into every fragment the warp owns.
#pragma unroll
    for (int j = 0; j < kMaxFrag; ++j) {
      const int f = warp + j * kWarps;
      if (f < frags) {
        const float* a0 = ds + (f / nt2) * 16 * kLe;
        const float* b0 = w2s + (f % nt2) * 16;
#pragma unroll
        for (int k = 0; k < kChunk; k += 8) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, a0 + k, kLe);
          wmma::load_matrix_sync(b, b0 + k * lw2, lw2);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
  }

  // + b3 (+ x), one rounding, one write, a fragment at a time through the
  // warp's staging tile. Output position p of the tile is pixel r0*W + p of
  // the image; rows past the image and channels past cout are dropped.
  __syncthreads();  // es and ds are idle: they hold the staging tiles now
  PHASE_END(4)  // the last chunk's project
  float* st = es + warp * kStage;
  __nv_bfloat16* oimg = out + (img * h + r0) * w * cout;
  const int valid = min(m2, (h - r0) * w);
#pragma unroll
  for (int j = 0; j < kMaxFrag; ++j) {
    const int f = warp + j * kWarps;
    if (f < frags) {
      wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int p0 = (f / nt2) * 16, co = (f % nt2) * 16 + lane % 16;
      const float bias = co < cout ? b3[co] : 0.0f;
#pragma unroll 1
      for (int r = lane / 16; r < 16; r += 2) {
        const int p = p0 + r;
        if (p < valid && co < cout) {
          float v = st[r * 16 + lane % 16] + bias;
          if (s.use_res) v += xs[(p + w) * lx + co];
          oimg[(int64_t)p * cout + co] = __float2bfloat16_rn(v);
        }
      }
      __syncwarp();
    }
  }
#ifdef ASL_PHASE_CLOCKS
  __syncthreads();
  PHASE_END(5)  // epilogue
  if (t == 0) atomicAdd(&asl_phase_cycles[6], 1ull);
#endif
}

// ---------------------------------------------------------------------------
// fp32 x: CUDA-core FMAs.

struct Shape {
  int h, w, cin, ce, cout;
  int tr;   // output rows per block
  int cot;  // output channels per block
  int use_res;
};

// Shared memory, in floats, of one block. The x tile's channel stride is
// cin + 1 and the depthwise tile's kChunk + 1, so that the two pixels a
// warp touches at once fall in different banks.
__host__ __device__ inline int64_t smem_floats(const Shape& s) {
  const int64_t halo = (int64_t)(s.tr + 2) * (s.w + 2);
  return halo * (s.cin + 1)                      // x tile
         + halo * kChunk                         // expanded chunk
         + (int64_t)s.tr * s.w * (kChunk + 1)    // depthwise output
         + (int64_t)s.cin * kChunk               // w1 chunk
         + (int64_t)kChunk * s.cot               // w2 chunk
         + 9 * kChunk + 2 * kChunk;              // dw chunk, b1, b2
}

__global__ void __launch_bounds__(kThreads, 2) fused_mbconv_s1_fp32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ dw,
    const float* __restrict__ b2, const float* __restrict__ w2,
    const float* __restrict__ b3, float* __restrict__ out, const Shape s) {
  extern __shared__ float smem[];
  const int h = s.h, w = s.w, cin = s.cin, ce = s.ce, cout = s.cout;
  const int tr = s.tr, cot = s.cot;
  const int wp = w + 2, rows = tr + 2, cinp = cin + 1;
  const int row_tiles = (h + tr - 1) / tr;
  const int cout_tiles = (cout + cot - 1) / cot;

  int64_t b = blockIdx.x;
  const int ct = (int)(b % cout_tiles);
  b /= cout_tiles;
  const int r0 = (int)(b % row_tiles) * tr;  // first output row of the tile
  const int64_t img = b / row_tiles;
  const int co0 = ct * cot;  // first output channel of the tile

  float* xs = smem;                          // [rows * wp, cinp]
  float* es = xs + rows * wp * cinp;         // [rows * wp, kChunk]
  float* ds = es + rows * wp * kChunk;       // [tr * w, kChunk + 1]
  float* w1s = ds + tr * w * (kChunk + 1);   // [cin, kChunk]
  float* w2s = w1s + cin * kChunk;           // [kChunk, cot]
  float* dws = w2s + kChunk * cot;           // [9, kChunk]
  float* b1s = dws + 9 * kChunk;             // [kChunk]
  float* b2s = b1s + kChunk;                 // [kChunk]

  const int t = threadIdx.x;
  const float* ximg = x + img * h * w * cin;

  // The input rows r0-1 .. r0+tr with a one-pixel halo; 0 outside the image.
  for (int i = t; i < rows * wp * cin; i += kThreads) {
    const int ci = i % cin, q = i / cin;
    const int gr = r0 - 1 + q / wp, gc = q % wp - 1;
    float v = 0.0f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
      v = ximg[((int64_t)gr * w + gc) * cin + ci];
    }
    xs[q * cinp + ci] = v;
  }

  // Output o = p * cot + co of the tile (pixel p, channel co0 + co) lives in
  // acc[k] of thread o % kThreads, k = o / kThreads.
  const int n_out = tr * w * cot;
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < ce; c0 += kChunk) {
    __syncthreads();  // the x tile is in; the last chunk's readers are done
    // This chunk's weights; channels past ce get zero weights and biases,
    // so they contribute exactly 0.
    for (int i = t; i < cin * kChunk; i += kThreads) {
      const int c = c0 + i % kChunk;
      w1s[i] = c < ce ? w1[(int64_t)(i / kChunk) * ce + c] : 0.0f;
    }
    for (int i = t; i < kChunk * cot; i += kThreads) {
      const int c = c0 + i / cot, co = co0 + i % cot;
      w2s[i] = (c < ce && co < cout) ? w2[(int64_t)c * cout + co] : 0.0f;
    }
    for (int i = t; i < 9 * kChunk; i += kThreads) {
      const int c = c0 + i % kChunk;
      dws[i] = c < ce ? dw[(i / kChunk) * ce + c] : 0.0f;
    }
    if (t < kChunk) {
      const int c = c0 + t;
      b1s[t] = c < ce ? b1[c] : 0.0f;
      b2s[t] = c < ce ? b2[c] : 0.0f;
    }
    __syncthreads();

    // Expand + relu6 over the haloed tile; zero outside the image.
    for (int i = t; i < rows * wp * kChunk; i += kThreads) {
      const int c = i % kChunk, q = i / kChunk;
      const int gr = r0 - 1 + q / wp, gc = q % wp - 1;
      float v = 0.0f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
        const float* xq = xs + q * cinp;
        float sum = 0.0f;
        for (int ci = 0; ci < cin; ++ci) {
          sum = fmaf(xq[ci], w1s[ci * kChunk + c], sum);
        }
        v = relu6(sum + b1s[c]);
      }
      es[i] = v;
    }
    __syncthreads();

    // Depthwise 3x3 in the plain version's tap order, + b2, relu6.
    for (int i = t; i < tr * w * kChunk; i += kThreads) {
      const int c = i % kChunk, p = i / kChunk;
      const int r = p / w, col = p % w;
      float sum = 0.0f;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          sum = fmaf(es[((r + dr) * wp + col + dc) * kChunk + c],
                     dws[(dr * 3 + dc) * kChunk + c], sum);
        }
      }
      ds[p * (kChunk + 1) + c] = relu6(sum + b2s[c]);
    }
    __syncthreads();

    // Project: this chunk's share of every output of the tile.
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int o = t + k * kThreads;
      if (o < n_out) {
        const float* dp = ds + (o / cot) * (kChunk + 1);
        const float* wq = w2s + o % cot;
        float sum = acc[k];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) sum = fmaf(dp[c], wq[c * cot], sum);
        acc[k] = sum;
      }
    }
  }

  // + b3 (+ x), one write. Rows past the image are dropped.
  float* oimg = out + img * h * w * cout;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int o = t + k * kThreads;
    if (o < n_out) {
      const int p = o / cot, co = co0 + o % cot;
      const int r = p / w, col = p % w;
      if (r0 + r < h && co < cout) {
        float v = acc[k] + b3[co];
        if (s.use_res) v += xs[((r + 1) * wp + col + 1) * cinp + co];
        oimg[((int64_t)(r0 + r) * w + col) * cout + co] = v;
      }
    }
  }
}

cudaError_t smem_limit(int device, int* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
}

}  // namespace

extern "C" {

// Each entry point enqueues one launch on `stream` and returns
// cudaGetLastError() (nonzero when the launch was refused), or
// cudaErrorInvalidValue for a tile plan the kernel cannot take.

// bf16 x and out: the TF32 tensor-core kernel; `tr` output rows per block.
int asl_fused_mbconv_s1_tf32(const void* x, const void* w1, const void* b1,
                             const void* dw, const void* b2, const void* w2,
                             const void* b3, void* out, int n, int h, int w,
                             int cin, int ce, int cout, int tr, int use_res,
                             int device, void* stream) {
  int smem_max = 0;
  cudaError_t err = smem_limit(device, &smem_max);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || h < 1 || w < 1 || cin < 1 || ce < 1 || cout < 1 || tr < 1 ||
      tr > h || (use_res && cin != cout)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const TcShape s{h, w, cin, ce, cout, tr, use_res,
                  cin % 8 == 0 && aligned(x),
                  ce % 4 == 0 && cout % 4 == 0 && aligned(w1) && aligned(w2)};
  const TcTile<int64_t> g = tc_tile<int64_t>(s);
  const int64_t blocks = (int64_t)n * ((h + tr - 1) / tr);
  if ((g.frags + kWarps - 1) / kWarps > kMaxFrag || blocks > 0x7fffffff ||
      g.total * (int64_t)sizeof(float) > smem_max) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)g.total * sizeof(float);
  err = cudaFuncSetAttribute(fused_mbconv_s1_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mbconv_s1_tf32_kernel<<<(unsigned)blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)w1, (const float*)b1,
      (const float*)dw, (const float*)b2, (const float*)w2, (const float*)b3,
      (__nv_bfloat16*)out, s, tc_tile<int>(s));
  return (int)cudaGetLastError();
}

// fp32 x and out: the CUDA-core kernel; `tr` rows x `cot` channels a block.
int asl_fused_mbconv_s1_fp32(const void* x, const void* w1, const void* b1,
                             const void* dw, const void* b2, const void* w2,
                             const void* b3, void* out, int n, int h, int w,
                             int cin, int ce, int cout, int tr, int cot,
                             int use_res, int device, void* stream) {
  int smem_max = 0;
  cudaError_t err = smem_limit(device, &smem_max);
  if (err != cudaSuccess) return (int)err;
  const Shape s{h, w, cin, ce, cout, tr, cot, use_res};
  const int64_t blocks =
      (int64_t)n * ((h + tr - 1) / tr) * ((cout + cot - 1) / cot);
  if (n < 1 || h < 1 || w < 1 || cin < 1 || ce < 1 || cout < 1 || tr < 1 ||
      tr > h || cot < 1 || cot > cout ||
      (int64_t)tr * w * cot > (int64_t)kThreads * kMaxAcc ||
      (use_res && cin != cout) || blocks > 0x7fffffff ||
      smem_floats(s) * (int64_t)sizeof(float) > smem_max) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)smem_floats(s) * sizeof(float);
  err = cudaFuncSetAttribute(fused_mbconv_s1_fp32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mbconv_s1_fp32_kernel<<<(unsigned)blocks, kThreads, smem,
                                (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (const float*)dw,
      (const float*)b2, (const float*)w2, (const float*)b3, (float*)out, s);
  return (int)cudaGetLastError();
}

#ifdef ASL_PHASE_CLOCKS
// Copies the phase clocks to `out` (8 values) and zeroes them.
int asl_phase_cycles_take(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, asl_phase_cycles, 8 * sizeof(unsigned long long));
  const unsigned long long zero[8] = {0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(asl_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif

}  // extern "C"
