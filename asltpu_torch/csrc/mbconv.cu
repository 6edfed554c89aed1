// Fused stride-1 MBConv (inverted-residual) kernel for Hopper (sm_90a),
// bound to Python with ctypes (asltpu_torch/ops/_build.py builds this file,
// asltpu_torch/ops/mbconv_kernels.py holds the wrapper, its launch counter,
// its tile plan and the plain PyTorch version it is tested against).
//
// Replaces asltpu/ops/mbconv_pallas.py::fused_mbconv_s1 (body _make_kernel).
// With BN folded into the weights (fold_bn), one block of MobileNetV2 is
//
//   out = relu6(dw3x3(mask(relu6(x . w1 + b1))) + b2) . w2 + b3  (+ x)
//
// x is NHWC [N, H, W, Cin] in bf16 or fp32, w1 [Cin, Ce], dw [9, Ce]
// (row-major taps, dr*3+dc), w2 [Ce, Cout], all weights and all arithmetic
// fp32, one rounding to x's type at the end. The residual is added when the
// wrapper asks for it (Cin == Cout). "mask" zeroes the expanded activation
// at the zero padding around the image: the expand of a zero pixel is
// relu6(b1), not 0, and the depthwise must see zeros there.
//
// What bounds it: the block's inputs and outputs are a few bytes per pixel
// (Cin + Cout values) while the work is 2*Cin*Ce + 18*Ce + 2*Ce*Cout
// operations per pixel, with Ce = 6*Cin. At the main path's shapes that is
// about 170-900 operations per byte: above the H100's ~295 for bf16 tensor cores
// only at H <= 14, so the 56^2 and 28^2 blocks are bound by bytes and the
// rest by operations (counted at the bf16 tensor-core peak, so that no
// later redesign with bf16 operands reads over 100%). Unfused, the 6x
// expanded activation would go to device memory and back twice per block.
//
// Design: the expanded tensor never leaves the SM. One thread block takes
// one image, a tile of `tr` output rows and `cot` output channels (the
// wrapper's tile plan picks both so that every output of the tile has a
// register accumulator and the shared memory fits). It loads its input rows
// plus a one-pixel halo straight from the unpadded x into shared memory
// (fp32; reads outside the image give 0, so no padded copy is made), then
// walks the expanded channels in chunks of kChunk:
//   expand  the chunk over the haloed tile into shared memory, skipping
//           (zeroing) every position outside the image; halo rows inside
//           the image are real pixels and keep their value;
//   depthwise 3x3 + b2 + relu6 over the tile's output pixels, into shared
//           memory;
//   project the chunk's share into the per-thread fp32 accumulators.
// Then b3 and the residual (from the shared x tile) are added and every
// output is written once. Plain fp32 FMAs on CUDA cores, no tensor cores,
// no vector loads: a simple, right first version. Its time beside its bound
// is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;   // expanded channels per pass
constexpr int kMaxAcc = 32;  // output accumulators per thread

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float relu6(float v) {
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fused_mbconv_s1_kernel(
    const T* __restrict__ x, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ dw,
    const float* __restrict__ b2, const float* __restrict__ w2,
    const float* __restrict__ b3, T* __restrict__ out, const Shape s) {
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
  const T* ximg = x + img * h * w * cin;

  // The input rows r0-1 .. r0+tr with a one-pixel halo; 0 outside the image.
  for (int i = t; i < rows * wp * cin; i += kThreads) {
    const int ci = i % cin, q = i / cin;
    const int gr = r0 - 1 + q / wp, gc = q % wp - 1;
    float v = 0.0f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
      v = to_f32(ximg[((int64_t)gr * w + gc) * cin + ci]);
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

  // + b3 (+ x), one rounding, one write. Rows past the image are dropped.
  T* oimg = out + img * h * w * cout;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int o = t + k * kThreads;
    if (o < n_out) {
      const int p = o / cot, co = co0 + o % cot;
      const int r = p / w, col = p % w;
      if (r0 + r < h && co < cout) {
        float v = acc[k] + b3[co];
        if (s.use_res) v += xs[((r + 1) * wp + col + 1) * cinp + co];
        oimg[((int64_t)(r0 + r) * w + col) * cout + co] = from_f32<T>(v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* dw,
           const void* b2, const void* w2, const void* b3, void* out,
           int64_t blocks, const Shape& s, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mbconv_s1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mbconv_s1_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)x, (const float*)w1, (const float*)b1, (const float*)dw,
      (const float*)b2, (const float*)w2, (const float*)b3, (T*)out, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream` and returns cudaGetLastError() (nonzero
// when the launch was refused), or cudaErrorInvalidValue for a tile plan
// the kernel cannot take.
int asl_fused_mbconv_s1(const void* x, const void* w1, const void* b1,
                        const void* dw, const void* b2, const void* w2,
                        const void* b3, void* out, int n, int h, int w,
                        int cin, int ce, int cout, int tr, int cot,
                        int use_res, int x_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{h, w, cin, ce, cout, tr, cot, use_res};
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)n * ((h + tr - 1) / tr) * ((cout + cot - 1) / cot);
  if (n < 1 || h < 1 || w < 1 || cin < 1 || ce < 1 || cout < 1 || tr < 1 ||
      tr > h || cot < 1 || cot > cout ||
      (int64_t)tr * w * cot > (int64_t)kThreads * kMaxAcc ||
      (use_res && cin != cout) || blocks > 0x7fffffff ||
      smem_floats(s) * (int64_t)sizeof(float) > smem_max) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    return launch<__nv_bfloat16>(x, w1, b1, dw, b2, w2, b3, out, blocks, s, st);
  }
  return launch<float>(x, w1, b1, dw, b2, w2, b3, out, blocks, s, st);
}

}  // extern "C"
