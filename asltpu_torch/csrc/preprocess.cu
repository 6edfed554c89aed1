// Clip preprocess kernels for Hopper (sm_90a), bound to Python with ctypes
// (asltpu_torch/ops/_build.py builds this file, asltpu_torch/ops/
// preprocess_kernels.py holds the wrappers, their launch counters and the
// plain PyTorch versions they are tested against).
//
// preprocess_rgb replaces asltpu/ops/preprocess_pallas.py::preprocess_clip_pallas
// (body _frame_kernel, constants _kernel_constants):
//   u8 [N, Hs, Ws, 3] -> [N, crop, crop, 3] bf16 or fp32, where each output
//   pixel is the cv2-style half-pixel bilinear sample of the short-side
//   resize, centre-cropped, then x * scale[c] + shift[c] (ImageNet
//   normalize folded with the 1/255). The TPU kernel contracts with dense
//   sampling matrices (Rh @ X @ kron(Rw^T, I3)) because the MXU wants
//   matmuls; each matrix row has at most two nonzeros, so here every output
//   pixel gathers its 4 taps from per-row and per-column tables (lo, hi,
//   w_lo, w_hi) built on the host from the same numpy sampling code.
//
// preprocess_yuv420 replaces preprocess_pallas.py::preprocess_clip_yuv420_pallas
// (body _yuv_frame_kernel, constants _yuv_kernel_constants):
//   packed I420 u8 [N, Hs*3/2, Ws] -> [N, Hs, Ws, 3] bf16 or fp32:
//   max(Y-16, 0), chroma - 128 replicated 2x2, BT.601 studio swing and the
//   normalize folded into 3 coefficients per channel, then a clamp to the
//   normalized image of [0, 255] (equal to clip-then-normalize, since the
//   per-channel normalize is a monotone affine map). The TPU kernel's
//   one-hot matmuls only work around Mosaic's lane limits; here each thread
//   reads its Y, U and V bytes directly.
//
// Bound: both are pure memory passes. Per output value they do a handful of
// FMAs on 4 (rgb) or 3 (yuv) loaded bytes, far below the ~295 FLOP/byte
// where H100 compute would matter, so the least time is the bytes moved
// (input read once + output written once) over the card's memory bandwidth.
// For rgb the input counted is the pixels that carry a nonzero tap weight:
// the centre 224^2 crop at the main path's identity 256^2 resize.
// Design for that bound: one thread per output pixel, neighbouring threads
// on neighbouring output columns, so the output rows are written with
// coalesced stores and the input taps of a warp fall in a few cache lines;
// no shared memory, no tensor cores, nothing staged in device memory.
// A simple, correct first version: vector loads and stores and several
// pixels per thread are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// idx: int32 [4, crop] = (row lo, row hi, col lo, col hi);
// w: fp32 [4, crop] = (row w_lo, row w_hi, col w_lo, col w_hi);
// consts: fp32 [6] = (scale[3], shift[3]).
template <typename OutT>
__global__ void __launch_bounds__(1024) preprocess_rgb_kernel(
    const uint8_t* __restrict__ x, OutT* __restrict__ out,
    const int* __restrict__ idx, const float* __restrict__ w,
    const float* __restrict__ consts, int hs, int ws, int crop) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= crop) return;
  const int oy = blockIdx.y;
  const int64_t f = blockIdx.z;

  const int y_lo = idx[oy], y_hi = idx[crop + oy];
  const int x_lo = idx[2 * crop + ox], x_hi = idx[3 * crop + ox];
  const float wy_lo = w[oy], wy_hi = w[crop + oy];
  const float wx_lo = w[2 * crop + ox], wx_hi = w[3 * crop + ox];

  const int64_t row = (int64_t)ws * 3;
  const uint8_t* frame = x + f * hs * row;
  const uint8_t* r0 = frame + y_lo * row;
  const uint8_t* r1 = frame + y_hi * row;
  OutT* o = out + ((f * crop + oy) * crop + ox) * 3;

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p00 = r0[x_lo * 3 + c], p01 = r0[x_hi * 3 + c];
    const float p10 = r1[x_lo * 3 + c], p11 = r1[x_hi * 3 + c];
    // Rows first, then columns: the order of the plain version's two
    // contractions. Where the clamp made lo == hi both taps read one pixel
    // and their weights add, as the two += into one matrix column do.
    const float col_lo = wy_lo * p00 + wy_hi * p10;
    const float col_hi = wy_lo * p01 + wy_hi * p11;
    const float v = wx_lo * col_lo + wx_hi * col_hi;
    // Multiply, round, add, round: the plain version's two elementwise ops,
    // so an exact tap sum gives the same output bits.
    o[c] = to_out<OutT>(__fadd_rn(__fmul_rn(v, consts[c]), consts[3 + c]));
  }
}

// consts: fp32 [15] = (ky[3], ku[3], kv[3], lo[3], hi[3]); lo is also the
// bias (the normalized image of 0).
template <typename OutT>
__global__ void __launch_bounds__(1024) preprocess_yuv420_kernel(
    const uint8_t* __restrict__ x, OutT* __restrict__ out,
    const float* __restrict__ consts, int hs, int ws) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ws) return;
  const int oy = blockIdx.y;
  const int64_t f = blockIdx.z;

  const uint8_t* frame = x + f * ((int64_t)hs * 3 / 2) * ws;
  const int chroma = (oy >> 1) * (ws >> 1) + (ox >> 1);
  const float luma = frame[oy * ws + ox];
  const float u = (float)frame[hs * ws + chroma] - 128.0f;
  const float v = (float)frame[hs * ws + (hs >> 1) * (ws >> 1) + chroma] - 128.0f;
  const float m = fmaxf(luma - 16.0f, 0.0f);
  OutT* o = out + (((int64_t)f * hs + oy) * ws + ox) * 3;

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = consts[9 + c];
    float acc = m * consts[c] + u * consts[3 + c] + v * consts[6 + c] + lo;
    acc = fminf(fmaxf(acc, lo), consts[12 + c]);
    o[c] = to_out<OutT>(acc);
  }
}

int grid_block(int width, dim3* block) {
  const int threads = ((width + 31) / 32) * 32;
  block->x = threads < 1024 ? threads : 1024;
  return (width + block->x - 1) / block->x;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError(), which is nonzero when the launch was refused.
int asl_preprocess_rgb(const void* x, void* out, const void* idx,
                       const void* w, const void* consts, int n, int hs,
                       int ws, int crop, int out_bf16, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 block(1);
  dim3 grid(grid_block(crop, &block), crop, n);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* xin = (const uint8_t*)x;
  const int* tid = (const int*)idx;
  const float* tw = (const float*)w;
  const float* k = (const float*)consts;
  if (out_bf16) {
    preprocess_rgb_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        xin, (__nv_bfloat16*)out, tid, tw, k, hs, ws, crop);
  } else {
    preprocess_rgb_kernel<float><<<grid, block, 0, s>>>(
        xin, (float*)out, tid, tw, k, hs, ws, crop);
  }
  return (int)cudaGetLastError();
}

int asl_preprocess_yuv420(const void* x, void* out, const void* consts,
                          int n, int hs, int ws, int out_bf16, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 block(1);
  dim3 grid(grid_block(ws, &block), hs, n);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* xin = (const uint8_t*)x;
  const float* k = (const float*)consts;
  if (out_bf16) {
    preprocess_yuv420_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        xin, (__nv_bfloat16*)out, k, hs, ws);
  } else {
    preprocess_yuv420_kernel<float><<<grid, block, 0, s>>>(
        xin, (float*)out, k, hs, ws);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
