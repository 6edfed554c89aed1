// Clip preprocess kernels for Hopper (sm_90a), bound to Python with ctypes
// (asltpu_torch/ops/_build.py builds this file, asltpu_torch/ops/
// preprocess_kernels.py holds the wrappers, the rgb kernel's band plan, the
// launch counters and the plain PyTorch versions they are tested against).
//
// preprocess_rgb replaces asltpu/ops/preprocess_pallas.py::preprocess_clip_pallas
// (body _frame_kernel, constants _kernel_constants):
//   u8 [N, Hs, Ws, 3] -> [N, crop, crop, 3] bf16 or fp32, where each output
//   pixel is the cv2-style half-pixel bilinear sample of the short-side
//   resize, centre-cropped, then x * scale[c] + shift[c] (ImageNet
//   normalize folded with the 1/255). The TPU kernel contracts with dense
//   sampling matrices (Rh @ X @ kron(Rw^T, I3)) because the MXU wants
//   matmuls; each matrix row has at most two nonzeros, so here every output
//   value gathers its 4 taps from per-row and per-column tables (lo, hi,
//   w_lo, w_hi) built on the host from the same numpy sampling code. A tap
//   whose weight is 0 points at its partner (rgb_taps), so that nothing is
//   staged for it.
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
//
// Design for that bound: move each byte once, in 16-byte transactions, with
// many of them in flight, and spend few instructions per byte.
// - Both grids are persistent (as many blocks as the occupancy calculator
//   fits, each striding over the work by counters that step without
//   dividing), so a launch has no limit on frames but the 64-bit counts.
// - Each thread owns groups of 8 consecutive output pixels of one row (24
//   values). A warp hands its groups' 16-byte chunks through shared memory
//   so that each store instruction writes 512 contiguous bytes (three per
//   group in bf16, six in fp32), marked streaming.
// - rgb: a block of 256 threads walks (frame, band of `rows` output rows)
//   tiles. For each it stages, with 16-byte cp.async, only the input rows
//   the band's taps touch and only the byte span [3*col0, 3*col0 + span) of
//   each (at the main path: 16 rows of the 672-byte centre, at a 48-byte
//   offset), double-buffered: band i+1's rows are in flight while band i
//   computes. The tap tables sit in shared memory once per block, the
//   column taps as planes read by consecutive lanes at consecutive words.
//   Where a group samples one input row and 8 consecutive input columns,
//   each tap of weight 1 (an identity-scale resize: the main path), its 24
//   bytes come in three conflict-free 8-byte loads (byte gathers at a
//   24-byte stride per thread meet 2-way bank conflicts) and the products
//   by 1 are left out (the same bits). The arithmetic is the plain
//   version's order: rows first, then columns, then multiply by scale,
//   round, add shift, round, so an exact tap sum (the main path) gives the
//   plain version's output bits.
// - yuv420: registers only. A thread covers 2 output rows x 8 pixels, which
//   share 4 U and 4 V bytes: two 8-byte Y loads, a 4-byte U and a 4-byte V
//   load; it loads its next unit before it computes the current one.
// - Ragged edges stay in the kernels, with narrower accesses: a staged
//   16-byte chunk that would leave the input tensor is copied byte by byte;
//   unaligned staged rows, output rows whose 16-byte alignment fails, partial
//   groups, yuv420 widths with Ws % 8 != 0 and unaligned inputs take scalar
//   loads or stores. The main-path shapes take the 16-byte paths throughout.
// - Registers: each kernel and output type has the __launch_bounds__ at
//   which ptxas spills nothing (Out<T>::kRgbBlocks, kYuvBlocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;             // output pixels per thread and group
constexpr int kValues = 3 * kGroup;   // output values per group

// u8 -> fp32 without the conversion unit: the byte in the mantissa of 2^23.
__device__ __forceinline__ float byte_f32(uint32_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;
}

// 2^23 + byte `k` (compile-time after unrolling) of the little-endian word
// `w`, as fp32; subtracting 2^23 + c gives byte - c exactly.
__device__ __forceinline__ float byte_2p23(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | k));
}

// The output types: a group's 24 values packed into 16-byte chunks.
template <typename OutT>
struct Out;

// Blocks per SM the register budget is set for (__launch_bounds__), per
// kernel and output type: the most at which ptxas spills nothing.
template <>
struct Out<__nv_bfloat16> {
  static constexpr int kChunks = 3;
  static constexpr int kPerWord = 2;
  static constexpr int kRgbBlocks = 4, kYuvBlocks = 3;
  static __device__ __forceinline__ uint32_t word(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Out<float> {
  static constexpr int kChunks = 6;
  static constexpr int kPerWord = 1;
  static constexpr int kRgbBlocks = 3, kYuvBlocks = 2;
  static __device__ __forceinline__ uint32_t word(float a, float) {
    return __float_as_uint(a);
  }
};

template <typename OutT>
__device__ __forceinline__ void pack(const float (&v)[kValues],
                                     uint32_t (&w)[4 * Out<OutT>::kChunks]) {
  constexpr int P = Out<OutT>::kPerWord;
#pragma unroll
  for (int i = 0; i < 4 * Out<OutT>::kChunks; ++i)
    w[i] = Out<OutT>::word(v[P * i], v[P * i + P - 1]);
}

// Writes, for every lane of the warp (all 32 call it), the first `nv` of
// its group's 24 values, packed in `w`, at `o`. A lane whose group is whole
// and 16-byte aligned hands its chunks to the warp through `wbuf` (32 *
// kChunks chunks of shared memory): store i of lane l then writes chunk
// 32 i + l of the warp's groups, so where the groups lie end to end (a row,
// or rows that follow each other) each store instruction fills whole
// 128-byte lines, where 48-byte strides from lane to lane would touch three
// times as many; the stores are marked streaming (evict first), as the
// output is written once. Other lanes store value by value.
template <typename OutT>
__device__ __forceinline__ void store_groups(OutT* o,
                                             const uint32_t (&w)[4 * Out<OutT>::kChunks],
                                             int nv, bool active, uint4* wbuf) {
  constexpr int C = Out<OutT>::kChunks;
  const int lane = threadIdx.x & 31;
  const bool vec = active && nv == kValues && ((uintptr_t)o & 15) == 0;
  if (vec) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      wbuf[lane * C + j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
  __syncwarp();
  const unsigned long long mine = (unsigned long long)(uintptr_t)o;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int c = 32 * i + lane;
    const int src = c / C, slot = c - src * C;
    const unsigned long long base = __shfl_sync(0xffffffffu, mine, src);
    const int ok = __shfl_sync(0xffffffffu, (int)vec, src);
    if (ok) __stcs(reinterpret_cast<uint4*>(base) + slot, wbuf[c]);
  }
  __syncwarp();
  if (active && !vec) {
    constexpr int P = Out<OutT>::kPerWord;
#pragma unroll
    for (int i = 0; i < kValues; ++i) {
      if (i < nv) {
        if (P == 2)
          reinterpret_cast<uint16_t*>(o)[i] = (uint16_t)(w[i / 2] >> (16 * (i & 1)));
        else
          reinterpret_cast<uint32_t*>(o)[i] = w[i];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one of this thread's cp.async groups is pending.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One rgb launch. tables (int32; the weights are fp32 bits):
//   [crop][4] rows (lo, hi, w_lo, w_hi), absolute input rows;
//   [crop][4] columns (lo, hi, w_lo, w_hi), lo and hi as byte offsets
//   3 * (col - col0) into the staged span;
//   [groups rounded up to 4] 1 where a group's 8 columns are unit taps:
//   consecutive, each of weight 1 (preprocess_kernels._rgb_tables);
//   [nbands][2] (first staged input row, staged rows) of each band.
// Shared memory (RgbSmem): the tables but the bands, the column table as 4
// planes (lo, hi, w_lo, w_hi), each pixel-major within groups (column 8 g +
// p at p * groups + g, so that the lanes of a warp, on consecutive groups,
// read consecutive words), the warps' store chunks, two staging buffers.
struct RgbArgs {
  const uint8_t* x;
  const int* tables;
  float scale[3], shift[3];  // kernel parameters, read from the constant bank
  long long n;       // frames
  int hs, ws, crop;
  int rows;          // output rows per band
  int nbands;
  int col0;          // first staged input column
  int span;          // staged bytes per row
  int pitch;         // bytes between staged rows in shared memory, % 16 == 0
  int stage_rows;    // rows of one staging buffer
};

// int32 words of the tables but the bands: as given (rgb_table_words in
// preprocess_kernels), and in shared memory, where the column table has a
// slot for every pixel of every group.
__host__ __device__ __forceinline__ int rgb_flag_words(int groups) { return (groups + 3) & ~3; }

__device__ __forceinline__ int rgb_table_words(int crop) {
  return 8 * crop + rgb_flag_words((crop + kGroup - 1) / kGroup);
}

// The rgb kernel's dynamic shared memory, in bytes from its start: the
// tables but the bands, the warps' store chunks (kThreads groups of
// `chunks` 16-byte chunks), two staging buffers of stage_rows x pitch. The
// kernel and its launcher both take the layout from here;
// preprocess_kernels.rgb_band_plan only estimates its total to choose the
// rows per band, and asl_preprocess_rgb_smem_bytes lets a test hold that
// estimate to this.
struct RgbSmem {
  int chunks_at, stage_at, bytes;
  __host__ __device__ __forceinline__ RgbSmem(int crop, int stage_rows, int pitch,
                                              int chunks) {
    const int groups = (crop + kGroup - 1) / kGroup;
    chunks_at = 4 * (4 * crop + 4 * kGroup * groups + rgb_flag_words(groups));
    stage_at = chunks_at + 16 * kThreads * chunks;
    bytes = stage_at + 2 * stage_rows * pitch;
  }
};

// Stepping through a row-major grid of `n` columns by a fixed stride of
// `dhi` rows and `dlo` < n columns, without dividing on the way.
template <typename Hi>
__device__ __forceinline__ void grid_step(Hi& hi, int& lo, int dhi, int dlo,
                                          int n) {
  hi += dhi;
  lo += dlo;
  if (lo >= n) {
    lo -= n;
    ++hi;
  }
}

// A thread's first position and its stride of kThreads in a grid of `n`
// columns.
struct Walk {
  int hi0, lo0, dhi, dlo;
  __device__ __forceinline__ explicit Walk(int n)
      : hi0((int)threadIdx.x / n),
        lo0((int)threadIdx.x - ((int)threadIdx.x / n) * n),
        dhi(kThreads / n),
        dlo(kThreads - (kThreads / n) * n) {}
};

// Stages band `band` of frame `f` into `buf`: per staged row, the 16-byte
// chunks from the span's start rounded down to 16 to its end; a chunk that
// would leave the input tensor is copied byte by byte (its bytes inside the
// span only). Staged byte b of row s sits at buf + s * pitch + off(s) + b,
// off(s) being the row span's start modulo 16. `w` walks (row, chunk).
__device__ __forceinline__ void rgb_stage(const RgbArgs& a, const Walk& w,
                                          long long f, int y0, int ny,
                                          uint8_t* buf) {
  const long long row_bytes = 3LL * a.ws;
  const uint8_t* x_end = a.x + a.n * a.hs * row_bytes;
  const uint8_t* first = a.x + f * a.hs * row_bytes + y0 * row_bytes + 3 * a.col0;
  const int chunks = a.pitch >> 4;
  for (int s = w.hi0, k = w.lo0; s < ny; grid_step(s, k, w.dhi, w.dlo, chunks)) {
    const uint8_t* lo = first + s * row_bytes;
    const uint8_t* hi = lo + a.span;
    const uint8_t* q = (const uint8_t*)((uintptr_t)lo & ~(uintptr_t)15) + 16 * k;
    uint8_t* dst = buf + s * a.pitch + 16 * k;
    if (q >= hi) {
    } else if (q >= a.x && q + 16 <= x_end) {
      cp_async16(dst, q);
    } else {
      for (int i = 0; i < 16; ++i)
        if (q + i >= lo && q + i < hi) dst[i] = q[i];
    }
  }
}

__device__ __forceinline__ void load24(const uint8_t* p, uint32_t (&w)[6]) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint2 t = q[i];
    w[2 * i] = t.x;
    w[2 * i + 1] = t.y;
  }
}

// Band `band` of frame `f` from its staged rows in `buf`; `w` walks
// (output row of the band, group), the warps' trips uniform so that each
// warp stores its groups together.
template <typename OutT>
__device__ __forceinline__ void rgb_compute(const RgbArgs& a, const Walk& w,
                                            long long f, int band, int y0,
                                            const uint8_t* buf,
                                            const int4* s_rows,
                                            const int* s_cols,
                                            const int* s_flags, uint4* wbuf,
                                            OutT* out) {
  const long long row_bytes = 3LL * a.ws;
  // Staged row s starts at (span start of frame row y0 + s) modulo 16.
  const uint32_t off0 = (uint32_t)((uintptr_t)a.x + f * a.hs * row_bytes +
                                   y0 * row_bytes + 3 * a.col0);
  const uint32_t rb = (uint32_t)row_bytes;
  const int oy0 = band * a.rows;
  const int nrows = min(a.rows, a.crop - oy0);
  const int groups = (a.crop + kGroup - 1) / kGroup;
  const int total = nrows * groups;
  int r = w.hi0, g = w.lo0;
  for (int base = threadIdx.x & ~31; base < total;
       base += kThreads, grid_step(r, g, w.dhi, w.dlo, groups)) {
    const bool active = r < nrows;
    uint32_t packed[4 * Out<OutT>::kChunks];
    int np = 0;
    OutT* o = out;
    if (active) {
      float v[kValues];
      const int oy = oy0 + r;
      const int4 rt = s_rows[oy];
      const int sl = rt.x - y0, sh = rt.y - y0;
      const float wyl = __int_as_float(rt.z), wyh = __int_as_float(rt.w);
      const uint8_t* rl = buf + sl * a.pitch + ((off0 + sl * rb) & 15);
      const uint8_t* rh = buf + sh * a.pitch + ((off0 + sh * rb) & 15);
      const int px0 = g * kGroup;
      np = min(kGroup, a.crop - px0);
      o = out + ((f * a.crop + oy) * a.crop + px0) * 3;
      // The column planes (lo, hi, w_lo, w_hi) at pixel 0 of group g;
      // pixel p is p * groups further on.
      const int* xlo = s_cols + g;
      const int* xhi = xlo + kGroup * groups;
      const float* wxlo = reinterpret_cast<const float*>(xhi + kGroup * groups);
      const float* wxhi = wxlo + kGroup * groups;
      const int xb0 = xlo[0];
      if (s_flags[g] && sh == sl && wyl == 1.0f && wyh == 0.0f &&
          ((uintptr_t)(rl + xb0) & 7) == 0) {
        // Unit taps (an identity-scale resize: the main path): one row, 8
        // consecutive columns, each of weight 1. The group's 24 bytes come
        // in three 8-byte loads, and the products by 1 (and by the hi taps'
        // 0) are left out: they give the same bits.
        uint32_t wl[6];
        load24(rl + xb0, wl);
#pragma unroll
        for (int k = 0; k < kValues; ++k) {
          const float p0 = byte_2p23(wl[k >> 2], k & 3) - 8388608.0f;
          v[k] = __fadd_rn(__fmul_rn(p0, a.scale[k % 3]), a.shift[k % 3]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < kGroup; ++p) {
          if (p < np) {
            const int xl = xlo[p * groups], xh = xhi[p * groups];
            const float wxl = wxlo[p * groups], wxh = wxhi[p * groups];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float p00 = byte_f32(rl[xl + c]), p01 = byte_f32(rl[xh + c]);
              const float p10 = byte_f32(rh[xl + c]), p11 = byte_f32(rh[xh + c]);
              // Rows first, then columns: the order of the plain version's
              // two contractions.
              const float col_lo = wyl * p00 + wyh * p10;
              const float col_hi = wyl * p01 + wyh * p11;
              const float s = wxl * col_lo + wxh * col_hi;
              // Multiply, round, add, round: the plain version's two
              // elementwise ops, so an exact tap sum gives the same bits.
              v[3 * p + c] = __fadd_rn(__fmul_rn(s, a.scale[c]), a.shift[c]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) v[3 * p + c] = 0.0f;
          }
        }
      }
      pack<OutT>(v, packed);
    }
    store_groups<OutT>(o, packed, 3 * np, active, wbuf);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, Out<OutT>::kRgbBlocks)
    preprocess_rgb_kernel(RgbArgs a, OutT* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int table_words = rgb_table_words(a.crop);
  const int groups = (a.crop + kGroup - 1) / kGroup;
  const int4* s_rows = reinterpret_cast<const int4*>(smem);
  const int* s_cols = reinterpret_cast<const int*>(s_rows + a.crop);
  const int* s_flags = s_cols + 4 * kGroup * groups;
  const RgbSmem lay(a.crop, a.stage_rows, a.pitch, Out<OutT>::kChunks);
  uint4* s_out = reinterpret_cast<uint4*>(smem + lay.chunks_at);
  uint8_t* stage = smem + lay.stage_at;
  uint4* wbuf = s_out + (threadIdx.x >> 5) * 32 * Out<OutT>::kChunks;
  const int* bands = a.tables + table_words;
  for (int i = threadIdx.x; i < table_words; i += kThreads) {
    int at = i;  // row table
    const int x = i / 4 - a.crop;
    if (x >= a.crop)  // flags
      at = i + 4 * (kGroup * groups - a.crop);
    else if (x >= 0)  // column table: plane i & 3, column x
      at = 4 * a.crop + (i & 3) * kGroup * groups + (x % kGroup) * groups + x / kGroup;
    reinterpret_cast<int*>(smem)[at] = a.tables[i];
  }
  const Walk stage_walk(a.pitch >> 4);
  const Walk group_walk(groups);

  // Tiles (frame f, band) from blockIdx.x on, gridDim.x apart.
  const int stage_bytes = a.stage_rows * a.pitch;
  long long f = blockIdx.x / a.nbands;
  int band = (int)(blockIdx.x - f * a.nbands);
  const int df = gridDim.x / a.nbands, dband = gridDim.x - df * a.nbands;
  if (f < a.n)
    rgb_stage(a, stage_walk, f, bands[2 * band], bands[2 * band + 1], stage);
  cp_async_commit();
  for (int b = 0; f < a.n; b ^= 1) {
    long long nf = f;  // the next tile, staged while this one computes
    int nband = band;
    grid_step(nf, nband, df, dband, a.nbands);
    if (nf < a.n)
      rgb_stage(a, stage_walk, nf, bands[2 * nband], bands[2 * nband + 1],
                stage + (b ^ 1) * stage_bytes);
    cp_async_commit();
    cp_async_wait_prior();  // this tile's rows have landed
    __syncthreads();        // ... for every thread, byte copies included
    rgb_compute<OutT>(a, group_walk, f, band, bands[2 * band],
                      stage + b * stage_bytes, s_rows, s_cols, s_flags, wbuf, out);
    __syncthreads();        // the buffer is free for the tile after next
    f = nf;
    band = nband;
  }
}

// One unit of the yuv420 kernel: 2 output rows x 8 pixels of one frame.
struct YuvUnit {
  uint32_t y[4];  // row 0 pixels 0-3, 4-7; row 1 pixels 0-3, 4-7
  uint32_t u, v;  // chroma of pixel pairs 0-3
};

struct YuvArgs {
  const uint8_t* x;
  const float* k;  // fp32 [15] (ky[3], ku[3], kv[3], lo[3], hi[3]); lo is
                   // also the bias (the normalized image of 0)
  long long n;     // frames
  int hs, ws, groups;
  bool vec;  // Ws % 8 == 0 and x 8-byte aligned: every load is a vector
};

// A unit's place: frame f, row pair j, group g.
struct YuvPos {
  long long f;
  int j, g;
};

__device__ __forceinline__ YuvUnit yuv_load(const YuvArgs& a, const YuvPos& q) {
  const long long plane = (long long)a.hs * a.ws;
  const uint8_t* frame = a.x + q.f * (plane * 3 / 2);
  const uint8_t* y0 = frame + (long long)(2 * q.j) * a.ws + kGroup * q.g;
  const uint8_t* y1 = y0 + a.ws;
  const uint8_t* cu = frame + plane + (long long)q.j * (a.ws >> 1) + (kGroup / 2) * q.g;
  const uint8_t* cv = cu + plane / 4;
  YuvUnit d;
  if (a.vec) {
    const uint2 t0 = __ldg(reinterpret_cast<const uint2*>(y0));
    const uint2 t1 = __ldg(reinterpret_cast<const uint2*>(y1));
    d.y[0] = t0.x; d.y[1] = t0.y; d.y[2] = t1.x; d.y[3] = t1.y;
    d.u = __ldg(reinterpret_cast<const uint32_t*>(cu));
    d.v = __ldg(reinterpret_cast<const uint32_t*>(cv));
  } else {
    const int np = min(kGroup, a.ws - kGroup * q.g);  // even: Ws and 8g are
    d.y[0] = d.y[1] = d.y[2] = d.y[3] = d.u = d.v = 0;
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p < np) {
        d.y[p >> 2] |= (uint32_t)__ldg(y0 + p) << (8 * (p & 3));
        d.y[2 + (p >> 2)] |= (uint32_t)__ldg(y1 + p) << (8 * (p & 3));
      }
    }
#pragma unroll
    for (int p = 0; p < kGroup / 2; ++p) {
      if (2 * p < np) {
        d.u |= (uint32_t)__ldg(cu + p) << (8 * p);
        d.v |= (uint32_t)__ldg(cv + p) << (8 * p);
      }
    }
  }
  return d;
}

// The unit's two output rows, stored by the whole warp (all lanes call).
template <typename OutT>
__device__ __forceinline__ void yuv_store(const YuvArgs& a, const YuvPos& q,
                                          bool active, const YuvUnit& d,
                                          const float (&k)[15], uint4* wbuf,
                                          OutT* out) {
  const int np = active ? min(kGroup, a.ws - kGroup * q.g) : 0;
  // chroma - 128 and max(Y - 16, 0), each difference exact in fp32.
  float u[kGroup / 2], v[kGroup / 2];
#pragma unroll
  for (int p = 0; p < kGroup / 2; ++p) {
    u[p] = byte_2p23(d.u, p) - 8388736.0f;  // 2^23 + 128
    v[p] = byte_2p23(d.v, p) - 8388736.0f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float vals[kValues];
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      const float m = fmaxf(byte_2p23(d.y[2 * r + (p >> 2)], p & 3) - 8388624.0f, 0.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lo = k[9 + c];
        float acc = m * k[c] + u[p >> 1] * k[3 + c] + v[p >> 1] * k[6 + c] + lo;
        vals[3 * p + c] = fminf(fmaxf(acc, lo), k[12 + c]);
      }
    }
    OutT* o = out + (((q.f * a.hs) + 2 * q.j + r) * a.ws + kGroup * q.g) * 3;
    uint32_t packed[4 * Out<OutT>::kChunks];
    pack<OutT>(vals, packed);
    store_groups<OutT>(o, packed, 3 * np, active, wbuf);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, Out<OutT>::kYuvBlocks)
    preprocess_yuv420_kernel(YuvArgs a, OutT* __restrict__ out) {
  __shared__ uint4 s_out[kThreads * Out<OutT>::kChunks];
  uint4* wbuf = s_out + (threadIdx.x >> 5) * 32 * Out<OutT>::kChunks;
  float k[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) k[i] = a.k[i];
  // Units (f, j, g) in row-major order, thread t0 first, `step` apart;
  // each lane loads its next unit before it computes the current one.
  const int pairs = a.hs >> 1, per_frame = pairs * a.groups;
  const int t0 = blockIdx.x * kThreads + threadIdx.x;
  const int step = gridDim.x * kThreads;
  const int df = step / per_frame;
  const int rest = step - df * per_frame;
  const int dj = rest / a.groups, dg = rest - dj * a.groups;
  YuvPos cur;
  cur.f = t0 / per_frame;
  cur.j = (t0 - (int)cur.f * per_frame) / a.groups;
  cur.g = t0 - (int)cur.f * per_frame - cur.j * a.groups;
  YuvUnit d = {};
  if (cur.f < a.n) d = yuv_load(a, cur);
  const long long units = a.n * per_frame;
  for (long long base = t0 - (threadIdx.x & 31); base < units; base += step) {
    YuvPos nxt = cur;
    nxt.f += df;
    grid_step(nxt.j, nxt.g, dj, dg, a.groups);
    if (nxt.j >= pairs) {
      nxt.j -= pairs;
      ++nxt.f;
    }
    YuvUnit dn = {};
    if (nxt.f < a.n) dn = yuv_load(a, nxt);
    yuv_store<OutT>(a, cur, cur.f < a.n, d, k, wbuf, out);
    cur = nxt;
    d = dn;
  }
}

// A persistent grid: as many blocks as fit on the card at once, at most one
// per unit of work.
template <typename K>
int persistent_blocks(K kernel, int smem, long long work, int device,
                      int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * per_sm;
  *blocks = (int)(work < most ? work : most);
  return 0;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (or the error of the occupancy query), which is nonzero
// when the launch was refused. `consts` is fp32 (scale[3], shift[3]) in
// host memory for rgb, copied into the kernel's parameters, and (ky, ku,
// kv, lo, hi)[3] in device memory for yuv420. The rgb band sizes come from
// preprocess_kernels.rgb_band_plan; the shared memory they need is RgbSmem's,
// and a launch that needs more than a block may have is refused (by
// cudaFuncSetAttribute).
int asl_preprocess_rgb_smem_bytes(int crop, int stage_rows, int pitch, int out_bf16) {
  return RgbSmem(crop, stage_rows, pitch,
                 out_bf16 ? Out<__nv_bfloat16>::kChunks : Out<float>::kChunks)
      .bytes;
}

int asl_preprocess_rgb(const void* x, void* out, const void* tables,
                       const void* consts, long long n, int hs, int ws,
                       int crop, int rows, int nbands, int col0, int span,
                       int pitch, int stage_rows, int out_bf16, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* k = (const float*)consts;
  RgbArgs a{(const uint8_t*)x, (const int*)tables, {k[0], k[1], k[2]},
            {k[3], k[4], k[5]}, n, hs, ws, crop, rows, nbands, col0, span,
            pitch, stage_rows};
  const int smem_bytes = asl_preprocess_rgb_smem_bytes(crop, stage_rows, pitch, out_bf16);
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0, rc;
  if (out_bf16) {
    rc = persistent_blocks(preprocess_rgb_kernel<__nv_bfloat16>, smem_bytes,
                           n * nbands, device, &blocks);
    if (rc) return rc;
    preprocess_rgb_kernel<__nv_bfloat16><<<blocks, kThreads, smem_bytes, s>>>(
        a, (__nv_bfloat16*)out);
  } else {
    rc = persistent_blocks(preprocess_rgb_kernel<float>, smem_bytes, n * nbands,
                           device, &blocks);
    if (rc) return rc;
    preprocess_rgb_kernel<float><<<blocks, kThreads, smem_bytes, s>>>(
        a, (float*)out);
  }
  return (int)cudaGetLastError();
}

int asl_preprocess_yuv420(const void* x, void* out, const void* consts,
                          long long n, int hs, int ws, int out_bf16, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int groups = (ws + kGroup - 1) / kGroup;
  YuvArgs a{(const uint8_t*)x, (const float*)consts, n, hs, ws, groups,
            ws % kGroup == 0 && ((uintptr_t)x & 7) == 0};
  cudaStream_t s = (cudaStream_t)stream;
  const long long threads_needed = (n * (hs / 2) * groups + kThreads - 1) / kThreads;
  int blocks = 0, rc;
  if (out_bf16) {
    rc = persistent_blocks(preprocess_yuv420_kernel<__nv_bfloat16>, 0,
                           threads_needed, device, &blocks);
    if (rc) return rc;
    preprocess_yuv420_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, (__nv_bfloat16*)out);
  } else {
    rc = persistent_blocks(preprocess_yuv420_kernel<float>, 0, threads_needed,
                           device, &blocks);
    if (rc) return rc;
    preprocess_yuv420_kernel<float><<<blocks, kThreads, 0, s>>>(a, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
