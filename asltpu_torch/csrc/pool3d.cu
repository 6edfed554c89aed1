// I3D's 3D max-pools for Hopper (sm_90a), bound to Python with ctypes
// (asltpu_torch/ops/_build.py builds this file, asltpu_torch/ops/
// pool3d_kernels.py holds the wrappers, the custom ops, the launch counters
// and the plain PyTorch version they are tested against).
//
// Replaces no TPU kernel: the JAX package pools with flax's max_pool, which
// XLA lowers to reduce_window; no Pallas kernel exists for it. It was added
// because on the card the plain version (pad_same's -inf copy, then aten's
// max_pool3d with int64 indices, its backward a zero fill and an atomic
// scatter) took about a third of an I3D training step.
//
// max_pool3d_fwd: x [N, T, H, W, C] (NCDHW in channels_last_3d memory),
//   bf16 or fp32 -> out [N, OT, OH, OW, C] in the same layout, plus one
//   uint8 a value: the argmax's offset inside its window, (kt * KH + kh) *
//   KW + kw counted from the window's unclipped corner (o * s - lo). Pads
//   (lo below; the one above only sets the output's extent) are implicit:
//   a tap outside the input counts as -inf, which never replaces the
//   running maximum, and no padded copy is made.
// max_pool3d_bwd: grad [N, OT, OH, OW, C] and the offsets -> grad_in
//   [N, T, H, W, C]: each input element visits the windows that cover it,
//   sums in fp32, in a fixed order, the output gradients whose offset
//   points at it, and writes its gradient once, rounded once. No atomics,
//   no zero fill, deterministic.
//
// Tie rule, aten's (max_pool3d_with_indices): the window is scanned in (t,
// h, w) order and a tap replaces the running maximum when it is greater
// or NaN. So the first maximum wins, a NaN beats every number, and of
// several NaNs the last. The first in-bounds tap is the argmax of a
// window that holds only -inf. The forward therefore gives aten's values
// bit for bit (the value kept is the input's own bits) and its gradient
// reaches the element aten's would.
//
// Bound: memory. A tap costs a compare and two selects per value, far
// below the ~295 FLOP/byte where the H100's arithmetic would matter. The
// least time is the bytes moved once: forward x + out + 1 byte a value,
// backward grad + offsets + grad_in. What the kernels spend beyond that is
// instructions: a 3^3/1 window has 27 taps, and the backward's gather 27
// windows an element.
//
// Design for that bound:
// - Channels are innermost, so a thread owns V consecutive channels of one
//   position and moves them in one access: V = 8 in bf16 and 4 in fp32
//   (16 bytes) where C and every pointer allow it. A C that is no multiple
//   of 8 (a tensor-parallel shard of 132 channels) makes every position's
//   row start off a 16-byte boundary, so bf16 then takes V = 4 (8 bytes)
//   for the whole launch, with no tail to mask. Every I3D pool's C, and
//   each of its 4-way tensor-parallel shards, is a multiple of 4; the
//   wrapper refuses a C or a pointer that allows no V here. Consecutive
//   threads take consecutive channel groups, so a warp's accesses are
//   contiguous.
// - Windows are compile-time (I3D's (1,3,3), 3^3 and 2^3; strides and pads
//   are not), so every tap and window loop unrolls, and a plane's taps are
//   loaded together with no branch between them.
// - Forward: a thread walks the input planes of one output (h, w) position
//   and keeps each plane's maximum in a ring of KT planes, so a plane is
//   read once per thread, not once per window over it (27 -> 9 + 2 taps a
//   value at 3^3/1). bf16 values are compared two at a time as bf16x2
//   (mask compares, then bit selects: the maximum keeps its input's bits).
// - Backward: a block owns a tile of input positions and channel groups,
//   stages in shared memory the gradients and offsets of the output planes
//   its windows come from (one new plane a step at stride 1, loaded into
//   registers while the step before computes), and each thread gathers
//   over the windows that cover its element: per window, one compare of
//   its V offsets at once, then a masked add of its V gradients with no
//   branch (a warp's lanes hit different windows, so a branch on the hits
//   would run for nearly every window anyway).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGridY = 65535;

// The pool's geometry, as the wrapper passes it (int32 [17]); the wrapper
// checks that every count a kernel forms in 32 bits fits.
struct Geom {
  int n, c;        // batch, channels
  int t, h, w;     // input extents
  int ot, oh, ow;  // output extents
  int kt, kh, kw;  // window
  int st, sh, sw;  // stride
  int pt, ph, pw;  // lower pads
};

// Element types by their bits. The forward stores the input's own bits
// (bf16 -> fp32 is a shift, exact for NaNs too); sums are fp32.
struct Bf16 {
  using Bits = uint16_t;
  static constexpr Bits kNegInf = 0xFF80;
  static __device__ __forceinline__ float to_float(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ Bits same_bits(float f) {
    return static_cast<Bits>(__float_as_uint(f) >> 16);
  }
  static __device__ __forceinline__ Bits round(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

struct F32 {
  using Bits = uint32_t;
  static constexpr Bits kNegInf = 0xFF800000u;
  static __device__ __forceinline__ float to_float(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ Bits same_bits(float f) { return __float_as_uint(f); }
  static __device__ __forceinline__ Bits round(float f) { return __float_as_uint(f); }
};

template <int Bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };

// V values of `Bits` moved as one access, also seen as 32-bit words.
template <typename Bits, int V>
union Vec {
  using R = typename Raw<V * sizeof(Bits)>::type;
  R raw;
  Bits v[V];
  uint32_t w[(sizeof(R) + 3) / 4];
  static __device__ __forceinline__ Vec load(const Bits* p) {
    Vec r;
    r.raw = *reinterpret_cast<const R*>(p);
    return r;
  }
  static __device__ __forceinline__ Vec splat(Bits b) {
    Vec r;
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = b;
    return r;
  }
  __device__ __forceinline__ void store(Bits* p) const { *reinterpret_cast<R*>(p) = raw; }
};

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  __nv_bfloat162 r;
  memcpy(&r, &u, sizeof(r));
  return r;
}

// The running maxima of V values in scan order, with their offsets: a value
// takes over when it is greater or NaN (aten's rule). This form, fp32's,
// compares one value at a time.
template <typename E, int V, bool kPacked = std::is_same<E, Bf16>::value>
struct RunMax {
  using Bits = typename E::Bits;
  float m[V];
  uint32_t a[V];

  __device__ __forceinline__ void start(uint32_t off) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      m[i] = -INFINITY;
      a[i] = off;
    }
  }
  // The V values of one tap at offset `off`.
  __device__ __forceinline__ void take(const Vec<Bits, V>& in, uint32_t off) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = E::to_float(in.v[i]);
      const bool t = m[i] < f || isnan(f);
      m[i] = t ? f : m[i];
      a[i] = t ? off : a[i];
    }
  }
  // Another scan's maxima, their offsets moved by `dz`.
  __device__ __forceinline__ void copy(const RunMax& o, uint32_t dz) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      m[i] = o.m[i];
      a[i] = o.a[i] + dz;
    }
  }
  // A later scan's maxima, their offsets moved by `dz`.
  __device__ __forceinline__ void take(const RunMax& o, uint32_t dz) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const bool t = m[i] < o.m[i] || isnan(o.m[i]);
      m[i] = t ? o.m[i] : m[i];
      a[i] = t ? o.a[i] + dz : a[i];
    }
  }
  __device__ __forceinline__ void store(Bits* out, uint8_t* offsets) const {
    Vec<Bits, V> res;
    Vec<uint8_t, V> at;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      res.v[i] = E::same_bits(m[i]);
      at.v[i] = static_cast<uint8_t>(a[i]);
    }
    res.store(out);
    at.store(offsets);
  }
};

// bf16 pairs: the raw bits of two values a word, compared two at a time
// (bf16x2 mask compares), the two offsets in the halves of a word. Values
// are selected as bits, so the maximum keeps its input's bits.
template <typename E, int V>
struct RunMax<E, V, true> {
  using Bits = typename E::Bits;
  static constexpr int kWords = V / 2;
  uint32_t m[kWords];
  uint32_t a[kWords];

  // Lanes of `v` that take over from `cur`: greater, or NaN.
  static __device__ __forceinline__ uint32_t takes(uint32_t cur, uint32_t v) {
    return __hlt2_mask(as_bf162(cur), as_bf162(v)) | __hneu2_mask(as_bf162(v), as_bf162(v));
  }
  __device__ __forceinline__ void start(uint32_t off) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      m[k] = 0xFF80FF80u;
      a[k] = off * 0x00010001u;
    }
  }
  __device__ __forceinline__ void take(const Vec<Bits, V>& in, uint32_t off) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t t = takes(m[k], in.w[k]);
      m[k] = (in.w[k] & t) | (m[k] & ~t);
      a[k] = (off * 0x00010001u & t) | (a[k] & ~t);
    }
  }
  __device__ __forceinline__ void copy(const RunMax& o, uint32_t dz) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      m[k] = o.m[k];
      a[k] = o.a[k] + dz * 0x00010001u;
    }
  }
  __device__ __forceinline__ void take(const RunMax& o, uint32_t dz) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t t = takes(m[k], o.m[k]);
      m[k] = (o.m[k] & t) | (m[k] & ~t);
      a[k] = ((o.a[k] + dz * 0x00010001u) & t) | (a[k] & ~t);
    }
  }
  __device__ __forceinline__ void store(Bits* out, uint8_t* offsets) const {
    Vec<Bits, V> res;
    Vec<uint8_t, V> at;
#pragma unroll
    for (int k = 0; k < kWords; ++k) res.w[k] = m[k];
#pragma unroll
    for (int k = 0; k < kWords / 2; ++k) at.w[k] = __byte_perm(a[2 * k], a[2 * k + 1], 0x6420);
    res.store(out);
    at.store(offsets);
  }
};

// The windows o (inclusive range) with o * s - pad <= i <= o * s - pad + k - 1.
__device__ __forceinline__ void covering(int i, int pad, int k, int s, int out, int& lo,
                                         int& hi) {
  const int a = i + pad - k + 1;
  lo = a <= 0 ? 0 : (a + s - 1) / s;
  hi = min((i + pad) / s, out - 1);
}

// 0x80 in each byte of v that is 0, 0 in the others.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t v) {
  return ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v | 0x7F7F7F7Fu);
}

// Bit 8 * i + 7 set where value i of `off` equals `want` (V = 8 or 4).
template <int V>
__device__ __forceinline__ uint64_t hits(const Vec<uint8_t, V>& off, uint32_t want) {
  static_assert(V == 8 || V == 4, "offsets move 8 or 4 at a time");
  const uint32_t e = want * 0x01010101u;
  if constexpr (V == 8) {
    return zero_bytes(off.raw.x ^ e) | static_cast<uint64_t>(zero_bytes(off.raw.y ^ e)) << 32;
  } else {
    return zero_bytes(off.raw ^ e);
  }
}

// PTX prmt in its default mode: a selector nibble with its top bit set
// spreads the sign bit of the byte it names over the result byte.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// acc[i] += gv.v[i] where value i's flag (bit 8 * i + 7 of m) is set, with
// no branch: a warp's lanes hit different windows, so a branch on the hits
// runs for nearly every window anyway. Each flag byte's sign is spread over
// its value's bits (prmt), and the gradient bits are masked with it, so a
// value that does not hit adds +0 whatever its bits.
template <typename E, int V>
__device__ __forceinline__ void add_hits(float (&acc)[V], const Vec<typename E::Bits, V>& gv,
                                         uint64_t m) {
  const uint32_t flags[2] = {static_cast<uint32_t>(m), static_cast<uint32_t>(m >> 32)};
  if constexpr (std::is_same<E, Bf16>::value) {
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      // Values 2k, 2k + 1: flag bytes 2k % 4 and 2k % 4 + 1 of their word.
      const uint32_t sel = (k % 2) ? 0xBBAAu : 0x9988u;
      const uint32_t w = gv.w[k] & prmt(flags[k / 2], 0, sel);
      acc[2 * k] += __uint_as_float(w << 16);
      acc[2 * k + 1] += __uint_as_float(w & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t keep = prmt(flags[i / 4], 0, 0x8888u + 0x1111u * (i % 4));
      acc[i] += E::to_float(static_cast<typename E::Bits>(gv.v[i] & keep));
    }
  }
}

// Forward. A thread owns V channels of one output (h, w) position of one
// clip and walks the input planes in order. For each plane it takes the
// maximum over the window's KH x KW taps and keeps it, with its offset in
// the plane, in a ring of the last KT planes; an output whose window ends
// at this plane then combines the ring's planes in t order. Each input
// plane is read once per thread instead of once per window over it (3x
// fewer taps at 3^3/1), and the decomposition keeps the tie rule: the
// first in-bounds plane's result starts, and a later plane's takes over
// when its maximum is greater or NaN, which is what the scan over the
// whole window gives. A plane's taps are loaded together, with no branch
// between them: a tap outside the input loads its clamped neighbour and
// counts as -inf.
template <typename E, int V, int KT, int KH, int KW>
__global__ void __launch_bounds__(kThreads)
max_pool3d_fwd(const typename E::Bits* __restrict__ x, typename E::Bits* __restrict__ out,
               uint8_t* __restrict__ offsets, Geom g) {
  using Bits = typename E::Bits;
  constexpr int kPlane = KH * KW;
  const int chunks = g.c / V;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= g.oh * g.ow * chunks) return;
  const int pos = j / chunks;
  const int c0 = (j - pos * chunks) * V;
  const int oy = pos / g.ow;
  const int ox = pos - oy * g.ow;
  const int y0 = oy * g.sh - g.ph, x0 = ox * g.sw - g.pw;
  // Each tap's place in a plane (int32: the wrapper checks H * W * C) and
  // whether it lies inside the input.
  int tap_at[kPlane];
  bool tap_in[kPlane];
#pragma unroll
  for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KW; ++dx) {
      const int yy = y0 + dy, xq = x0 + dx;
      tap_in[dy * KW + dx] = yy >= 0 && yy < g.h && xq >= 0 && xq < g.w;
      tap_at[dy * KW + dx] =
          (min(max(yy, 0), g.h - 1) * g.w + min(max(xq, 0), g.w - 1)) * g.c + c0;
    }
  }
  const uint32_t first = (max(y0, 0) - y0) * KW + (max(x0, 0) - x0);
  const long long plane = static_cast<long long>(g.h) * g.w * g.c;
  const long long out_plane = static_cast<long long>(g.oh) * g.ow * g.c;
  const long long out_at = static_cast<long long>(pos) * g.c + c0;
  const int zend = min(g.t, (g.ot - 1) * g.st - g.pt + KT);  // planes a window reads
  const Vec<Bits, V> outside = Vec<Bits, V>::splat(E::kNegInf);
  for (int b = blockIdx.y; b < g.n; b += gridDim.y) {
    // ring[k]: plane z - (KT - 1 - k)'s maxima and their offsets in the plane.
    RunMax<E, V> ring[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) ring[k].start(first);
    int oz = 0;
    for (int z = 0; z < zend; ++z) {
#pragma unroll
      for (int k = 0; k + 1 < KT; ++k) ring[k] = ring[k + 1];
      const Bits* src = x + (static_cast<long long>(b) * g.t + z) * plane;
      Vec<Bits, V> in[kPlane];
#pragma unroll
      for (int q = 0; q < kPlane; ++q) {
        in[q] = Vec<Bits, V>::load(src + tap_at[q]);
        // A tap outside the input reads -inf, which never takes over.
        if (!tap_in[q]) in[q] = outside;
      }
      ring[KT - 1].start(first);
#pragma unroll
      for (int q = 0; q < kPlane; ++q) ring[KT - 1].take(in[q], q);
      // The outputs whose window's last in-bounds plane is z.
      for (; oz < g.ot; ++oz) {
        const int z0 = oz * g.st - g.pt;
        if (min(z0 + KT, g.t) - 1 != z) break;
        const int kf = KT - 1 - (z - max(z0, 0));  // the ring slot of its first plane
        RunMax<E, V> win;
        win.start(0);
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const uint32_t dz = static_cast<uint32_t>(z - (KT - 1 - k) - z0) * kPlane;
          if (k == kf) {
            win.copy(ring[k], dz);
          } else if (k > kf) {
            win.take(ring[k], dz);
          }
        }
        const long long o = (static_cast<long long>(b) * g.ot + oz) * out_plane + out_at;
        win.store(out + o, offsets + o);
      }
    }
  }
}

// Backward tiles: a block owns kTileY x kTileX input positions of one clip,
// kSlab channel groups of V values each (one thread each), and walks the
// input planes in order.
constexpr int kTileY = 4, kTileX = 8, kSlab = 8;
static_assert(kTileY * kTileX * kSlab == kThreads, "one thread a tile element");

// Backward. The block keeps in shared memory the gradients and offsets of
// the last KT output planes over the output positions whose windows reach
// its tile (each read from device memory once per tile; at stride 1 one new
// plane a step, loaded into registers while the step before computes).
// Each thread then gathers over the windows that cover its element (at
// most KT x KH x KW), in (t, h, w) window order: it compares a window's V
// offsets with its element's place in the window all at once, and adds
// only the gradients whose offset names the element, into fp32 sums in
// shared memory (a warp's lanes hit different values of different
// windows: a loop over the hits costs a few lanes' worth, where adding
// every value under a mask costs all of them). One rounding per element.
template <typename E, int V, int KT, int KH, int KW>
__global__ void __launch_bounds__(kThreads)
max_pool3d_bwd(const typename E::Bits* __restrict__ grad,
               const uint8_t* __restrict__ offsets, typename E::Bits* __restrict__ grad_in,
               Geom g) {
  using Bits = typename E::Bits;
  using G = Vec<Bits, V>;
  using O = Vec<uint8_t, V>;
  // Output rows and columns whose windows reach a tile: most at stride 1.
  constexpr int kRows = kTileY + KH - 1, kCols = kTileX + KW - 1;
  constexpr int kStage = (kRows * kCols * kSlab + kThreads - 1) / kThreads;
  __shared__ typename G::R sgrad[KT][kRows][kCols][kSlab];
  __shared__ typename O::R soff[KT][kRows][kCols][kSlab];
  const int chunks = g.c / V;
  const int slabs = (chunks + kSlab - 1) / kSlab;
  const int tiles_x = (g.w + kTileX - 1) / kTileX;
  const int slab = blockIdx.x % slabs;
  const int tile = blockIdx.x / slabs;
  const int y0 = tile / tiles_x * kTileY, x0 = tile % tiles_x * kTileX;
  const int cc = threadIdx.x % kSlab;
  const int y = y0 + threadIdx.x / (kSlab * kTileX);
  const int xx = x0 + threadIdx.x / kSlab % kTileX;
  const int chunk = slab * kSlab + cc;
  const bool active = y < g.h && xx < g.w && chunk < chunks;
  int oy_lo, oy_hi, ox_lo, ox_hi, unused;
  covering(y0, g.ph, KH, g.sh, g.oh, oy_lo, unused);
  covering(min(y0 + kTileY, g.h) - 1, g.ph, KH, g.sh, g.oh, unused, oy_hi);
  covering(x0, g.pw, KW, g.sw, g.ow, ox_lo, unused);
  covering(min(x0 + kTileX, g.w) - 1, g.pw, KW, g.sw, g.ow, unused, ox_hi);
  const int cols = ox_hi - ox_lo + 1;
  const int staged = (oy_hi - oy_lo + 1) * cols * kSlab;
  // This thread's share of a staged plane: up to kStage (position, group)s.
  long long stage_at[kStage];
  int stage_to[kStage];
  bool stage_in[kStage];
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int c = e % kSlab, rc = e / kSlab;
    const int r = rc / cols, col = rc - r * cols;
    const int ch = slab * kSlab + c;
    stage_in[k] = e < staged && ch < chunks;
    stage_at[k] = (static_cast<long long>(oy_lo + r) * g.ow + ox_lo + col) * g.c + ch * V;
    stage_to[k] = (r * kCols + col) * kSlab + c;
  }
  int oya, oyb, oxa, oxb;
  covering(y, g.ph, KH, g.sh, g.oh, oya, oyb);
  covering(xx, g.pw, KW, g.sw, g.ow, oxa, oxb);
  const long long oplane = static_cast<long long>(g.oh) * g.ow * g.c;
  const long long in_plane = static_cast<long long>(g.h) * g.w * g.c;
  const long long in_at = (static_cast<long long>(y) * g.w + xx) * g.c + chunk * V;
  typename G::R* const stage_g = &sgrad[0][0][0][0];
  typename O::R* const stage_o = &soff[0][0][0][0];
  constexpr int kSlot = kRows * kCols * kSlab;
  for (int b = blockIdx.y; b < g.n; b += gridDim.y) {
    const long long clip = static_cast<long long>(b) * g.ot * oplane;
    // Stage the output planes of the first input plane's windows.
    int oza, ozb;
    covering(0, g.pt, KT, g.st, g.ot, oza, ozb);
    for (int oz = oza; oz <= ozb; ++oz) {
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        if (stage_in[k]) {
          const long long at = clip + oz * oplane + stage_at[k];
          stage_g[oz % KT * kSlot + stage_to[k]] = G::load(grad + at).raw;
          stage_o[oz % KT * kSlot + stage_to[k]] = O::load(offsets + at).raw;
        }
      }
    }
    int next = ozb + 1;  // the next output plane to stage
    __syncthreads();
    for (int z = 0; z < g.t; ++z) {
      covering(z, g.pt, KT, g.st, g.ot, oza, ozb);
      // The next input plane's new output plane (at most one), into registers.
      int nza, nzb;
      covering(z + 1, g.pt, KT, g.st, g.ot, nza, nzb);
      const bool fetch = z + 1 < g.t && nzb >= next && nzb >= nza;
      G pg[kStage];
      O po[kStage];
      if (fetch) {
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          if (stage_in[k]) {
            const long long at = clip + static_cast<long long>(nzb) * oplane + stage_at[k];
            pg[k] = G::load(grad + at);
            po[k] = O::load(offsets + at);
          }
        }
      }
      if (active) {
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int jz = 0; jz < KT; ++jz) {
          const int oz = oza + jz;
          if (oz > ozb) break;
          const int slot = oz % KT;
          const uint32_t dz = (z - (oz * g.st - g.pt)) * KH;
#pragma unroll
          for (int jy = 0; jy < KH; ++jy) {
            const int oy = oya + jy;
            if (oy > oyb) break;
            const uint32_t dzy = (dz + y - (oy * g.sh - g.ph)) * KW;
#pragma unroll
            for (int jx = 0; jx < KW; ++jx) {
              const int ox = oxa + jx;
              if (ox > oxb) break;
              O off;
              off.raw = soff[slot][oy - oy_lo][ox - ox_lo][cc];
              G gv;
              gv.raw = sgrad[slot][oy - oy_lo][ox - ox_lo][cc];
              add_hits<E, V>(acc, gv, hits<V>(off, dzy + xx - (ox * g.sw - g.pw)));
            }
          }
        }
        G res;
#pragma unroll
        for (int i = 0; i < V; ++i) res.v[i] = E::round(acc[i]);
        res.store(grad_in + (static_cast<long long>(b) * g.t + z) * in_plane + in_at);
      }
      __syncthreads();
      if (fetch) {
#pragma unroll
        for (int k = 0; k < kStage; ++k) {
          if (stage_in[k]) {
            stage_g[nzb % KT * kSlot + stage_to[k]] = pg[k].raw;
            stage_o[nzb % KT * kSlot + stage_to[k]] = po[k].raw;
          }
        }
        next = nzb + 1;
        __syncthreads();
      }
    }
  }
}

// grid.x over the (h, w) positions and channel groups of an output plane,
// grid.y over the clips.
template <typename E, int V, int KT, int KH, int KW>
cudaError_t forward(const void* x, void* out, void* offsets, const Geom& g, cudaStream_t s) {
  using Bits = typename E::Bits;
  const int threads = g.oh * g.ow * (g.c / V);
  if (threads > 0 && g.n > 0) {
    const dim3 grid((threads + kThreads - 1) / kThreads, g.n < kGridY ? g.n : kGridY);
    max_pool3d_fwd<E, V, KT, KH, KW><<<grid, kThreads, 0, s>>>(
        static_cast<const Bits*>(x), static_cast<Bits*>(out), static_cast<uint8_t*>(offsets), g);
  }
  return cudaGetLastError();
}

// grid.x over the tiles and channel slabs of an input plane, grid.y over
// the clips.
template <typename E, int V, int KT, int KH, int KW>
cudaError_t backward(const void* grad, const void* offsets, void* grad_in, const Geom& g,
                     cudaStream_t s) {
  using Bits = typename E::Bits;
  const int tiles = (g.h + kTileY - 1) / kTileY * ((g.w + kTileX - 1) / kTileX);
  const int slabs = (g.c / V + kSlab - 1) / kSlab;
  if (tiles > 0 && slabs > 0 && g.n > 0) {
    const dim3 grid(tiles * slabs, g.n < kGridY ? g.n : kGridY);
    max_pool3d_bwd<E, V, KT, KH, KW><<<grid, kThreads, 0, s>>>(
        static_cast<const Bits*>(grad), static_cast<const uint8_t*>(offsets),
        static_cast<Bits*>(grad_in), g);
  }
  return cudaGetLastError();
}

// One launch's arguments; go<E, V, KT, KH, KW>() launches the kernel of
// its direction.
struct Launch {
  bool fwd;
  const void* in;       // x, or the output gradient
  const void* offsets;  // the backward's offsets
  void* out;            // out, or the input gradient
  void* offsets_out;    // the forward's offsets
  Geom g;
  cudaStream_t s;

  template <typename E, int V, int KT, int KH, int KW>
  cudaError_t go() const {
    return fwd ? forward<E, V, KT, KH, KW>(in, out, offsets_out, g, s)
               : backward<E, V, KT, KH, KW>(in, offsets, out, g, s);
  }

  // The window: I3D's three, (1, 3, 3), 3^3 and 2^3; any stride and pads.
  template <typename E, int V>
  cudaError_t window() const {
    if (g.kt == 1 && g.kh == 3 && g.kw == 3) return go<E, V, 1, 3, 3>();
    if (g.kt == 3 && g.kh == 3 && g.kw == 3) return go<E, V, 3, 3, 3>();
    if (g.kt == 2 && g.kh == 2 && g.kw == 2) return go<E, V, 2, 2, 2>();
    return cudaErrorInvalidValue;
  }
};

// The instantiation for the element type, the values a thread and the
// window: bf16 with V = 8 or 4, fp32 with V = 4; any other is refused.
cudaError_t dispatch(int bf16, int vec, const Launch& l) {
  if (bf16 && vec == 8) return l.window<Bf16, 8>();
  if (bf16 && vec == 4) return l.window<Bf16, 4>();
  if (!bf16 && vec == 4) return l.window<F32, 4>();
  return cudaErrorInvalidValue;
}

bool geom_of(const int* fields, int vec, Geom& g) {
  static_assert(sizeof(Geom) == 17 * sizeof(int), "Geom is 17 ints");
  memcpy(&g, fields, sizeof(Geom));
  return vec > 0 && g.c % vec == 0;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (nonzero when the launch was refused). `geom` is host
// memory, int32 [17] in Geom's order; `vec` is the values a thread moves
// (8 or 4 in bf16, 4 in fp32), dividing C, with every pointer aligned to
// vec values.
int asl_max_pool3d_fwd(const void* x, void* out, void* offsets, const int* geom, int bf16,
                       int vec, int device, void* stream) {
  Launch l{true, x, nullptr, out, offsets, {}, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!geom_of(geom, vec, l.g)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(bf16, vec, l));
}

int asl_max_pool3d_bwd(const void* grad, const void* offsets, void* grad_in, const int* geom,
                       int bf16, int vec, int device, void* stream) {
  Launch l{false, grad, offsets, grad_in, nullptr, {}, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!geom_of(geom, vec, l.g)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(bf16, vec, l));
}

}  // extern "C"
