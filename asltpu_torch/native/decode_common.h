// Helpers shared by both native decoders (decode.cpp / decode_av.cpp).
//
// These four functions define the sampling / rounding / staging-geometry
// contract that BOTH native backends must share with the Python oracle
// (asltpu_torch.data.staging, asltpu_torch.data.decode) — they live in one header so
// a future convention change cannot silently diverge the two backends
// (each is parity-tested against the same oracle).

#ifndef ASLTPU_NATIVE_DECODE_COMMON_H_
#define ASLTPU_NATIVE_DECODE_COMMON_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace asltpu {

// Python round(): banker's (half-to-even) rounding. std::nearbyint honors
// the FE_TONEAREST default mode, which is exactly half-to-even.
inline int py_round(double v) { return static_cast<int>(std::nearbyint(v)); }

// asltpu_torch.data.staging.resize_plan: aspect-preserving short-side resize.
inline void resize_plan(int h, int w, int short_side, int* rh, int* rw) {
  if (h <= w) {
    *rh = short_side;
    *rw = py_round(static_cast<double>(w) * short_side / h);
  } else {
    *rh = py_round(static_cast<double>(h) * short_side / w);
    *rw = short_side;
  }
}

// asltpu_torch.data.staging.uniform_sample_indices (center-of-segment).
inline void uniform_sample(int total, int num_out, std::vector<int64_t>* out) {
  out->resize(num_out);
  for (int i = 0; i < num_out; ++i) {
    double idx = (i + 0.5) * static_cast<double>(total) / num_out;
    int64_t v = static_cast<int64_t>(idx);  // trunc == floor (idx >= 0)
    (*out)[i] = std::min<int64_t>(v, total - 1);
  }
}

// Bytes of one staged frame: packed I420 ([Hs*3/2, Ws]) or RGB24.
inline size_t frame_bytes(int hs, int ws, bool yuv420) {
  return yuv420 ? static_cast<size_t>(hs) * 3 / 2 * ws
                : static_cast<size_t>(hs) * ws * 3;
}

}  // namespace asltpu

#endif  // ASLTPU_NATIVE_DECODE_COMMON_H_
