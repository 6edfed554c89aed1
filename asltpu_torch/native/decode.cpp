// Native decode + staging: a batch decodes on native threads, where
// Python-side decode would serialize on the interpreter lock against batch
// assembly and the device feed.
//
// This mirrors asltpu_torch/data/decode.py EXACTLY — same sampling convention,
// seek threshold, grab()-skipping, EOF fill, clamped aspect resize, center
// crop, BGR→RGB / BGR→I420 staging — so the Python and native paths are
// byte-identical (tests/test_torch_native_decode.py asserts it). OpenCV's
// Python wheel and these C++ calls execute the same kernels.
//
// Exposed as a plain C ABI consumed via ctypes. All entry points release no Python state — ctypes drops
// the GIL for the call duration, so a whole batch decodes on native
// threads while the interpreter does other work.
//
// Build: asltpu_torch/native/__init__.py, at first use (g++ -shared, links
// opencv core/videoio/imgproc from the system SDK).

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

#include <algorithm>
#include <atomic>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "decode_common.h"

namespace {

using asltpu::frame_bytes;
using asltpu::resize_plan;
using asltpu::uniform_sample;

// decode.py::_stage — bbox crop, clamped aspect resize, center crop,
// BGR→RGB or BGR→I420 pack, written straight into the caller's buffer.
void stage(const cv::Mat& frame_bgr_in, int hs, int ws, int host_resize_short,
           const int* bbox, bool yuv420, uint8_t* out) {
  cv::Mat frame = frame_bgr_in;
  if (bbox != nullptr) {
    int x0 = std::max(bbox[0], 0), y0 = std::max(bbox[1], 0);
    int x1 = std::min(bbox[2], frame.cols), y1 = std::min(bbox[3], frame.rows);
    if (x1 > x0 && y1 > y0) frame = frame(cv::Rect(x0, y0, x1 - x0, y1 - y0));
  }
  int short_side = host_resize_short > 0 ? host_resize_short : std::min(hs, ws);
  int rh, rw;
  resize_plan(frame.rows, frame.cols, short_side, &rh, &rw);
  rh = std::max(rh, hs);  // clamp up so the staging crop always fits
  rw = std::max(rw, ws);
  cv::Mat resized;
  if (rh != frame.rows || rw != frame.cols) {
    cv::resize(frame, resized, cv::Size(rw, rh), 0, 0, cv::INTER_LINEAR);
  } else {
    resized = frame;
  }
  int y0 = (rh - hs) / 2, x0 = (rw - ws) / 2;
  cv::Mat staged = resized(cv::Rect(x0, y0, ws, hs));
  if (yuv420) {
    cv::Mat packed(hs * 3 / 2, ws, CV_8UC1, out);
    cv::cvtColor(staged, packed, cv::COLOR_BGR2YUV_I420);
  } else {
    cv::Mat rgb(hs, ws, CV_8UC3, out);
    cv::cvtColor(staged, rgb, cv::COLOR_BGR2RGB);
  }
}

}  // namespace

extern "C" {

// Decode the uniformly-sampled frames of one video segment into `out`
// ([T, Hs*3/2, Ws] u8 for yuv420, [T, Hs, Ws, 3] u8 RGB otherwise).
// Mirrors decode.py::decode_sampled_frames. Returns 0 on success,
// -1 open failure, -2 no decodable frames.
int asltpu_decode_clip(const char* path, int num_frames, int staging_h,
                       int staging_w, int host_resize_short, int frame_start,
                       int frame_end, const int* bbox, int yuv420,
                       uint8_t* out) {
  // Guard the C ABI: num_frames <= 0 would leave `want` empty and
  // want.back() below is UB (could segfault the embedding process).
  if (num_frames <= 0) return -2;
  cv::VideoCapture cap(path);
  if (!cap.isOpened()) return -1;
  const size_t fbytes = frame_bytes(staging_h, staging_w, yuv420 != 0);
  int total = static_cast<int>(cap.get(cv::CAP_PROP_FRAME_COUNT));

  std::vector<cv::Mat> all;  // fallback: container reports no frame count
  if (total <= 0) {
    cv::Mat f;
    while (cap.read(f)) all.push_back(f.clone());
    if (all.empty()) return -2;
    int first = std::max(frame_start - 1, 0);
    int last = frame_end < 0 ? static_cast<int>(all.size())
                             : std::min<int>(frame_end, all.size());
    if (first >= last) { first = 0; last = static_cast<int>(all.size()); }
    std::vector<int64_t> idx;
    uniform_sample(last - first, num_frames, &idx);
    for (int i = 0; i < num_frames; ++i) {
      stage(all[first + idx[i]], staging_h, staging_w, host_resize_short,
            bbox, yuv420 != 0, out + i * fbytes);
    }
    return 0;
  }

  int first = std::max(frame_start - 1, 0);
  int last = frame_end < 0 ? total : std::min(frame_end, total);
  if (first >= last) { first = 0; last = total; }  // stale segment metadata
  int seg = std::max(last - first, 1);
  std::vector<int64_t> rel;
  uniform_sample(seg, num_frames, &rel);

  int pos = 0;
  if (first > 8) {  // seek-based decode for deep segments (decode.py:74)
    if (cap.set(cv::CAP_PROP_POS_FRAMES, first)) {
      int got = static_cast<int>(cap.get(cv::CAP_PROP_POS_FRAMES));
      if (got >= 0 && got <= first) {
        pos = got;
      } else {
        cap.set(cv::CAP_PROP_POS_FRAMES, 0);
      }
    }
  }

  // want: absolute frame index → list of output slots.
  std::vector<std::pair<int, std::vector<int>>> want;
  for (int i = 0; i < num_frames; ++i) {
    int fi = static_cast<int>(first + rel[i]);
    if (!want.empty() && want.back().first == fi) {
      want.back().second.push_back(i);
    } else {
      want.push_back({fi, {i}});
    }
  }
  int max_needed = want.back().first;
  size_t wi = 0;
  const uint8_t* last_good = nullptr;
  cv::Mat frame;
  while (pos <= max_needed) {
    // Skip want entries the seek jumped past (decode forward only).
    while (wi < want.size() && want[wi].first < pos) ++wi;
    if (wi < want.size() && want[wi].first == pos) {
      if (!cap.read(frame)) break;  // decode + convert
      uint8_t* slot0 = out + want[wi].second[0] * fbytes;
      stage(frame, staging_h, staging_w, host_resize_short, bbox,
            yuv420 != 0, slot0);
      for (size_t k = 1; k < want[wi].second.size(); ++k) {
        std::memcpy(out + want[wi].second[k] * fbytes, slot0, fbytes);
      }
      last_good = slot0;
      ++wi;
    } else {
      if (!cap.grab()) break;  // decode-only, skip conversion
    }
    ++pos;
  }
  if (last_good == nullptr) return -2;
  // Fill frames past a premature EOF with the last good frame.
  for (; wi < want.size(); ++wi) {
    if (want[wi].first >= pos) {
      for (int slot : want[wi].second) {
        std::memcpy(out + slot * fbytes, last_good, fbytes);
      }
    }
  }
  return 0;
}

// Decode a batch on native worker threads (no GIL anywhere — the ctypes
// caller releases it for the whole call). `ok[i]` = 0 on success, else the
// per-clip error code. bbox is [n][4] with INT_MIN sentinel in bbox[i][0]
// meaning "no bbox". Returns the number of successfully decoded clips.
int asltpu_decode_batch(const char** paths, int n, int num_frames,
                        int staging_h, int staging_w, int host_resize_short,
                        const int* frame_start, const int* frame_end,
                        const int* bbox, int yuv420, int n_threads,
                        uint8_t* out, int* ok) {
  const size_t clip_bytes =
      static_cast<size_t>(num_frames) *
      frame_bytes(staging_h, staging_w, yuv420 != 0);
  std::atomic<int> next(0);
  std::atomic<int> n_ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const int* bb = nullptr;
      if (bbox != nullptr && bbox[i * 4] != INT32_MIN) bb = bbox + i * 4;
      int rc = asltpu_decode_clip(
          paths[i], num_frames, staging_h, staging_w, host_resize_short,
          frame_start ? frame_start[i] : 1, frame_end ? frame_end[i] : -1,
          bb, yuv420, out + static_cast<size_t>(i) * clip_bytes);
      ok[i] = rc;
      if (rc == 0) n_ok.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return n_ok.load();
}

int asltpu_native_abi_version() { return 1; }

}  // extern "C"
