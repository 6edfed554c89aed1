// Direct libavformat/libavcodec decode + staging (the host decode's
// native component). The OpenCV-backed decoder (decode.cpp) is byte-identical to
// the Python path but pays for work the pipeline doesn't need:
//
//   - cv2's retrieve() converts every SAMPLED frame YUV420P -> BGR
//     (3 bytes/px), we resize in BGR, then re-encode BGR -> I420 for the
//     yuv420 wire format. The decoder's native output IS YUV420P: staging
//     can resample the Y/U/V planes directly (1.5 bytes/px, no colorspace
//     math at all) via swscale.
//   - cv2 exposes no codec-level knobs. libavcodec gives us
//     skip_loop_filter (h264: ~20-30% less filter work), skip_frame
//     AVDISCARD_NONREF (skips non-reference B-frames entirely when the
//     stream has them), and `lowres` (mpeg4-family: decode at 1/2 or 1/4
//     resolution in the DCT domain - 4x/16x less IDCT+MC work when the
//     staged resolution doesn't need full-res pixels anyway).
//
// Trade recorded up front: this path is NOT byte-identical to the
// cv2/Python oracle (swscale resampling vs cv2 INTER_LINEAR-on-BGR; the
// exactness test is tolerance-based, tests/test_torch_native_decode.py).
// The OpenCV decoder remains the strict-parity default; this one is the
// throughput backend ("av") selected by benchmarks and opt-in serving.
// Fast flags (lowres / loop-filter skip) additionally change pixels
// "approximately" by codec design and are opt-in on top.
//
// Not done, on purpose: cropping the source to the region that survives
// the center crop before swscale. The plane resample is a small share of
// an exact decode (the codec's IDCT+MC dominates), and the crop would add
// sub-pixel phase drift against the cv2 oracle. The no-op direct plane
// crop below (exact-size case) stays because it removes the whole pass.
//
// Exposed as a plain C ABI consumed via ctypes, mirroring decode.cpp's
// entry-point contract.
//
// Build: asltpu_torch/native/__init__.py, at first use (g++ -shared, links
// avformat/avcodec/avutil/swscale from the system SDK).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <atomic>
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

// Fast-mode bit flags (Python side: asltpu_torch/native/__init__.py).
enum : int {
  kFastLowres = 1,        // DCT-domain reduced-resolution decode (mpeg4)
  kFastSkipLoopFilter = 2,  // h264/hevc deblocking off
  kFastSkipNonref = 4,    // drop non-reference frames (B) entirely
};

struct DecoderState {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  int stream_idx = -1;
  int sws_src_w = 0, sws_src_h = 0, sws_dst_w = 0, sws_dst_h = 0;
  AVPixelFormat sws_src_fmt = AV_PIX_FMT_NONE;
  AVPixelFormat sws_dst_fmt = AV_PIX_FMT_NONE;

  ~DecoderState() {
    if (sws) sws_freeContext(sws);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
  }
};

int open_decoder(const char* path, int fast_flags, int lowres_target_short,
                 DecoderState* st) {
  if (avformat_open_input(&st->fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(st->fmt, nullptr) < 0) return -1;
  const AVCodec* codec = nullptr;
  st->stream_idx =
      av_find_best_stream(st->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (st->stream_idx < 0 || codec == nullptr) return -1;
  AVStream* stream = st->fmt->streams[st->stream_idx];
  st->ctx = avcodec_alloc_context3(codec);
  if (!st->ctx) return -1;
  if (avcodec_parameters_to_context(st->ctx, stream->codecpar) < 0) return -1;
  // Single-threaded codec: batch-level threads already saturate this host,
  // and frame-threading adds latency frames.
  st->ctx->thread_count = 1;
  if (fast_flags & kFastSkipLoopFilter) {
    st->ctx->skip_loop_filter = AVDISCARD_ALL;
  }
  if ((fast_flags & kFastLowres) && codec->max_lowres > 0 &&
      lowres_target_short > 0) {
    // Largest lowres level whose decoded short side still covers the
    // resize target (no upscaling of decoded pixels).
    int short_side = std::min(stream->codecpar->width,
                              stream->codecpar->height);
    int level = 0;
    while (level < codec->max_lowres &&
           (short_side >> (level + 1)) >= lowres_target_short) {
      ++level;
    }
    if (level > 0) {
      av_opt_set_int(st->ctx, "lowres", level, 0);
    }
  }
  if (avcodec_open2(st->ctx, codec, nullptr) < 0) return -1;
  st->frame = av_frame_alloc();
  st->pkt = av_packet_alloc();
  return (st->frame && st->pkt) ? 0 : -1;
}

// Pull the next decoded frame in display order. Returns 0 on success,
// AVERROR_EOF at end, <0 on error.
int next_frame(DecoderState* st) {
  for (;;) {
    int rc = avcodec_receive_frame(st->ctx, st->frame);
    if (rc == 0) return 0;
    if (rc == AVERROR_EOF) return rc;
    if (rc != AVERROR(EAGAIN)) return rc;
    // Need more input.
    for (;;) {
      rc = av_read_frame(st->fmt, st->pkt);
      if (rc < 0) {
        // Flush.
        avcodec_send_packet(st->ctx, nullptr);
        break;
      }
      if (st->pkt->stream_index == st->stream_idx) {
        rc = avcodec_send_packet(st->ctx, st->pkt);
        av_packet_unref(st->pkt);
        if (rc == 0 || rc == AVERROR(EAGAIN)) break;
        return rc;
      }
      av_packet_unref(st->pkt);
    }
  }
}

// Display-order frame index of the decoder's current frame, recovered from
// its best-effort timestamp; -1 when the stream gives no usable timing.
int frame_index_from_pts(const DecoderState& st, const AVStream* stream) {
  int64_t pts = st.frame->best_effort_timestamp;
  if (pts == AV_NOPTS_VALUE || stream->avg_frame_rate.num <= 0) return -1;
  return static_cast<int>(av_rescale_q(
      pts - (stream->start_time == AV_NOPTS_VALUE ? 0 : stream->start_time),
      stream->time_base, av_inv_q(stream->avg_frame_rate)));
}

// Stage the current decoded frame into `out`: bbox crop (chroma-aligned),
// swscale resample to the resize plan, center crop, pack.
// dst fmt: YUV420P planes packed I420 (yuv420) or RGB24.
int stage_frame(DecoderState* st, int hs, int ws, int host_resize_short,
                const int* bbox, bool yuv420, int src_coded_w,
                int src_coded_h, uint8_t* out) {
  AVFrame* f = st->frame;
  int fw = f->width, fh = f->height;
  // bbox is in ORIGINAL container coordinates; rescale into decoded
  // (possibly lowres) coordinates.
  const uint8_t* src_data[4];
  int src_lines[4];
  for (int i = 0; i < 4; ++i) {
    src_data[i] = f->data[i];
    src_lines[i] = f->linesize[i];
  }
  int cw = fw, ch = fh;
  if (bbox != nullptr) {
    double sx = static_cast<double>(fw) / src_coded_w;
    double sy = static_cast<double>(fh) / src_coded_h;
    int x0 = std::max(0, static_cast<int>(bbox[0] * sx));
    int y0 = std::max(0, static_cast<int>(bbox[1] * sy));
    int x1 = std::min(fw, static_cast<int>(bbox[2] * sx));
    int y1 = std::min(fh, static_cast<int>(bbox[3] * sy));
    // Chroma-plane alignment: offsets must be even for 4:2:0 data.
    x0 &= ~1;
    y0 &= ~1;
    if (x1 > x0 && y1 > y0) {
      cw = x1 - x0;
      ch = y1 - y0;
      const AVPixFmtDescriptor* desc =
          av_pix_fmt_desc_get(static_cast<AVPixelFormat>(f->format));
      for (int i = 0; i < 4 && src_data[i]; ++i) {
        int shift_x = (i == 1 || i == 2) ? desc->log2_chroma_w : 0;
        int shift_y = (i == 1 || i == 2) ? desc->log2_chroma_h : 0;
        src_data[i] += (y0 >> shift_y) * src_lines[i] + (x0 >> shift_x);
      }
    }
  }
  int short_side = host_resize_short > 0 ? host_resize_short : std::min(hs, ws);
  int rh, rw;
  resize_plan(ch, cw, short_side, &rh, &rw);
  rh = std::max(rh, hs);
  rw = std::max(rw, ws);
  // swscale requires even dims for 4:2:0 output.
  if (yuv420) {
    rh = (rh + 1) & ~1;
    rw = (rw + 1) & ~1;
  }
  AVPixelFormat dst_fmt = yuv420 ? AV_PIX_FMT_YUV420P : AV_PIX_FMT_RGB24;
  AVPixelFormat src_fmt = static_cast<AVPixelFormat>(f->format);
  if (yuv420 && src_fmt == AV_PIX_FMT_YUV420P && rh == ch && rw == cw) {
    // No-op resample: the (bbox-cropped) decoded frame is already exactly
    // the resize-plan size in the output pixel format (the 256²-source
    // headline corpus with host_resize_short=256 lands here for every
    // frame). A same-size same-format sws_scale is a plane copy — skip it
    // and crop the decoder's planes straight into the packed I420 output
    // (byte-identical to the sws pass it replaces; saves one full-frame
    // copy + one crop copy per sampled frame).
    int y0 = ((rh - hs) / 2) & ~1;
    int x0 = ((rw - ws) / 2) & ~1;
    uint8_t* oy = out;
    for (int r = 0; r < hs; ++r) {
      std::memcpy(oy + (size_t)r * ws,
                  src_data[0] + (size_t)(y0 + r) * src_lines[0] + x0, ws);
    }
    uint8_t* ou = out + (size_t)hs * ws;
    for (int r = 0; r < hs / 2; ++r) {
      std::memcpy(ou + (size_t)r * (ws / 2),
                  src_data[1] + (size_t)(y0 / 2 + r) * src_lines[1] + x0 / 2,
                  ws / 2);
    }
    uint8_t* ov = ou + (size_t)(hs / 2) * (ws / 2);
    for (int r = 0; r < hs / 2; ++r) {
      std::memcpy(ov + (size_t)r * (ws / 2),
                  src_data[2] + (size_t)(y0 / 2 + r) * src_lines[2] + x0 / 2,
                  ws / 2);
    }
    return 0;
  }
  if (st->sws == nullptr || st->sws_src_w != cw || st->sws_src_h != ch ||
      st->sws_dst_w != rw || st->sws_dst_h != rh ||
      st->sws_src_fmt != src_fmt || st->sws_dst_fmt != dst_fmt) {
    if (st->sws) sws_freeContext(st->sws);
    st->sws = sws_getContext(cw, ch, src_fmt, rw, rh, dst_fmt,
                             SWS_BILINEAR, nullptr, nullptr, nullptr);
    st->sws_src_w = cw;
    st->sws_src_h = ch;
    st->sws_dst_w = rw;
    st->sws_dst_h = rh;
    st->sws_src_fmt = src_fmt;
    st->sws_dst_fmt = dst_fmt;
    if (!st->sws) return -1;
  }
  // Scale into a temporary full (rh, rw) buffer, then center-crop into out.
  // (One extra copy of the crop region; avoids per-frame alignment math in
  // swscale's stride handling.)
  thread_local std::vector<uint8_t> tmp;
  if (yuv420) {
    size_t need = static_cast<size_t>(rh) * rw * 3 / 2;
    if (tmp.size() < need) tmp.resize(need);
    uint8_t* dst_data[4] = {tmp.data(), tmp.data() + (size_t)rh * rw,
                            tmp.data() + (size_t)rh * rw + (size_t)(rh / 2) * (rw / 2),
                            nullptr};
    int dst_lines[4] = {rw, rw / 2, rw / 2, 0};
    sws_scale(st->sws, src_data, src_lines, 0, ch, dst_data, dst_lines);
    // Center crop, chroma-aligned (even offsets keep U/V siting).
    int y0 = ((rh - hs) / 2) & ~1;
    int x0 = ((rw - ws) / 2) & ~1;
    // Pack I420: Y plane [hs, ws], then U and V as hs/4 full-width rows
    // each (the packed 2D layout the device kernel consumes).
    uint8_t* oy = out;
    for (int r = 0; r < hs; ++r) {
      std::memcpy(oy + (size_t)r * ws, dst_data[0] + (size_t)(y0 + r) * rw + x0,
                  ws);
    }
    uint8_t* ou = out + (size_t)hs * ws;
    for (int r = 0; r < hs / 2; ++r) {
      std::memcpy(ou + (size_t)r * (ws / 2),
                  dst_data[1] + (size_t)(y0 / 2 + r) * (rw / 2) + x0 / 2,
                  ws / 2);
    }
    uint8_t* ov = ou + (size_t)(hs / 2) * (ws / 2);
    for (int r = 0; r < hs / 2; ++r) {
      std::memcpy(ov + (size_t)r * (ws / 2),
                  dst_data[2] + (size_t)(y0 / 2 + r) * (rw / 2) + x0 / 2,
                  ws / 2);
    }
  } else {
    size_t need = static_cast<size_t>(rh) * rw * 3;
    if (tmp.size() < need) tmp.resize(need);
    uint8_t* dst_data[4] = {tmp.data(), nullptr, nullptr, nullptr};
    int dst_lines[4] = {rw * 3, 0, 0, 0};
    sws_scale(st->sws, src_data, src_lines, 0, ch, dst_data, dst_lines);
    int y0 = (rh - hs) / 2;
    int x0 = (rw - ws) / 2;
    for (int r = 0; r < hs; ++r) {
      std::memcpy(out + (size_t)r * ws * 3,
                  tmp.data() + ((size_t)(y0 + r) * rw + x0) * 3,
                  (size_t)ws * 3);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode the uniformly-sampled frames of one video segment. Same contract
// as asltpu_decode_clip (decode.cpp) plus `fast_flags` (kFast* bits).
// Returns 0 ok, -1 open failure, -2 no decodable frames.
int asltpu_av_decode_clip(const char* path, int num_frames, int staging_h,
                          int staging_w, int host_resize_short,
                          int frame_start, int frame_end, const int* bbox,
                          int yuv420, int fast_flags, uint8_t* out) {
  // Guard the C ABI: num_frames <= 0 would leave `want` empty and
  // want.back() below is UB (could segfault the embedding process).
  if (num_frames <= 0) return -2;
  DecoderState st;
  // lowres engages only while the decoded short side still covers the
  // STAGED short side (≥1 decoded pixel per staged pixel): the resize
  // target (host_resize_short) may sit slightly above staging (256 vs 224
  // in the transfer-thin bench config) and would needlessly refuse
  // lowres=1 for 480p sources.
  int short_target = std::min(staging_h, staging_w);
  if (host_resize_short > 0 && host_resize_short < short_target) {
    short_target = host_resize_short;
  }
  if (open_decoder(path, fast_flags, short_target, &st) != 0) return -1;
  AVStream* stream = st.fmt->streams[st.stream_idx];
  int src_w = stream->codecpar->width, src_h = stream->codecpar->height;

  int64_t total = stream->nb_frames;
  if (total <= 0 && stream->duration > 0 &&
      stream->avg_frame_rate.num > 0) {
    total = av_rescale_q(stream->duration, stream->time_base,
                         av_inv_q(stream->avg_frame_rate));
  }
  const size_t fbytes = frame_bytes(staging_h, staging_w, yuv420 != 0);

  if (total <= 0) {
    // Unknown length: count frames in a first decode pass, then reopen and
    // stage (rare containers; memory-bounded unlike store-all).
    int n = 0;
    while (next_frame(&st) == 0) ++n;
    if (n == 0) return -2;
    DecoderState st2;
    if (open_decoder(path, fast_flags, short_target, &st2) != 0) return -1;
    int first = std::max(frame_start - 1, 0);
    int last = frame_end < 0 ? n : std::min(frame_end, n);
    if (first >= last) { first = 0; last = n; }
    std::vector<int64_t> rel;
    uniform_sample(last - first, num_frames, &rel);
    std::vector<std::pair<int, std::vector<int>>> want;
    for (int i = 0; i < num_frames; ++i) {
      int fi = first + static_cast<int>(rel[i]);
      if (!want.empty() && want.back().first == fi) {
        want.back().second.push_back(i);
      } else {
        want.push_back({fi, {i}});
      }
    }
    size_t wi = 0;
    int pos = 0;
    const uint8_t* last_good = nullptr;
    while (wi < want.size() && next_frame(&st2) == 0) {
      if (want[wi].first == pos) {
        uint8_t* slot0 = out + want[wi].second[0] * fbytes;
        if (stage_frame(&st2, staging_h, staging_w, host_resize_short, bbox,
                        yuv420 != 0, src_w, src_h, slot0) != 0) {
          // Mid-stream staging failure: fall through to the trailing
          // backfill (fill remaining slots from last_good), matching the
          // known-length path's `goto backfill` semantics — the clip only
          // fails (-2) when NO frame staged at all.
          break;
        }
        for (size_t k = 1; k < want[wi].second.size(); ++k) {
          std::memcpy(out + want[wi].second[k] * fbytes, slot0, fbytes);
        }
        last_good = slot0;
        ++wi;
      }
      ++pos;
    }
    if (last_good == nullptr) return -2;
    for (; wi < want.size(); ++wi) {
      for (int slot : want[wi].second) {
        std::memcpy(out + slot * fbytes, last_good, fbytes);
      }
    }
    return 0;
  }

  int first = std::max(frame_start - 1, 0);
  int last = frame_end < 0 ? static_cast<int>(total)
                           : std::min<int>(frame_end, total);
  if (first >= last) { first = 0; last = static_cast<int>(total); }
  int seg = std::max(last - first, 1);
  std::vector<int64_t> rel;
  uniform_sample(seg, num_frames, &rel);
  std::vector<std::pair<int, std::vector<int>>> want;
  for (int i = 0; i < num_frames; ++i) {
    int fi = first + static_cast<int>(rel[i]);
    if (!want.empty() && want.back().first == fi) {
      want.back().second.push_back(i);
    } else {
      want.push_back({fi, {i}});
    }
  }

  int pos = 0;
  if (first > 8 && stream->avg_frame_rate.num > 0) {
    // Seek toward the segment (keyframe at or before `first`), mirroring
    // the cv2 path's CAP_PROP_POS_FRAMES seek. Frame index after the seek
    // is recovered from the first decoded frame's timestamp.
    int64_t ts = av_rescale_q(first, av_inv_q(stream->avg_frame_rate),
                              stream->time_base);
    if (av_seek_frame(st.fmt, st.stream_idx, ts, AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(st.ctx);
      if (next_frame(&st) == 0) {
        int got = frame_index_from_pts(st, stream);
        if (got >= 0 && got <= first) {
          pos = got;  // st.frame currently holds frame `got`
        } else {
          // Unreliable seek: rewind to the start. Timestamp seek first
          // (mp4/mov demuxers reject byte seeking); byte seek as the
          // fallback for index-less containers. If NEITHER works the
          // demuxer is still parked at the failed seek target while
          // `pos` would claim 0 — every staged frame would be
          // misnumbered — so fail the clip instead.
          int64_t ts0 = stream->start_time == AV_NOPTS_VALUE
                            ? 0
                            : stream->start_time;
          if (av_seek_frame(st.fmt, st.stream_idx, ts0,
                            AVSEEK_FLAG_BACKWARD) < 0 &&
              av_seek_frame(st.fmt, st.stream_idx, 0,
                            AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE) < 0) {
            return -2;
          }
          avcodec_flush_buffers(st.ctx);
          if (next_frame(&st) != 0) return -2;
          pos = 0;
        }
      } else {
        return -2;
      }
    } else {
      if (next_frame(&st) != 0) return -2;
    }
  } else {
    if (next_frame(&st) != 0) return -2;
  }
  // Invariant: st.frame holds frame `pos`.

  int max_needed = want.back().first;
  size_t wi = 0;
  const uint8_t* last_good = nullptr;
  bool eof = false;
  // When the stream has non-reference frames (B-frames), ask the decoder
  // to drop them outright unless sampled. Conservative: only enable while
  // the NEXT wanted frame is far enough ahead that dropped nonref frames
  // can't be wanted. (mpeg4-SP/OpenCV-written streams have no B-frames;
  // this lever pays off on real WLASL h264 sources.)
  bool skip_nonref = (fast_flags & kFastSkipNonref) != 0;
  // Mid-stream GOP skipping: when the next sampled
  // frame is far ahead (sparse temporal sampling of a long clip), seek to
  // the keyframe at/before it instead of decoding every unsampled GOP.
  // Exactness is preserved: decode restarts from a keyframe and runs
  // forward to the target, the same operation as the initial segment seek.
  // `gop_est` learns the stream's keyframe spacing from each landing so a
  // long-GOP stream (where the backward seek would land far behind and
  // re-decode ground already covered) stops paying for further attempts.
  int gop_est = 0;       // largest observed (target - landed_keyframe) + 1
  bool midseek_ok = true;
  for (;;) {
    // Stage the current frame into every wanted slot at or BEFORE `pos`:
    // under fast-mode frame drops a run of discarded nonref frames can
    // overshoot a wanted index, and the current frame is then the closest
    // decodable one — leaving overshot slots unwritten would return
    // np.empty() garbage as success. In exact mode `want[wi].first < pos`
    // never happens (pos advances one checked frame at a time and the
    // seek lands at or before `first`), so `<=` is the == of before.
    while (wi < want.size() && want[wi].first <= pos) {
      uint8_t* slot0 = out + want[wi].second[0] * fbytes;
      if (stage_frame(&st, staging_h, staging_w, host_resize_short, bbox,
                      yuv420 != 0, src_w, src_h, slot0) != 0) {
        goto backfill;
      }
      for (size_t k = 1; k < want[wi].second.size(); ++k) {
        std::memcpy(out + want[wi].second[k] * fbytes, slot0, fbytes);
      }
      last_good = slot0;
      ++wi;
    }
    if (wi >= want.size() || pos >= max_needed) break;
    {
      const int target = want[wi].first;
      // Threshold 24: below a GOP-ish gap the flush + keyframe re-decode
      // costs more than linear grab-skip; above `gop_est` only (a seek
      // that would land behind a previously observed keyframe distance
      // re-decodes covered ground).
      if (midseek_ok && target - pos > 24 && target - pos > gop_est &&
          stream->avg_frame_rate.num > 0) {
        int64_t ts = av_rescale_q(target, av_inv_q(stream->avg_frame_rate),
                                  stream->time_base);
        if (av_seek_frame(st.fmt, st.stream_idx, ts,
                          AVSEEK_FLAG_BACKWARD) >= 0) {
          avcodec_flush_buffers(st.ctx);
          if (next_frame(&st) == 0) {
            int got = frame_index_from_pts(st, stream);
            if (got >= 0 && got <= target) {
              gop_est = std::max(gop_est, target - got + 1);
              pos = got;
              continue;  // staging loop re-checks against the new pos
            }
          }
          // Post-seek position unknown (no timestamps / landed past the
          // target): every further staged frame would be misnumbered.
          // Rewind to the start — exactness over speed — and disable
          // further mid-stream seeks for this clip.
          midseek_ok = false;
          int64_t ts0 = stream->start_time == AV_NOPTS_VALUE
                            ? 0
                            : stream->start_time;
          if (av_seek_frame(st.fmt, st.stream_idx, ts0,
                            AVSEEK_FLAG_BACKWARD) < 0 &&
              av_seek_frame(st.fmt, st.stream_idx, 0,
                            AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE) < 0) {
            return -2;
          }
          avcodec_flush_buffers(st.ctx);
          if (next_frame(&st) != 0) return -2;
          pos = 0;
          continue;
        }
        midseek_ok = false;  // demuxer refused the seek; stay linear
      }
    }
    if (skip_nonref) {
      // Only safe to discard nonref frames while none of them can be the
      // next wanted frame — h264 reorders, so require a gap of >2.
      st.ctx->skip_frame = (want[wi].first - pos > 2) ? AVDISCARD_NONREF
                                                      : AVDISCARD_DEFAULT;
    }
    int rc = next_frame(&st);
    if (rc != 0) { eof = true; break; }
    ++pos;
    if (skip_nonref && st.ctx->skip_frame != AVDISCARD_DEFAULT) {
      // Dropped frames never surface from receive_frame; advance `pos` by
      // timestamp instead of assuming +1. A stream that gives us no usable
      // timestamps while frames are being dropped would silently desync
      // `pos` (later frames staged under earlier indices) — stop skipping
      // for the rest of this clip instead; the drift already incurred is
      // bounded by one skip window.
      int64_t pts = st.frame->best_effort_timestamp;
      if (pts != AV_NOPTS_VALUE && stream->avg_frame_rate.num > 0) {
        int got = static_cast<int>(av_rescale_q(
            pts - (stream->start_time == AV_NOPTS_VALUE ? 0
                                                        : stream->start_time),
            stream->time_base, av_inv_q(stream->avg_frame_rate)));
        if (got > pos) pos = got;
      } else {
        skip_nonref = false;
        st.ctx->skip_frame = AVDISCARD_DEFAULT;
      }
    }
  }
backfill:
  (void)eof;
  if (last_good == nullptr) return -2;
  for (; wi < want.size(); ++wi) {
    for (int slot : want[wi].second) {
      std::memcpy(out + slot * fbytes, last_good, fbytes);
    }
  }
  return 0;
}

// Batch decode on native worker threads, GIL released by the ctypes
// caller. Mirrors asltpu_decode_batch (decode.cpp) plus fast_flags.
int asltpu_av_decode_batch(const char** paths, int n, int num_frames,
                           int staging_h, int staging_w,
                           int host_resize_short, const int* frame_start,
                           const int* frame_end, const int* bbox, int yuv420,
                           int fast_flags, int n_threads, uint8_t* out,
                           int* ok) {
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
      int rc = asltpu_av_decode_clip(
          paths[i], num_frames, staging_h, staging_w, host_resize_short,
          frame_start ? frame_start[i] : 1, frame_end ? frame_end[i] : -1,
          bb, yuv420, fast_flags,
          out + static_cast<size_t>(i) * clip_bytes);
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

// Test-fixture encoder: a deterministic smooth-gradient mpeg4 clip with a
// CONTROLLABLE B-frame structure. OpenCV's mp4v VideoWriter cannot emit
// B-frames (OPENCV_FFMPEG_WRITER_OPTIONS is ignored), so
// without this the entire FAST_SKIP_NONREF / frame-reorder machinery above
// would have no reachable fixture. Content mirrors synthetic.write_video's
// moving gradient (codec-friendly, parity-tolerant). Returns the number of
// reordered packets (pts != dts — nonzero iff B-frames were actually
// encoded), or <0 on error.
int asltpu_av_encode_synthetic(const char* path, int num_frames, int h,
                               int w, int max_b_frames, int gop_size,
                               int seed) {
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!codec) return -1;
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 ||
      !fmt) {
    return -1;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  int reordered = -1;
  AVStream* stream = nullptr;
  do {
    if (!ctx || !frame || !pkt) break;
    ctx->width = w;
    ctx->height = h;
    ctx->pix_fmt = AV_PIX_FMT_YUV420P;
    ctx->time_base = {1, 25};
    ctx->gop_size = gop_size;
    ctx->max_b_frames = max_b_frames;
    ctx->bit_rate = static_cast<int64_t>(h) * w * 25 / 4;
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER) {
      ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    }
    if (avcodec_open2(ctx, codec, nullptr) < 0) break;
    stream = avformat_new_stream(fmt, codec);
    if (!stream) break;
    stream->time_base = ctx->time_base;
    if (avcodec_parameters_from_context(stream->codecpar, ctx) < 0) break;
    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
      break;
    }
    if (avformat_write_header(fmt, nullptr) < 0) break;
    frame->format = AV_PIX_FMT_YUV420P;
    frame->width = w;
    frame->height = h;
    if (av_frame_get_buffer(frame, 0) < 0) break;
    reordered = 0;
    double ph = 0.37 * seed;
    auto drain = [&](bool flush) -> bool {
      if (avcodec_send_frame(ctx, flush ? nullptr : frame) < 0) return false;
      for (;;) {
        int rc = avcodec_receive_packet(ctx, pkt);
        if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return true;
        if (rc < 0) return false;
        if (pkt->pts != AV_NOPTS_VALUE && pkt->dts != AV_NOPTS_VALUE &&
            pkt->pts != pkt->dts) {
          ++reordered;
        }
        av_packet_rescale_ts(pkt, ctx->time_base, stream->time_base);
        pkt->stream_index = stream->index;
        if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
      }
    };
    bool ok = true;
    for (int t = 0; t < num_frames && ok; ++t) {
      if (av_frame_make_writable(frame) < 0) { ok = false; break; }
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          double v = 127.5 + 110.0 * std::sin(0.05 * (x + y) + ph + 0.3 * t);
          frame->data[0][y * frame->linesize[0] + x] =
              static_cast<uint8_t>(std::min(255.0, std::max(0.0, v)));
        }
      }
      for (int y = 0; y < h / 2; ++y) {
        for (int x = 0; x < w / 2; ++x) {
          double u = 128.0 + 40.0 * std::sin(0.03 * (x - y) + ph + 0.2 * t);
          double v = 128.0 + 40.0 * std::sin(0.04 * (x + 2 * y) - ph + 0.15 * t);
          frame->data[1][y * frame->linesize[1] + x] =
              static_cast<uint8_t>(std::min(255.0, std::max(0.0, u)));
          frame->data[2][y * frame->linesize[2] + x] =
              static_cast<uint8_t>(std::min(255.0, std::max(0.0, v)));
        }
      }
      frame->pts = t;
      ok = drain(false);
    }
    if (ok) ok = drain(true);
    if (ok && av_write_trailer(fmt) < 0) ok = false;
    if (!ok) reordered = -1;
  } while (false);
  if (pkt) av_packet_free(&pkt);
  if (frame) av_frame_free(&frame);
  if (ctx) avcodec_free_context(&ctx);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb) {
      avio_closep(&fmt->pb);
    }
    avformat_free_context(fmt);
  }
  return reordered;
}

int asltpu_av_abi_version() { return 1; }

}  // extern "C"
