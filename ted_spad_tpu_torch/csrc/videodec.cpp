// videodec -- host-side C++ video decode and encode layer of ted_spad_tpu_torch.
//
// A copy of the JAX package's native/videodec/videodec.cpp (which stays as it is) with
// one repair: swscale writes every decoded frame it converts into a buffer of the
// decoder's own whose line size is a multiple of 64 bytes, and the rows are then
// copied into the caller's packed rows. swscale's vector code stores whole vectors
// per line and assumes an aligned line size; handed the caller's packed rows (a line
// size of out_w * 3, or W and W / 2 for planes) at a width that 16 does not divide,
// it wrote the columns past the last multiple of 16 wrongly and unstably, and at
// some widths past the end of the buffer. Build: data/video_reader.py compiles this
// file with g++ at first use.
//
// The layer stands in for the reference's three decode dependencies:
//   - NVIDIA DALI fn.readers.video (feature_extraction/dali_extraction.py:53-81): strided
//     clip windowing over whole videos -> vd_read_strided / Python-side windowing;
//   - decord VideoReader.get_batch (aux_code/ucf101_dl.py:12-19): random-access frame
//     gather -> vd_read_indices;
//   - OpenCV sequential VideoCapture (feature_extraction/shanghai_dl.py:45-83) ->
//     vd_read_strided from frame 0.
//
// Decodes on the host CPU via libavcodec, converts to packed RGB24 with swscale (optional
// resize), and writes into caller-provided buffers so Python/numpy owns all memory. All
// functions release the GIL implicitly (pure C, called through ctypes). One decoder object
// per thread; a Python thread pool provides multi-video parallelism.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;          // lazy: keyed on the decoded frame's fmt/dims/colorimetry
  int sws_fmt = AV_PIX_FMT_NONE;
  int sws_w = 0, sws_h = 0;
  int sws_csp = AVCOL_SPC_UNSPECIFIED;    // colorspace the RGB context was built for
  int sws_range = AVCOL_RANGE_UNSPECIFIED;
  SwsContext* sws_yuv = nullptr;  // lazy: non-yuv420p sources -> planar yuv420p
  int sws_yuv_fmt = AV_PIX_FMT_NONE;  // pixel format the lazy context was built for
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  // swscale's destination: aligned planes of `stage_ls` line sizes (to_rgb: plane 0
  // only, out_h rows; to_yuv420: three planes), allocated on first use.
  uint8_t* stage[3] = {nullptr, nullptr, nullptr};
  int stage_ls[3] = {0, 0, 0};
  int stage_rows[3] = {0, 0, 0};
  int stream_idx = -1;
  int out_w = 0, out_h = 0;
  int64_t next_frame = 0;   // index of the next frame the decoder will emit
  int64_t num_frames = -1;  // estimated total frames
  double fps = 0.0;
  bool at_eof = false;  // codec drained: only a flush+seek can produce frames again
  std::string error;

  ~Decoder() {
    for (uint8_t*& p : stage) av_freep(&p);
    if (sws_yuv) sws_freeContext(sws_yuv);
    if (sws) sws_freeContext(sws);
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }
};

thread_local std::string g_last_error;

std::string av_err_str(int64_t err) {
  char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
  av_strerror(static_cast<int>(err), buf, sizeof(buf));
  return buf;
}

constexpr int kLineAlign = 64;  // swscale's line sizes: a multiple of its widest vector

int aligned_line(int bytes) { return (bytes + kLineAlign - 1) / kLineAlign * kLineAlign; }

// Make dec->stage[p] hold `rows` lines of at least `bytes` bytes each, at an aligned
// line size (reallocated only when the geometry changes). Returns 0, or -1 when the
// allocation fails.
int ensure_stage(Decoder* dec, int p, int bytes, int rows) {
  const int ls = aligned_line(bytes);
  if (dec->stage[p] && dec->stage_ls[p] == ls && dec->stage_rows[p] == rows) return 0;
  av_freep(&dec->stage[p]);
  // One spare line: swscale may read or write a vector past the last line's end.
  dec->stage[p] = static_cast<uint8_t*>(av_malloc(static_cast<size_t>(ls) * (rows + 1)));
  dec->stage_ls[p] = dec->stage[p] ? ls : 0;
  dec->stage_rows[p] = dec->stage[p] ? rows : 0;
  return dec->stage[p] ? 0 : -1;
}

// Copy `rows` lines of `bytes` bytes from a buffer of line size `src_ls` to packed rows.
void copy_rows(uint8_t* dst, const uint8_t* src, int src_ls, int bytes, int rows) {
  for (int r = 0; r < rows; ++r)
    memcpy(dst + static_cast<int64_t>(r) * bytes, src + static_cast<int64_t>(r) * src_ls, bytes);
}

int64_t estimate_num_frames(const AVFormatContext* fmt, const AVStream* st, double fps) {
  if (st->nb_frames > 0) return st->nb_frames;
  if (st->duration > 0 && st->time_base.den > 0) {
    const double secs = st->duration * av_q2d(st->time_base);
    return static_cast<int64_t>(secs * fps + 0.5);
  }
  if (fmt->duration > 0) {
    const double secs = static_cast<double>(fmt->duration) / AV_TIME_BASE;
    return static_cast<int64_t>(secs * fps + 0.5);
  }
  return -1;
}

// Decode the next frame into dec->frame. Returns 1 on success, 0 on EOF, <0 on error.
int decode_next(Decoder* dec) {
  while (true) {
    int ret = avcodec_receive_frame(dec->codec, dec->frame);
    if (ret == 0) {
      dec->next_frame++;
      return 1;
    }
    if (ret == AVERROR_EOF) {
      // Drained: the codec stays in EOF state until avcodec_flush_buffers — callers
      // must seek (gather_indices checks at_eof) rather than keep polling.
      dec->at_eof = true;
      return 0;
    }
    if (ret != AVERROR(EAGAIN)) return ret;
    // Feed more packets.
    while (true) {
      ret = av_read_frame(dec->fmt, dec->pkt);
      if (ret == AVERROR_EOF) {
        avcodec_send_packet(dec->codec, nullptr);  // flush
        break;
      }
      if (ret < 0) return ret;
      if (dec->pkt->stream_index == dec->stream_idx) {
        ret = avcodec_send_packet(dec->codec, dec->pkt);
        av_packet_unref(dec->pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
        break;
      }
      av_packet_unref(dec->pkt);
    }
  }
}

// Override a YUV<->RGB context's coefficient tables from colorimetry tags: family
// 709 selects the BT.709 matrix (601 is swscale's default assumption). Both table
// sides get the coefficients (swscale uses whichever side is the YUV endpoint);
// src_range/dst_range override the range flags when >= 0, -1 keeps what the
// context already derived (e.g. yuvj auto-detection). Brightness state preserved.
// A failure (conversion isn't table-driven) leaves the default behavior.
void apply_sws_colorspace(SwsContext* ctx, int family, int src_range_ovr,
                          int dst_range_ovr) {
  int *inv_table = nullptr, *table = nullptr;
  int src_range = 0, dst_range = 0, brightness = 0, contrast = 0, saturation = 0;
  if (sws_getColorspaceDetails(ctx, &inv_table, &src_range, &table, &dst_range,
                               &brightness, &contrast, &saturation) < 0)
    return;
  const int* coeffs =
      sws_getCoefficients(family == 709 ? SWS_CS_ITU709 : SWS_CS_ITU601);
  sws_setColorspaceDetails(ctx, coeffs, src_range_ovr >= 0 ? src_range_ovr : src_range,
                           coeffs, dst_range_ovr >= 0 ? dst_range_ovr : dst_range,
                           brightness, contrast, saturation);
}

// Collapse a frame's colorspace tag to the matrix family swscale must use for RGB
// conversion: 709 for BT.709, 601 for everything else (BT.601 variants, untagged —
// swscale's own default assumption — and exotic tags we don't special-case).
int frame_matrix_family(const AVFrame* f) {
  return f->colorspace == AVCOL_SPC_BT709 ? 709 : 601;
}

int frame_full_range(const AVFrame* f) {
  return (f->color_range == AVCOL_RANGE_JPEG || f->format == AV_PIX_FMT_YUVJ420P ||
          f->format == AV_PIX_FMT_YUVJ422P || f->format == AV_PIX_FMT_YUVJ444P)
             ? 1
             : 0;
}

// Convert dec->frame to RGB24 into out (out_h*out_w*3 bytes), through dec->stage[0]
// at an aligned line size (the file's header says why). The swscale context is
// keyed on the DECODED frame's pixel format, dimensions AND colorimetry tags (not
// codecpar's open-time values) so a mid-stream change rebuilds it instead of silently
// interpreting planes with a stale layout — same rule as the YUV path's lazy context.
// BT.709-tagged frames convert with the BT.709 matrix; everything else keeps
// swscale's BT.601 default (matching the device YUV ingest, ops/yuv.py).
int to_rgb(Decoder* dec, uint8_t* out) {
  AVFrame* f = dec->frame;
  if (!dec->sws || dec->sws_fmt != f->format || dec->sws_w != f->width ||
      dec->sws_h != f->height || dec->sws_csp != f->colorspace ||
      dec->sws_range != f->color_range) {
    if (dec->sws) sws_freeContext(dec->sws);
    dec->sws = sws_getContext(f->width, f->height, static_cast<AVPixelFormat>(f->format),
                              dec->out_w, dec->out_h, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                              nullptr, nullptr, nullptr);
    dec->sws_fmt = f->format;
    dec->sws_w = f->width;
    dec->sws_h = f->height;
    dec->sws_csp = f->colorspace;
    dec->sws_range = f->color_range;
    if (!dec->sws) return -1;
    // Honor a full-range tag on non-yuvj formats (-1 keeps yuvj auto-detection).
    apply_sws_colorspace(dec->sws, frame_matrix_family(f),
                         frame_full_range(f) ? 1 : -1, -1);
  }
  const int row_bytes = dec->out_w * 3;
  if (ensure_stage(dec, 0, row_bytes, dec->out_h) < 0) return -1;
  uint8_t* dst[4] = {dec->stage[0], nullptr, nullptr, nullptr};
  int dst_linesize[4] = {dec->stage_ls[0], 0, 0, 0};
  int rows = sws_scale(dec->sws, f->data, f->linesize, 0, f->height, dst, dst_linesize);
  if (rows != dec->out_h) return -1;
  copy_rows(out, dec->stage[0], dec->stage_ls[0], row_bytes, rows);
  return 0;
}

// Copy dec->frame as planar yuv420p at NATIVE resolution into caller buffers
// (y: H*W, u/v: (H/2)*(W/2)). Zero-copy row memcpy for yuv420p sources (the normal
// h264/mpeg4 case — skips the swscale->RGB pass entirely, the "planar decode"
// ingest mode); anything else converts via a lazy swscale context into dec->stage at
// aligned line sizes, whose rows are then copied out.
int to_yuv420(Decoder* dec, uint8_t* y, uint8_t* u, uint8_t* v) {
  AVFrame* f = dec->frame;
  const int W = dec->codec->width, H = dec->codec->height;
  const int cw = W / 2, ch = H / 2;
  // Caller buffers are sized from the open-time native dims; a mid-stream
  // resolution change would overflow them — fail the read instead.
  if (f->width != W || f->height != H) return -1;
  if (f->format == AV_PIX_FMT_YUV420P || f->format == AV_PIX_FMT_YUVJ420P) {
    for (int r = 0; r < H; ++r) memcpy(y + static_cast<int64_t>(r) * W, f->data[0] + static_cast<int64_t>(r) * f->linesize[0], W);
    for (int r = 0; r < ch; ++r) memcpy(u + static_cast<int64_t>(r) * cw, f->data[1] + static_cast<int64_t>(r) * f->linesize[1], cw);
    for (int r = 0; r < ch; ++r) memcpy(v + static_cast<int64_t>(r) * cw, f->data[2] + static_cast<int64_t>(r) * f->linesize[2], cw);
    return 0;
  }
  // Key the lazy context on the frame's pixel format so a mid-stream format
  // change rebuilds it instead of silently reusing a stale conversion.
  if (!dec->sws_yuv || dec->sws_yuv_fmt != f->format) {
    if (dec->sws_yuv) sws_freeContext(dec->sws_yuv);
    dec->sws_yuv = sws_getContext(W, H, static_cast<AVPixelFormat>(f->format), W, H,
                                  AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr, nullptr);
    dec->sws_yuv_fmt = f->format;
    if (!dec->sws_yuv) return -1;
    // This conversion must be RANGE-PRESERVING: the caller's tag (vd_full_range)
    // tells the device which transfer to apply, so the planes must keep the
    // source's range. swscale's J-format handling would otherwise COMPRESS
    // yuvj422p/yuvj444p (e.g. MJPEG) to limited while the tag still says full.
    // Force dstRange = the derived srcRange so no range conversion happens.
    int *inv_table = nullptr, *table = nullptr;
    int src_range = 0, dst_range = 0, brightness = 0, contrast = 0, saturation = 0;
    if (sws_getColorspaceDetails(dec->sws_yuv, &inv_table, &src_range, &table,
                                 &dst_range, &brightness, &contrast, &saturation) >= 0) {
      sws_setColorspaceDetails(dec->sws_yuv, inv_table, src_range, table, src_range,
                               brightness, contrast, saturation);
    }
  }
  if (ensure_stage(dec, 0, W, H) < 0 || ensure_stage(dec, 1, cw, ch) < 0 ||
      ensure_stage(dec, 2, cw, ch) < 0)
    return -1;
  uint8_t* dst[4] = {dec->stage[0], dec->stage[1], dec->stage[2], nullptr};
  int ls[4] = {dec->stage_ls[0], dec->stage_ls[1], dec->stage_ls[2], 0};
  int rows = sws_scale(dec->sws_yuv, f->data, f->linesize, 0, H, dst, ls);
  if (rows != H) return -1;
  copy_rows(y, dec->stage[0], ls[0], W, H);
  copy_rows(u, dec->stage[1], ls[1], cw, ch);
  copy_rows(v, dec->stage[2], ls[2], cw, ch);
  return 0;
}

// Seek so that the decoder's next emitted frame index is <= target. Conservative:
// seek to the keyframe at/before the target timestamp, reset counters by decoding
// with frame-accurate skip.
// Restart demuxing from the beginning with an exact frame counter — the frame-accurate
// fallback when pts-based index recovery is unavailable or overshoots.
int rewind_to_start(Decoder* dec) {
  int ret = av_seek_frame(dec->fmt, dec->stream_idx, 0, AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE);
  if (ret < 0) ret = av_seek_frame(dec->fmt, dec->stream_idx, 0, AVSEEK_FLAG_BACKWARD);
  if (ret < 0) return ret;
  avcodec_flush_buffers(dec->codec);
  dec->at_eof = false;
  dec->next_frame = 0;
  ret = decode_next(dec);  // frame 0
  return ret <= 0 ? (ret < 0 ? ret : AVERROR_EOF) : 1;
}

int seek_to(Decoder* dec, int64_t target) {
  AVStream* st = dec->fmt->streams[dec->stream_idx];
  const double tb = av_q2d(st->time_base);
  if (tb <= 0 || dec->fps <= 0) return rewind_to_start(dec);
  // Streams rarely start at pts 0 (B-frame reorder delay, MPEG-TS captures at ~1.4e9
  // ticks): both the seek timestamp and the pts->index recovery must be relative to
  // start_time, or every seeked read is shifted / degrades to the O(T) rewind.
  const int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  // After a keyframe seek we do not know the exact frame index; recover it from the
  // first decoded frame's pts. If the recovered index already passed the target
  // (VFR / imprecise avg fps), retry with progressively earlier timestamps (1s, 4s,
  // 16s back) before the exact-but-O(T) rewind fallback — on long surveillance files
  // a backward-ish access pattern would otherwise degrade to a full linear decode
  // per index.
  double back_s = 0.0;
  int64_t prev_idx = INT64_MAX;  // recovered indices must strictly decrease across
                                 // retries, else the pts->index model is unreliable
                                 // (constant/garbage pts) and only the exact rewind
                                 // never mislabels frames.
  for (int attempt = 0; attempt < 4; ++attempt) {
    const double t_s = target / dec->fps - back_s;
    if (t_s < 0) break;
    const int64_t ts = start + static_cast<int64_t>(t_s / tb);
    int ret = av_seek_frame(dec->fmt, dec->stream_idx, ts, AVSEEK_FLAG_BACKWARD);
    if (ret < 0) return rewind_to_start(dec);
    avcodec_flush_buffers(dec->codec);
    dec->at_eof = false;
    ret = decode_next(dec);
    if (ret <= 0) return ret < 0 ? ret : AVERROR_EOF;
    const int64_t pts = dec->frame->best_effort_timestamp;
    if (pts == AV_NOPTS_VALUE) return rewind_to_start(dec);
    const int64_t idx =
        static_cast<int64_t>((pts - start) * tb * dec->fps + 0.5);
    if (idx <= target) {
      dec->next_frame = idx + 1;
      return 1;
    }
    if (idx >= prev_idx) return rewind_to_start(dec);
    prev_idx = idx;
    back_s = back_s == 0.0 ? 1.0 : back_s * 4.0;
  }
  return rewind_to_start(dec);
}

// Walk sorted `indices`, invoking sink(slot) with dec->frame holding each target.
// decord get_batch semantics: skips forward within one decode pass, seeks when the gap
// is large or backwards. The sink returns 0 on success, <0 on conversion failure —
// a failed conversion aborts the walk immediately (its slot is NOT counted; decoding
// the remaining frames would be wasted work). Returns frames delivered (< n at benign
// EOF or on conversion failure) or a NEGATIVE AVERROR on a demux/decode failure —
// callers must surface that as an error, never as a short read to pad (padding over
// corrupt data would save frozen-frame features with no warning).
template <typename Sink>
int64_t gather_indices(Decoder* dec, const int64_t* indices, int64_t n, Sink&& sink) {
  int64_t written = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t target = indices[i];
    // at_eof: a drained codec can never emit frames by decoding forward — only
    // flush+seek recovers. Without this, a prior read that ran past the real end
    // (estimated frame counts routinely overshoot) would leave every later target
    // inside the old forward window unreadable, silently zero-padded by the caller.
    if (dec->at_eof || target < dec->next_frame - 1 || target > dec->next_frame + 256) {
      const int s = seek_to(dec, target);
      if (s < 0 && s != AVERROR_EOF) return s;
      if (s <= 0) break;
    }
    // dec->frame currently holds frame (next_frame - 1) after seek; otherwise decode on.
    bool have = dec->next_frame - 1 >= 0 &&
                dec->next_frame - 1 == target &&
                dec->frame->data[0] != nullptr;
    int ret = 1;
    while (!have) {
      ret = decode_next(dec);
      if (ret <= 0) break;
      have = dec->next_frame - 1 == target;
    }
    if (ret < 0) return ret;  // hard demux/decode error: distinct from benign EOF
    if (ret == 0 && !have) break;
    if (sink(written) < 0) break;
    written++;
  }
  return written;
}

}  // namespace

extern "C" {

const char* vd_last_error() { return g_last_error.c_str(); }

// Open a video; out_w/out_h == 0 keeps native resolution.
// threads: decoder thread_count (0 = libavcodec auto). The extraction pool gets its
// parallelism from one decoder per worker thread, so threads=1 avoids per-decoder
// frame-thread oversubscription on many-core hosts; auto is kept as the vd_open
// default for single-video consumers (visualization, ad-hoc reads).
// fast != 0: skip the h264/hevc in-loop deblocking filter and enable non-bitexact
// codec speedups (AV_CODEC_FLAG2_FAST). NOT bit-exact with reference decode —
// opt-in for throughput-bound feature extraction where frames are resized to 224²
// downstream (dali_extraction.py:38-50) and deblocking artifacts are sub-pixel noise.
void* vd_open_opts(const char* path, int out_w, int out_h, int threads, int fast) {
  auto dec = new Decoder();
  int ret = avformat_open_input(&dec->fmt, path, nullptr, nullptr);
  if (ret < 0) {
    g_last_error = "avformat_open_input failed";
    delete dec;
    return nullptr;
  }
  if (avformat_find_stream_info(dec->fmt, nullptr) < 0) {
    g_last_error = "no stream info";
    delete dec;
    return nullptr;
  }
  dec->stream_idx =
      av_find_best_stream(dec->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (dec->stream_idx < 0) {
    g_last_error = "no video stream";
    delete dec;
    return nullptr;
  }
  AVStream* st = dec->fmt->streams[dec->stream_idx];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) {
    g_last_error = "unsupported codec";
    delete dec;
    return nullptr;
  }
  dec->codec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec->codec, st->codecpar);
  dec->codec->thread_count = threads;  // 0 = auto
  if (fast) {
    dec->codec->skip_loop_filter = AVDISCARD_ALL;
    dec->codec->flags2 |= AV_CODEC_FLAG2_FAST;
  }
  if (avcodec_open2(dec->codec, codec, nullptr) < 0) {
    g_last_error = "avcodec_open2 failed";
    delete dec;
    return nullptr;
  }
  AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
  dec->fps = fr.den ? av_q2d(fr) : 25.0;
  dec->num_frames = estimate_num_frames(dec->fmt, st, dec->fps);
  dec->out_w = out_w > 0 ? out_w : dec->codec->width;
  dec->out_h = out_h > 0 ? out_h : dec->codec->height;
  // The RGB swscale context is built lazily in to_rgb from the first decoded frame's
  // actual format/dims (codecpar can disagree with the bitstream).
  dec->frame = av_frame_alloc();
  dec->pkt = av_packet_alloc();
  if (!dec->frame || !dec->pkt) {
    g_last_error = "allocation failure";
    delete dec;
    return nullptr;
  }
  return dec;
}

void* vd_open(const char* path, int out_w, int out_h) {
  return vd_open_opts(path, out_w, out_h, /*threads=*/0, /*fast=*/0);
}

void vd_close(void* h) { delete static_cast<Decoder*>(h); }

int64_t vd_num_frames(void* h) { return static_cast<Decoder*>(h)->num_frames; }
double vd_fps(void* h) { return static_cast<Decoder*>(h)->fps; }
int vd_width(void* h) { return static_cast<Decoder*>(h)->out_w; }
int vd_height(void* h) { return static_cast<Decoder*>(h)->out_h; }

// Gather frames at sorted `indices` (n of them) into out (n, out_h, out_w, 3) uint8.
// Returns frames written (< n at benign EOF — the caller pads), or -1 if an RGB
// conversion OR a demux/decode failed mid-read: a short count would be
// indistinguishable from benign EOF and the caller would silently pad frozen
// frames over corrupt data (same contract as the YUV reader).
int64_t vd_read_indices(void* h, const int64_t* indices, int64_t n, uint8_t* out) {
  auto dec = static_cast<Decoder*>(h);
  const int64_t frame_bytes = static_cast<int64_t>(dec->out_w) * dec->out_h * 3;
  bool failed = false;
  int64_t written = gather_indices(dec, indices, n, [&](int64_t slot) {
    int r = to_rgb(dec, out + slot * frame_bytes);
    if (r < 0) failed = true;
    return r;
  });
  if (failed) {
    g_last_error = "rgb conversion failed (sws_scale short output)";
    return -1;
  }
  if (written < 0) {
    g_last_error = std::string("demux/decode error: ") + av_err_str(written);
    return -1;
  }
  return written;
}

// Sequential strided read: frames start, start+stride, ... (n frames) into out.
// Covers the DALI sequence reader and the cv2 whole-video loop.
int64_t vd_read_strided(void* h, int64_t start, int64_t n, int64_t stride, uint8_t* out) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = start + i * stride;
  return vd_read_indices(h, idx.data(), n, out);
}

// Native resolution of the coded stream (YUV reads ignore the out_w/out_h scaler).
int vd_native_width(void* h) { return static_cast<Decoder*>(h)->codec->width; }
int vd_native_height(void* h) { return static_cast<Decoder*>(h)->codec->height; }

// Colorspace tag of the coded stream, collapsed to the matrix family the device
// conversion must use: 601 (BT.601/SMPTE170M/470BG), 709 (BT.709), 0 for untagged
// (swscale's default assumption is 601), -1 for anything else (BT.2020 etc.).
// Both RGB decode (to_rgb, per-frame tag) and the device YUV ingest (ops/yuv.py,
// per-clip flag from this function) honor 601/709; callers reject only -1.
int vd_colorspace(void* h) {
  switch (static_cast<Decoder*>(h)->codec->colorspace) {
    case AVCOL_SPC_BT470BG:
    case AVCOL_SPC_SMPTE170M:
      return 601;
    case AVCOL_SPC_BT709:
      return 709;
    case AVCOL_SPC_UNSPECIFIED:
      return 0;
    default:
      return -1;
  }
}

// 1 if the stream is full-range (yuvj/pc range), else 0 (limited/studio range —
// the untagged default swscale also assumes for BT.601 conversion).
int vd_full_range(void* h) {
  auto dec = static_cast<Decoder*>(h);
  // All three YUVJ formats imply full range even with color_range unset — same
  // rule as the per-frame frame_full_range; checking only 420P would tag a
  // yuvj422p/444p MJPEG stream limited while to_yuv420's range-preserving
  // conversion ships full-range planes (lifted blacks on device).
  return (dec->codec->color_range == AVCOL_RANGE_JPEG ||
          dec->codec->pix_fmt == AV_PIX_FMT_YUVJ420P ||
          dec->codec->pix_fmt == AV_PIX_FMT_YUVJ422P ||
          dec->codec->pix_fmt == AV_PIX_FMT_YUVJ444P)
             ? 1
             : 0;
}

// Planar gather: frames at sorted indices into y (n,H,W), u/v (n,H/2,W/2) uint8 at
// NATIVE resolution — the planar ingest mode: 1.5 bytes/px host->device instead of 3,
// chroma upsampling + BT.601 color conversion fused into the device preprocess
// (ops/yuv.py). DALI's GPU-side decode equivalent (dali_extraction.py:53-81).
// Returns frames written, or -1 for odd native dimensions (the (W/2,H/2) plane
// layout would disagree with the caller's buffers) / a failed pixel-format
// conversion (counting such frames as delivered would leak uninitialized memory).
int64_t vd_read_indices_yuv(void* h, const int64_t* indices, int64_t n, uint8_t* out_y,
                            uint8_t* out_u, uint8_t* out_v) {
  auto dec = static_cast<Decoder*>(h);
  const int W = dec->codec->width, H = dec->codec->height;
  if ((W | H) & 1) {
    g_last_error = "yuv read requires even native dimensions";
    return -1;
  }
  const int64_t yb = static_cast<int64_t>(W) * H;
  const int64_t cb = yb / 4;
  bool failed = false;
  int64_t written = gather_indices(dec, indices, n, [&](int64_t slot) {
    int r = to_yuv420(dec, out_y + slot * yb, out_u + slot * cb, out_v + slot * cb);
    if (r < 0) failed = true;  // gather aborts on the first failure (no wasted decode)
    return r;
  });
  if (failed) {
    g_last_error = "yuv420 conversion failed (unsupported pixel format)";
    return -1;
  }
  if (written < 0) {
    g_last_error = std::string("demux/decode error: ") + av_err_str(written);
    return -1;
  }
  return written;
}

int64_t vd_read_strided_yuv(void* h, int64_t start, int64_t n, int64_t stride,
                            uint8_t* out_y, uint8_t* out_u, uint8_t* out_v) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = start + i * stride;
  return vd_read_indices_yuv(h, idx.data(), n, out_y, out_u, out_v);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Encoder: RGB24 frames -> containerized video (mp4/h264 by default).
// Covers the reference's imageio mp4 writer (visualize_anonymization.py:84-115).
// ---------------------------------------------------------------------------

namespace {

struct Encoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVStream* stream = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* yuv = nullptr;
  AVPacket* pkt = nullptr;
  int w = 0, h = 0;
  int64_t n = 0;  // frames written (pts counter)
  bool header_written = false;

  ~Encoder() {
    if (sws) sws_freeContext(sws);
    if (yuv) av_frame_free(&yuv);
    if (pkt) av_packet_free(&pkt);
    if (codec) avcodec_free_context(&codec);
    if (fmt) {
      if (fmt->pb) avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
  }
};

// Drain encoder packets into the container. flush=false: until EAGAIN.
int drain_packets(Encoder* enc) {
  while (true) {
    int ret = avcodec_receive_packet(enc->codec, enc->pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
    if (ret < 0) return ret;
    av_packet_rescale_ts(enc->pkt, enc->codec->time_base, enc->stream->time_base);
    enc->pkt->stream_index = enc->stream->index;
    ret = av_interleaved_write_frame(enc->fmt, enc->pkt);
    av_packet_unref(enc->pkt);
    if (ret < 0) return ret;
  }
}

}  // namespace

extern "C" {

// Open an encoder writing to `path` (container guessed from extension, e.g. .mp4).
// codec_name: "libx264", "mpeg4", or "" for libx264-with-mpeg4-fallback.
// Even dimensions required (yuv420p chroma subsampling).
// cs_family: 0 = legacy behavior (untagged stream, swscale's default BT.601 RGB->YUV);
// 601/709 = tag the stream (VUI colour_primaries/transfer/matrix, limited range) AND
// convert RGB->YUV with the matching matrix, so decoders that honor the tag (including
// our own to_rgb/ops.yuv paths) reproduce the input RGB.
void* ve_open_cs(const char* path, int w, int h, double fps, const char* codec_name,
                 int cs_family) {
  if (w % 2 || h % 2) {
    g_last_error = "ve_open: width/height must be even for yuv420p";
    return nullptr;
  }
  auto enc = new Encoder();
  enc->w = w;
  enc->h = h;
  if (avformat_alloc_output_context2(&enc->fmt, nullptr, nullptr, path) < 0 || !enc->fmt) {
    g_last_error = "avformat_alloc_output_context2 failed (unknown container?)";
    delete enc;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  if (codec_name && codec_name[0]) {
    codec = avcodec_find_encoder_by_name(codec_name);
  } else {
    codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) codec = avcodec_find_encoder_by_name("mpeg4");
  }
  if (!codec) {
    g_last_error = "no usable video encoder (tried libx264, mpeg4)";
    delete enc;
    return nullptr;
  }
  av_log_set_level(AV_LOG_ERROR);  // silence libx264 info spam on stderr
  enc->codec = avcodec_alloc_context3(codec);
  enc->codec->width = w;
  enc->codec->height = h;
  enc->codec->pix_fmt = AV_PIX_FMT_YUV420P;
  const AVRational framerate = av_d2q(fps > 0 ? fps : 25.0, 1 << 16);
  enc->codec->time_base = AVRational{framerate.den, framerate.num};
  enc->codec->framerate = framerate;
  enc->codec->gop_size = 12;
  if (cs_family == 601 || cs_family == 709) {
    const bool bt709 = cs_family == 709;
    enc->codec->colorspace = bt709 ? AVCOL_SPC_BT709 : AVCOL_SPC_SMPTE170M;
    enc->codec->color_primaries = bt709 ? AVCOL_PRI_BT709 : AVCOL_PRI_SMPTE170M;
    enc->codec->color_trc = bt709 ? AVCOL_TRC_BT709 : AVCOL_TRC_SMPTE170M;
    enc->codec->color_range = AVCOL_RANGE_MPEG;
  }
  if (strcmp(codec->name, "libx264") == 0) {
    av_opt_set(enc->codec->priv_data, "preset", "veryfast", 0);
    av_opt_set(enc->codec->priv_data, "crf", "18", 0);
  } else {
    enc->codec->bit_rate = static_cast<int64_t>(w) * h * 8;  // generous for mpeg4
  }
  if (enc->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc->codec, codec, nullptr) < 0) {
    g_last_error = "avcodec_open2 (encoder) failed";
    delete enc;
    return nullptr;
  }
  enc->stream = avformat_new_stream(enc->fmt, codec);
  if (!enc->stream) {
    g_last_error = "avformat_new_stream failed";
    delete enc;
    return nullptr;
  }
  avcodec_parameters_from_context(enc->stream->codecpar, enc->codec);
  enc->stream->time_base = enc->codec->time_base;
  enc->stream->avg_frame_rate = framerate;
  if (!(enc->fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&enc->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    g_last_error = "avio_open failed";
    delete enc;
    return nullptr;
  }
  if (avformat_write_header(enc->fmt, nullptr) < 0) {
    g_last_error = "avformat_write_header failed";
    delete enc;
    return nullptr;
  }
  enc->header_written = true;
  enc->sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h, AV_PIX_FMT_YUV420P,
                            SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (enc->sws && (cs_family == 601 || cs_family == 709)) {
    // RGB->YUV with the tagged matrix; dst limited range to match the
    // AVCOL_RANGE_MPEG tag above (src RGB range kept).
    apply_sws_colorspace(enc->sws, cs_family, -1, 0);
  }
  enc->yuv = av_frame_alloc();
  enc->yuv->format = AV_PIX_FMT_YUV420P;
  enc->yuv->width = w;
  enc->yuv->height = h;
  if (cs_family == 601 || cs_family == 709) {
    enc->yuv->colorspace = enc->codec->colorspace;
    enc->yuv->color_primaries = enc->codec->color_primaries;
    enc->yuv->color_trc = enc->codec->color_trc;
    enc->yuv->color_range = AVCOL_RANGE_MPEG;
  }
  enc->pkt = av_packet_alloc();
  if (!enc->sws || !enc->pkt || av_frame_get_buffer(enc->yuv, 0) < 0) {
    g_last_error = "encoder allocation failure";
    delete enc;
    return nullptr;
  }
  return enc;
}

// Back-compat entry: untagged stream, swscale default (BT.601) RGB->YUV.
void* ve_open(const char* path, int w, int h, double fps, const char* codec_name) {
  return ve_open_cs(path, w, h, fps, codec_name, 0);
}

// Append one packed-RGB24 frame (h*w*3 bytes). Returns 0 on success. swscale reads
// the caller's rows at a line size of w * 3 here: staged through an aligned buffer,
// the encoded bytes were the same at every width tried (18 to 854 wide), so the
// source side needs no staging.
int ve_write(void* h, const uint8_t* rgb) {
  auto enc = static_cast<Encoder*>(h);
  if (av_frame_make_writable(enc->yuv) < 0) {
    g_last_error = "av_frame_make_writable failed";
    return -1;
  }
  const uint8_t* src[4] = {rgb, nullptr, nullptr, nullptr};
  int src_linesize[4] = {enc->w * 3, 0, 0, 0};
  sws_scale(enc->sws, src, src_linesize, 0, enc->h, enc->yuv->data, enc->yuv->linesize);
  enc->yuv->pts = enc->n++;  // time_base = 1/framerate -> one tick per frame
  int ret = avcodec_send_frame(enc->codec, enc->yuv);
  if (ret < 0) {
    g_last_error = "avcodec_send_frame failed";
    return ret;
  }
  ret = drain_packets(enc);
  if (ret < 0) g_last_error = "packet write failed";
  return ret;
}

// Flush, write trailer, close. Always frees the encoder. Returns 0 on success.
int ve_close(void* h) {
  auto enc = static_cast<Encoder*>(h);
  int ret = 0;
  if (enc->header_written) {
    avcodec_send_frame(enc->codec, nullptr);
    // Drain all flushed packets (receive until EOF).
    while (true) {
      int r = avcodec_receive_packet(enc->codec, enc->pkt);
      if (r == AVERROR_EOF || r == AVERROR(EAGAIN)) break;
      if (r < 0) {
        ret = r;
        break;
      }
      av_packet_rescale_ts(enc->pkt, enc->codec->time_base, enc->stream->time_base);
      enc->pkt->stream_index = enc->stream->index;
      if (av_interleaved_write_frame(enc->fmt, enc->pkt) < 0) ret = -1;
      av_packet_unref(enc->pkt);
    }
    if (av_write_trailer(enc->fmt) < 0) ret = -1;
  }
  delete enc;
  return ret;
}

}  // extern "C"
