// videoenc: H.264 MP4 writer of the annotated output (libx264 through the
// system libavcodec, MP4 muxing through libavformat), behind a plain C
// interface (loaded with ctypes by media/videoenc.py; built by
// media/host_build.py where the libav headers are).
//
// The reference asks cv2.VideoWriter for H.264, which many cv2 builds cannot
// encode (they fall back to MPEG-4 Part 2, "mp4v").  BGR frames go through
// swscale to yuv420p; packed I420 pictures (frames decoded as yuv420p and
// not drawn on) copy straight into the encoder's frame with no colour
// conversion.  ctypes releases the GIL around every call.
//
// Every call that can fail takes an error buffer (err, errlen) and returns
// 0, or -1 with a message in it; open returns a handle or NULL.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstdio>

namespace {

struct Enc {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* ctx = nullptr;
    AVStream* stream = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    SwsContext* sws = nullptr;
    int64_t pts = 0;
    bool header_written = false;
};

void enc_free(Enc* e) {
    if (!e) return;
    if (e->sws) sws_freeContext(e->sws);
    if (e->frame) av_frame_free(&e->frame);
    if (e->pkt) av_packet_free(&e->pkt);
    if (e->ctx) avcodec_free_context(&e->ctx);
    if (e->fmt) {
        if (e->fmt->pb) avio_closep(&e->fmt->pb);
        avformat_free_context(e->fmt);
    }
    delete e;
}

void set_error(char* err, int errlen, const char* what, int code) {
    char buf[256];
    av_strerror(code, buf, sizeof buf);
    std::snprintf(err, errlen, "%s: %s", what, buf);
}

// Moves the encoder's ready packets into the muxer.  0 or a negative AVERROR.
int drain(Enc* e) {
    while (true) {
        int code = avcodec_receive_packet(e->ctx, e->pkt);
        if (code == AVERROR(EAGAIN) || code == AVERROR_EOF) return 0;
        if (code < 0) return code;
        av_packet_rescale_ts(e->pkt, e->ctx->time_base, e->stream->time_base);
        // An explicit duration: without it the muxer gives the last sample
        // a duration of 0 and demuxers drop the last frame.
        e->pkt->duration = av_rescale_q(1, e->ctx->time_base, e->stream->time_base);
        e->pkt->stream_index = e->stream->index;
        code = av_interleaved_write_frame(e->fmt, e->pkt);
        if (code < 0) return code;
    }
}

// Sends e->frame (filled by the caller) to the encoder and drains it.
int send(Enc* e, char* err, int errlen) {
    e->frame->pts = e->pts++;
    int code = avcodec_send_frame(e->ctx, e->frame);
    if (code >= 0) code = drain(e);
    if (code < 0) {
        set_error(err, errlen, "videoenc: encode error", code);
        return -1;
    }
    return 0;
}

}  // namespace

extern "C" {

// Opens an MP4 writer of w x h yuv420p H.264 at fps_num/fps_den frames a
// second.  preset, crf, threads and slices tune x264 (threads 0: x264's own
// frame threads; slices > 0: sliced threads).  The caller checks that the
// sizes are even and positive, fps positive, crf in [0, 51] and
// threads/slices >= 0.
void* tt_ve_open(const char* path, int w, int h, int fps_num, int fps_den, const char* preset,
                 int crf, int threads, int slices, char* err, int errlen) {
    av_log_set_level(AV_LOG_ERROR);  // x264's statistics off
    Enc* e = new Enc();
    int code = avformat_alloc_output_context2(&e->fmt, nullptr, "mp4", path);
    const AVCodec* codec = nullptr;
    if (code >= 0) {
        codec = avcodec_find_encoder_by_name("libx264");
        if (!codec) code = AVERROR_ENCODER_NOT_FOUND;
    }
    if (code >= 0) {
        e->ctx = avcodec_alloc_context3(codec);
        e->stream = avformat_new_stream(e->fmt, nullptr);
        e->frame = av_frame_alloc();
        e->pkt = av_packet_alloc();
        if (!e->ctx || !e->stream || !e->frame || !e->pkt) code = AVERROR(ENOMEM);
    }
    if (code >= 0) {
        e->ctx->width = w;
        e->ctx->height = h;
        e->ctx->pix_fmt = AV_PIX_FMT_YUV420P;
        e->ctx->time_base = AVRational{fps_den, fps_num};
        e->ctx->framerate = AVRational{fps_num, fps_den};
        av_opt_set(e->ctx->priv_data, "preset", preset, 0);
        char crf_s[8];
        std::snprintf(crf_s, sizeof crf_s, "%d", crf);
        av_opt_set(e->ctx->priv_data, "crf", crf_s, 0);
        if (threads > 0) e->ctx->thread_count = threads;
        if (slices > 0) {
            av_opt_set_int(e->ctx->priv_data, "slices", slices, 0);
            av_opt_set(e->ctx->priv_data, "x264-params", "sliced-threads=1", 0);
        }
        if (e->fmt->oformat->flags & AVFMT_GLOBALHEADER)
            e->ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        code = avcodec_open2(e->ctx, codec, nullptr);
    }
    if (code >= 0) {
        e->stream->time_base = e->ctx->time_base;
        code = avcodec_parameters_from_context(e->stream->codecpar, e->ctx);
    }
    if (code >= 0) code = avio_open(&e->fmt->pb, path, AVIO_FLAG_WRITE);
    if (code >= 0) {
        code = avformat_write_header(e->fmt, nullptr);
        if (code >= 0) e->header_written = true;
    }
    if (code >= 0) {
        e->frame->format = AV_PIX_FMT_YUV420P;
        e->frame->width = w;
        e->frame->height = h;
        code = av_frame_get_buffer(e->frame, 0);
    }
    if (code >= 0) {
        e->sws = sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h, AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                                nullptr, nullptr, nullptr);
        if (!e->sws) code = AVERROR(ENOMEM);
    }
    if (code < 0) {
        char what[512];
        std::snprintf(what, sizeof what, "videoenc: could not open %s", path);
        set_error(err, errlen, what, code);
        enc_free(e);
        return nullptr;
    }
    return e;
}

// Encodes one (h, w, 3) uint8 BGR frame of exactly len = w * h * 3 bytes.
int tt_ve_write(void* handle, const uint8_t* bgr, int64_t len, char* err, int errlen) {
    Enc* e = static_cast<Enc*>(handle);
    if (len != (int64_t)e->ctx->width * e->ctx->height * 3) {
        std::snprintf(err, errlen, "videoenc: frame of %lld bytes, want %d x %d x 3",
                      (long long)len, e->ctx->height, e->ctx->width);
        return -1;
    }
    int code = av_frame_make_writable(e->frame);
    if (code < 0) {
        set_error(err, errlen, "videoenc: encode error", code);
        return -1;
    }
    const uint8_t* in[1] = {bgr};
    const int in_stride[1] = {3 * e->ctx->width};
    sws_scale(e->sws, in, in_stride, 0, e->ctx->height, e->frame->data, e->frame->linesize);
    return send(e, err, errlen);
}

// Encodes one packed I420 picture (Y as h rows of w, then U and V, each
// (h/2, w/2)) of exactly w * h * 3 / 2 bytes, with no colour conversion.
int tt_ve_write_i420(void* handle, const uint8_t* p, int64_t len, char* err, int errlen) {
    Enc* e = static_cast<Enc*>(handle);
    const int w = e->ctx->width, h = e->ctx->height;
    if (len != (int64_t)w * h * 3 / 2) {
        std::snprintf(err, errlen,
                      "videoenc: I420 picture must be exactly %lld bytes (H*3/2 x W = %d x %d), "
                      "got %lld", (long long)w * h * 3 / 2, h * 3 / 2, w, (long long)len);
        return -1;
    }
    int code = av_frame_make_writable(e->frame);
    if (code < 0) {
        set_error(err, errlen, "videoenc: encode error", code);
        return -1;
    }
    const uint8_t* pu = p + (size_t)w * h;
    const uint8_t* pv = pu + (size_t)(w / 2) * (h / 2);
    av_image_copy_plane(e->frame->data[0], e->frame->linesize[0], p, w, w, h);
    av_image_copy_plane(e->frame->data[1], e->frame->linesize[1], pu, w / 2, w / 2, h / 2);
    av_image_copy_plane(e->frame->data[2], e->frame->linesize[2], pv, w / 2, w / 2, h / 2);
    return send(e, err, errlen);
}

// Flushes the encoder, writes the MP4 trailer (without it the file does not
// play) and frees the writer, also when it fails.
int tt_ve_close(void* handle, char* err, int errlen) {
    Enc* e = static_cast<Enc*>(handle);
    int code = avcodec_send_frame(e->ctx, nullptr);
    if (code >= 0 || code == AVERROR_EOF) code = drain(e);
    if (code >= 0 && e->header_written) code = av_write_trailer(e->fmt);
    enc_free(e);
    if (code < 0) {
        set_error(err, errlen, "videoenc: finalize error", code);
        return -1;
    }
    return 0;
}

// Whether the linked libavcodec has the libx264 encoder.
int tt_ve_has_x264() { return avcodec_find_encoder_by_name("libx264") != nullptr; }

}  // extern "C"
