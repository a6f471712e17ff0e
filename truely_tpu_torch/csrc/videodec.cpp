// videodec: libav demux and decode of a video stream to packed yuv420p,
// behind a plain C interface (loaded with ctypes by media/videodec.py;
// built by media/host_build.py where the libav headers are).
//
// cv2.VideoCapture converts every frame to packed BGR on the host (swscale)
// before Python sees it.  For the device pipeline that conversion is waste:
// H.264 content is 4:2:0, so uploading the decoder's own yuv420p planes is
// 1.5 bytes a pixel instead of 3, and the conversion runs on the card as
// kernel K1.  ctypes releases the GIL around every call.
//
// Every call that can fail takes an error buffer (err, errlen) and writes a
// message into it.  Return codes: open gives a handle or NULL; read and
// skip give 1 for a frame, 0 at the end of the stream, -1 on an error.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/pixdesc.h>
}

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Dec {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* ctx = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_index = -1;
    bool draining = false;
    bool eof = false;
};

void dec_free(Dec* d) {
    if (!d) return;
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->ctx) avcodec_free_context(&d->ctx);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
}

void set_error(char* err, int errlen, const char* what, int code) {
    char buf[256];
    av_strerror(code, buf, sizeof buf);
    std::snprintf(err, errlen, "%s: %s", what, buf);
}

// Decodes the next frame into d->frame.  1 on a frame, 0 at the end of the
// stream, a negative AVERROR on failure.
int next_frame(Dec* d) {
    if (d->eof) return 0;
    while (true) {
        int err = avcodec_receive_frame(d->ctx, d->frame);
        if (err == 0) return 1;
        if (err == AVERROR_EOF) {
            d->eof = true;
            return 0;
        }
        if (err != AVERROR(EAGAIN)) return err;
        if (d->draining) continue;
        while (true) {
            err = av_read_frame(d->fmt, d->pkt);
            if (err == AVERROR_EOF) {
                d->draining = true;
                err = avcodec_send_packet(d->ctx, nullptr);  // flush
                if (err < 0 && err != AVERROR_EOF) return err;
                break;
            }
            if (err < 0) return err;
            if (d->pkt->stream_index != d->stream_index) {
                av_packet_unref(d->pkt);
                continue;
            }
            err = avcodec_send_packet(d->ctx, d->pkt);
            av_packet_unref(d->pkt);
            if (err < 0 && err != AVERROR(EAGAIN)) return err;
            break;
        }
    }
}

}  // namespace

extern "C" {

// Opens the best video stream of path.  info receives width, height,
// fps_num, fps_den; nb_frames the container's count (or one estimated from
// the duration).  skip_nonref != 0 has the decoder discard non-reference
// frames (a probe mode: the frames delivered are then not every frame).
void* tt_vd_open(const char* path, int skip_nonref, int* info, int64_t* nb_frames, char* err,
                 int errlen) {
    Dec* d = new Dec();
    int code = 0;
    const AVCodec* codec = nullptr;
    code = avformat_open_input(&d->fmt, path, nullptr, nullptr);
    if (code >= 0) code = avformat_find_stream_info(d->fmt, nullptr);
    if (code >= 0) {
        d->stream_index = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
        if (d->stream_index < 0 || !codec) code = AVERROR_STREAM_NOT_FOUND;
    }
    if (code >= 0) {
        d->ctx = avcodec_alloc_context3(codec);
        if (!d->ctx) code = AVERROR(ENOMEM);
    }
    if (code >= 0)
        code = avcodec_parameters_to_context(d->ctx, d->fmt->streams[d->stream_index]->codecpar);
    if (code >= 0) {
        // Frame-threaded decode on every core, as cv2's FFmpeg wrapper does.
        d->ctx->thread_count = 0;
        if (skip_nonref) d->ctx->skip_frame = AVDISCARD_NONREF;
        code = avcodec_open2(d->ctx, codec, nullptr);
    }
    if (code >= 0) {
        d->pkt = av_packet_alloc();
        d->frame = av_frame_alloc();
        if (!d->pkt || !d->frame) code = AVERROR(ENOMEM);
    }
    if (code < 0) {
        char what[512];
        std::snprintf(what, sizeof what, "videodec: could not open %s", path);
        set_error(err, errlen, what, code);
        dec_free(d);
        return nullptr;
    }
    AVStream* st = d->fmt->streams[d->stream_index];
    AVRational fps = st->avg_frame_rate;
    if (fps.num <= 0 || fps.den <= 0) fps = st->r_frame_rate;
    long long nb = st->nb_frames;
    if (nb <= 0 && st->duration > 0 && fps.num > 0)
        nb = (long long)(st->duration * av_q2d(st->time_base) * av_q2d(fps) + 0.5);
    info[0] = d->ctx->width;
    info[1] = d->ctx->height;
    info[2] = fps.num;
    info[3] = fps.den;
    *nb_frames = nb;
    return d;
}

// Decodes the next frame into dst (dst_len bytes): Y as h rows of w, then U
// and V, each (h/2, w/2).  A frame that is not 8-bit yuv420p/yuvj420p with
// even sizes, or a dst too small for it, is an error.
int tt_vd_read(void* handle, uint8_t* dst, int64_t dst_len, char* err, int errlen) {
    Dec* d = static_cast<Dec*>(handle);
    const int got = next_frame(d);
    if (got < 0) {
        set_error(err, errlen, "videodec: decode error", got);
        return -1;
    }
    if (got == 0) return 0;
    const int w = d->frame->width, h = d->frame->height;
    const int64_t need = (int64_t)w * h * 3 / 2;
    int rc = 1;
    if ((d->frame->format != AV_PIX_FMT_YUV420P && d->frame->format != AV_PIX_FMT_YUVJ420P) ||
        (w % 2) || (h % 2)) {
        std::snprintf(err, errlen,
                      "videodec: stream is not 8-bit yuv420p (read it through cv2 instead)");
        rc = -1;
    } else if (dst_len < need) {
        std::snprintf(err, errlen, "videodec: dst too small (%lld < %lld)", (long long)dst_len,
                      (long long)need);
        rc = -1;
    } else {
        const int cw = w / 2, ch = h / 2;
        for (int r = 0; r < h; ++r)
            std::memcpy(dst + (size_t)r * w, d->frame->data[0] + (size_t)r * d->frame->linesize[0],
                        w);
        uint8_t* up = dst + (size_t)w * h;
        for (int r = 0; r < ch; ++r)
            std::memcpy(up + (size_t)r * cw, d->frame->data[1] + (size_t)r * d->frame->linesize[1],
                        cw);
        uint8_t* vp = up + (size_t)cw * ch;
        for (int r = 0; r < ch; ++r)
            std::memcpy(vp + (size_t)r * cw, d->frame->data[2] + (size_t)r * d->frame->linesize[2],
                        cw);
    }
    av_frame_unref(d->frame);
    return rc;
}

// Decodes the next frame without exporting its planes: references force the
// decode of every frame, but an unsampled frame's plane copy is waste.
int tt_vd_skip(void* handle, char* err, int errlen) {
    Dec* d = static_cast<Dec*>(handle);
    const int got = next_frame(d);
    if (got < 0) {
        set_error(err, errlen, "videodec: decode error", got);
        return -1;
    }
    if (got == 1) av_frame_unref(d->frame);
    return got;
}

// The decoder's pixel format name, e.g. "yuv420p".
const char* tt_vd_pixfmt(void* handle) {
    const char* name = av_get_pix_fmt_name(static_cast<Dec*>(handle)->ctx->pix_fmt);
    return name ? name : "unknown";
}

// The stream's codec name, e.g. "h264".
const char* tt_vd_codec(void* handle) {
    return avcodec_get_name(static_cast<Dec*>(handle)->ctx->codec_id);
}

// The stream's colour space and range tag names, e.g. "unknown" and "tv".
const char* tt_vd_colorspace(void* handle) {
    const char* name = av_color_space_name(static_cast<Dec*>(handle)->ctx->colorspace);
    return name ? name : "unknown";
}

const char* tt_vd_colorrange(void* handle) {
    const char* name = av_color_range_name(static_cast<Dec*>(handle)->ctx->color_range);
    return name ? name : "unknown";
}

void tt_vd_close(void* handle) { dec_free(static_cast<Dec*>(handle)); }

// avcodec_version() of the library this was linked against.
unsigned tt_vd_avcodec_version() { return avcodec_version(); }

}  // extern "C"
