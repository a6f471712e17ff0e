// framepack: host-side frame helpers of the media pipeline, behind a plain
// C interface (loaded with ctypes by media/native.py; built by
// media/host_build.py).
//
// Decode and encode stay on libav or cv2, but the glue that would otherwise
// be per-frame Python (packing sampled frames into the device-batch staging
// buffer, the exact I420->BGR conversion of frames drawn on, box outlines,
// channel swaps) is here.  ctypes releases the GIL around each call, so the
// work overlaps the decode thread.  The caller checks dtypes, shapes and
// contiguity; these functions check what they index with.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint8_t clip8(int32_t v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// Copies frame i (frame_bytes bytes) into row offsets[i] of dst.  Returns 0,
// or -1 (nothing copied) if an offset lies outside dst's dst_bytes.
int tt_pack_frames(uint8_t* dst, int64_t dst_bytes, const uint8_t* const* frames,
                   const int64_t* offsets, int64_t n, int64_t frame_bytes) {
    for (int64_t i = 0; i < n; ++i) {
        if (offsets[i] < 0 || (offsets[i] + 1) * frame_bytes > dst_bytes) return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(dst + offsets[i] * frame_bytes, frames[i], frame_bytes);
    }
    return 0;
}

// Exact yuv420p -> bgr24 of one packed I420 picture (Y: h rows of w, then U
// and V, each (h/2, w/2)): the integer fixed-point function of swscale for
// untagged/BT.601-limited input, which cv2's BGR decode applies, and kernel
// K1's (csrc/yuv.cu).  rgb != 0 reverses the channel order.  Returns 0, or
// -1 for odd or non-positive sizes.
int tt_i420_to_bgr(const uint8_t* src, uint8_t* dst, int w, int h, int rgb) {
    if (w <= 0 || h <= 0 || (w % 2) || (h % 2)) return -1;
    const uint8_t* yp = src;
    const uint8_t* up = yp + (size_t)w * h;
    const uint8_t* vp = up + (size_t)(w / 2) * (h / 2);
    const int c0 = rgb ? 2 : 0, c2 = rgb ? 0 : 2;
    // Row-planar arithmetic passes (plain int32 loops the compiler
    // vectorizes), then one interleave pass.
    std::vector<int32_t> tb(w), tg(w), tr(w), q(w);
    std::vector<uint8_t> brow(w), grow(w), rrow(w);
    for (int cy = 0; cy < h / 2; ++cy) {
        const uint8_t* urow = up + (size_t)cy * (w / 2);
        const uint8_t* vrow = vp + (size_t)cy * (w / 2);
        for (int cx = 0; cx < w / 2; ++cx) {
            const int32_t uu = urow[cx], vv = vrow[cx];
            const int32_t b = (132193 * uu - 16920704) >> 16;
            const int32_t g = ((-25673 * uu + 3286144) >> 16) + ((-53281 * vv + 6819968) >> 16);
            const int32_t r = (104593 * vv - 13387904) >> 16;
            tb[2 * cx] = tb[2 * cx + 1] = b;
            tg[2 * cx] = tg[2 * cx + 1] = g;
            tr[2 * cx] = tr[2 * cx + 1] = r;
        }
        for (int sub = 0; sub < 2; ++sub) {
            const int y = 2 * cy + sub;
            const uint8_t* yrow = yp + (size_t)y * w;
            uint8_t* orow = dst + (size_t)y * w * 3;
            for (int x = 0; x < w; ++x) q[x] = (76305 * (int32_t)yrow[x] - 1219995) >> 16;
            for (int x = 0; x < w; ++x) brow[x] = clip8(q[x] + tb[x]);
            for (int x = 0; x < w; ++x) grow[x] = clip8(q[x] + tg[x]);
            for (int x = 0; x < w; ++x) rrow[x] = clip8(q[x] + tr[x]);
            for (int x = 0; x < w; ++x) {
                orow[3 * x + c0] = brow[x];
                orow[3 * x + 1] = grow[x];
                orow[3 * x + c2] = rrow[x];
            }
        }
    }
    return 0;
}

// Rectangle outline on an (h, w, 3) uint8 frame, clipped to the image;
// thickness t grows the outline half inward and half outward of the
// nominal edge, as cv2.rectangle does for in-bounds boxes.
void tt_draw_rect(uint8_t* px, int64_t h, int64_t w, int64_t x1, int64_t y1, int64_t x2,
                  int64_t y2, int b, int g, int r, int64_t thickness) {
    const uint8_t color[3] = {static_cast<uint8_t>(b), static_cast<uint8_t>(g),
                              static_cast<uint8_t>(r)};
    auto put = [&](int64_t y, int64_t x) {
        if (y < 0 || y >= h || x < 0 || x >= w) return;
        uint8_t* p = px + (y * w + x) * 3;
        p[0] = color[0];
        p[1] = color[1];
        p[2] = color[2];
    };
    for (int64_t t = 0; t < thickness; ++t) {
        const int64_t o = t - thickness / 2;
        for (int64_t x = std::max<int64_t>(x1 - o, -1); x <= std::min(x2 + o, w); ++x) {
            put(y1 - o, x);
            put(y2 + o, x);
        }
        for (int64_t y = std::max<int64_t>(y1 - o, -1); y <= std::min(y2 + o, h); ++y) {
            put(y, x1 - o);
            put(y, x2 + o);
        }
    }
}

// In-place swap of the first and third byte of each of npix 3-byte pixels.
void tt_bgr_to_rgb(uint8_t* px, int64_t npix) {
    for (int64_t i = 0; i < npix; ++i) std::swap(px[i * 3], px[i * 3 + 2]);
}

}  // extern "C"
