"""The port's host C++ (``truely_tpu_torch/csrc/*.cpp``, built by
``media/host_build.py``) on the CPU: framepack against its numpy versions
and the JAX package's, the libav decoder against cv2 on the bundled mp4v
clip (MPEG-4 Part 2), the x264 writer, and the reader's choice of decoder.

Every comparison is exact (bytes), except an H.264 round trip, which is
lossy: frames written as I420 are held within a mean absolute error of 4
of the source, as ``tests/test_native.py`` holds the JAX writer.  The libav
tests skip only where the libav headers are absent, with that reason.
"""

import ctypes
import threading

import cv2
import numpy as np
import pytest
import torch

from tests.clip import FIXTURE
from tests.rawavi import write_i420_avi
from truely_tpu.media import native as jnative
from truely_tpu_torch.media import decode, encode, host_build, native, videodec, videoenc

torch.set_num_threads(2)


def needs(name):
    """Skip unless the libav library ``name`` can be built here."""
    missing = host_build.missing_headers(name)
    if missing:
        pytest.skip(f"libav headers not found: {', '.join(missing)}")


def rand_u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def smooth_i420(rng, w, h):
    """A packed I420 picture of blurred planes (cheap for x264 at crf 23)."""
    planes = [cv2.blur(rand_u8(rng, s), (15, 15)) for s in ((h, w), (h // 2, w // 2),
                                                            (h // 2, w // 2))]
    return np.concatenate([p.ravel() for p in planes]).reshape(h * 3 // 2, w)


# ---------------------------------------------------------------------------
# framepack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(6, 7), (33, 17), (1, 1)])
def test_pack_frames_equals_plain_and_jax(hw):
    rng = np.random.default_rng(0)
    frames = [rand_u8(rng, (*hw, 3)) for _ in range(3)]
    offsets = [2, 0, 3]
    got, plain, jax_ = (np.zeros((4, *hw, 3), np.uint8) for _ in range(3))
    native.pack_frames(got, frames, offsets)
    native.pack_frames_plain(plain, frames, offsets)
    jnative.pack_frames(jax_, frames, offsets)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_)
    assert not got[1].any()
    # views (an RGB flip) are packed as their pixels
    native.pack_frames(got, [frames[0][..., ::-1]], [1])
    np.testing.assert_array_equal(got[1], frames[0][..., ::-1])


@pytest.mark.parametrize("offsets", [[5], [-1], [0, 4]])
def test_pack_frames_bad_offset_raises(offsets):
    frames = [np.zeros((2, 2, 3), np.uint8)] * len(offsets)
    dst = np.full((4, 2, 2, 3), 7, np.uint8)
    with pytest.raises(ValueError, match="offset out of range"):
        native.pack_frames(dst, frames, offsets)
    assert (dst == 7).all()   # nothing copied


def test_pack_frames_rejects_mixed_sizes_and_counts():
    dst = np.zeros((2, 2, 2, 3), np.uint8)
    with pytest.raises(ValueError, match="same size"):
        native.pack_frames(dst, [np.zeros((2, 2, 3), np.uint8), np.zeros((1, 2, 3), np.uint8)],
                           [0, 1])
    with pytest.raises(ValueError, match="length mismatch"):
        native.pack_frames(dst, [np.zeros((2, 2, 3), np.uint8)], [0, 1])


@pytest.mark.parametrize("hw", [(4, 6), (12, 18), (36, 50), (8, 1922)])
@pytest.mark.parametrize("rgb", [False, True])
def test_i420_to_bgr_equals_plain_and_jax(hw, rgb):
    h, w = hw
    packed = rand_u8(np.random.default_rng(h * w), (h * 3 // 2, w))
    got = native.i420_to_bgr_host(packed, rgb=rgb)
    np.testing.assert_array_equal(got, native.i420_to_bgr_host_plain(packed, rgb=rgb))
    np.testing.assert_array_equal(got, jnative.i420_to_bgr_host(packed, rgb=rgb))


def test_i420_to_bgr_every_chroma_pair():
    """Every (U, V) pair, one a 2x2 block, under random luma: equal to the
    plain version."""
    w = h = 512
    y = rand_u8(np.random.default_rng(5), (h, w))
    uv = np.arange(256 * 256)
    u = (uv // 256).astype(np.uint8)
    v = (uv % 256).astype(np.uint8)
    packed = np.concatenate([y.ravel(), u, v]).reshape(h * 3 // 2, w)
    np.testing.assert_array_equal(native.i420_to_bgr_host(packed),
                                  native.i420_to_bgr_host_plain(packed))


@pytest.mark.parametrize("box", [(2, 2, 8, 7), (-3, -3, 5, 5), (8, 8, 30, 30), (-50, 4, 90, 6),
                                 (0, 0, 16, 12), (5, 5, 5, 5), (20, 20, 40, 40)])
@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_draw_rect_equals_plain_and_jax(box, thickness):
    base = rand_u8(np.random.default_rng(1), (13, 17, 3))
    got, plain, jax_ = base.copy(), base.copy(), base.copy()
    native.draw_rect(got, *box, color_bgr=(10, 200, 30), thickness=thickness)
    native.draw_rect_plain(plain, *box, color_bgr=(10, 200, 30), thickness=thickness)
    jnative.draw_rect(jax_, *box, color_bgr=(10, 200, 30), thickness=thickness)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_)


def test_draw_rect_on_a_view():
    """A frame that is not contiguous (an RGB view) is drawn on in place."""
    base = rand_u8(np.random.default_rng(2), (10, 12, 3))
    view, want = base.copy()[..., ::-1], base.copy()[..., ::-1]
    native.draw_rect(view, 1, 1, 8, 6, (1, 2, 3))
    native.draw_rect_plain(want, 1, 1, 8, 6, (1, 2, 3))
    np.testing.assert_array_equal(view, want)


@pytest.mark.parametrize("shape", [(5, 7, 3), (1, 3), (2, 1, 1, 3)])
def test_bgr_to_rgb_equals_plain_and_jax(shape):
    base = rand_u8(np.random.default_rng(3), shape)
    got, plain, jax_ = base.copy(), base.copy(), base.copy()
    native.bgr_to_rgb(got)
    native.bgr_to_rgb_plain(plain)
    jnative.bgr_to_rgb(jax_)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_)
    np.testing.assert_array_equal(got, base[..., ::-1])


# ---------------------------------------------------------------------------
# host_build
# ---------------------------------------------------------------------------


def test_concurrent_builds_never_load_half_a_library(tmp_path, monkeypatch):
    """Eight threads build one library into an empty cache at once: each
    compiles under its own temporary name, ``os.replace`` moves the
    results into place, and the library then loads and works."""
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    target, libs = host_build._target("framepack")
    target = tmp_path / target.name
    cxx = host_build.compiler()
    src = str(host_build.CSRC / "framepack.cpp")
    errors = []

    def build():
        try:
            host_build.compile_all({"framepack": (target, lambda tmp: [
                cxx, *host_build.CXX_FLAGS, "-o", str(tmp), src])}, cxx)
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in tmp_path.iterdir()] == [target.name]   # no temporary left
    lib = ctypes.CDLL(str(target))
    host_build.bind(lib, "tt_bgr_to_rgb", [ctypes.c_void_p, ctypes.c_int64], None)
    px = np.arange(6, dtype=np.uint8)
    lib.tt_bgr_to_rgb(px.ctypes.data, 2)
    assert px.tolist() == [2, 1, 0, 5, 4, 3]


def test_missing_headers_make_libav_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(host_build, "INCLUDE_ROOTS", (str(tmp_path),))
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setattr(host_build, "_status", {})
    assert host_build.load("videodec") is None and host_build.load("videoenc") is None
    status = host_build.status()
    assert status["videodec"].startswith("unavailable: libav headers not found")
    assert "libswscale/swscale.h" in status["videoenc"]
    assert status["framepack"] == "not loaded yet"


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "framepack.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(host_build, "CSRC", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_build, "_libs", {})
    with pytest.raises(RuntimeError, match="framepack.cpp"):
        host_build.load("framepack")
    assert not any((tmp_path / "build").iterdir())


# ---------------------------------------------------------------------------
# videodec
# ---------------------------------------------------------------------------


def test_videodec_equals_cv2_on_the_clip():
    """The first 64 frames of the bundled mp4v clip, decoded to packed I420
    and converted by the plain version, are cv2's BGR decode byte for
    byte."""
    needs("videodec")
    hnd, w, h, fps_num, fps_den, nb = videodec.open(FIXTURE)
    assert (w, h, fps_num, fps_den, nb) == (640, 360, 30, 1, 960)
    assert (videodec.pixfmt(hnd), videodec.codec(hnd)) == ("yuv420p", "mpeg4")
    assert videodec.colorinfo(hnd) == ("unknown", "unknown")
    cap = cv2.VideoCapture(FIXTURE)
    buf = np.empty((h * 3 // 2, w), np.uint8)
    try:
        for k in range(64):
            assert videodec.read(hnd, buf)
            ok, bgr = cap.read()
            assert ok
            np.testing.assert_array_equal(native.i420_to_bgr_host_plain(buf), bgr,
                                          err_msg=f"frame {k}")
    finally:
        cap.release()
        videodec.close(hnd)
    with pytest.raises(ValueError, match="closed"):
        videodec.read(hnd, buf)
    videodec.close(hnd)   # a second close does nothing


def test_videodec_skip_equals_read():
    needs("videodec")
    hnd, w, h, *_ = videodec.open(FIXTURE)
    rows = h * 3 // 2
    every = []
    for _ in range(33):
        buf = np.empty((rows, w), np.uint8)
        assert videodec.read(hnd, buf)
        every.append(buf)
    videodec.close(hnd)
    hnd, *_ = videodec.open(FIXTURE)
    for k in range(33):
        if k % 4 == 0:
            buf = np.empty((rows, w), np.uint8)
            assert videodec.read(hnd, buf)
            np.testing.assert_array_equal(buf, every[k])
        else:
            assert videodec.skip(hnd)
    videodec.close(hnd)


def test_videodec_errors(tmp_path):
    needs("videodec")
    bad = tmp_path / "x.mp4"
    bad.write_bytes(b"\0\0\0\x18ftypmp42" + b"\0" * 64)
    with pytest.raises(IOError, match="could not open"):
        videodec.open(str(bad))
    hnd, w, h, *_ = videodec.open(FIXTURE)
    with pytest.raises(ValueError, match="too small"):
        videodec.read(hnd, np.empty((h, w), np.uint8))
    with pytest.raises(TypeError):
        videodec.read(hnd, np.empty((h * 3 // 2, w), np.int16))
    videodec.close(hnd)


def test_videodec_end_of_stream(tmp_path):
    """A 5-frame mp4v clip: five reads, then False; skip at the end too."""
    needs("videodec")
    path = str(tmp_path / "five.mp4")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 16))
    rng = np.random.default_rng(4)
    for _ in range(5):
        out.write(rand_u8(rng, (16, 32, 3)))
    out.release()
    hnd, w, h, *_ = videodec.open(path)
    buf = np.empty((h * 3 // 2, w), np.uint8)
    assert [videodec.read(hnd, buf) for _ in range(6)] == [True] * 5 + [False]
    assert not videodec.skip(hnd)
    videodec.close(hnd)


# ---------------------------------------------------------------------------
# The reader's decoders
# ---------------------------------------------------------------------------


def first_segments(reader, interval, batch, n):
    out = []
    it = reader.segments(interval, batch)
    try:
        for seg in it:
            out.append(seg)
            if len(out) == n:
                break
    finally:
        it.close()
    return out


@pytest.mark.parametrize("host_frames", [False, True])
def test_reader_takes_videodec_and_equals_the_bgr_reader(host_frames):
    """``VideoReader(clip, yuv=True)`` decodes through videodec; its first
    segments, converted, are the BGR reader's (cv2) byte for byte, and its
    metadata is cv2's."""
    needs("videodec")
    with decode.VideoReader(FIXTURE, yuv=True, host_frames=host_frames) as yr, \
            decode.VideoReader(FIXTURE) as br:
        assert (yr.decoder, yr.yuv_active, br.decoder) == ("videodec", True, "cv2")
        assert yr.meta == br.meta
        ys, bs = first_segments(yr, 4, 8, 3), first_segments(br, 4, 8, 3)
    for y, b in zip(ys, bs):
        assert (y.frame_indices, y.sampled_indices, y.n_valid, y.n_frames) == \
            (b.frame_indices, b.sampled_indices, b.n_valid, b.n_frames)
        assert y.sampled.shape == (8, 540, 640)
        for row in range(y.n_valid):
            np.testing.assert_array_equal(native.i420_to_bgr_host_plain(y.sampled[row]),
                                          b.sampled[row])
        assert y.frames_i420 == host_frames
        if host_frames:
            assert len(y.frames) == y.n_frames
            for p, f in zip(y.frames, b.frames):
                np.testing.assert_array_equal(native.i420_to_bgr_host(p), f)
        else:
            assert y.frames == []


def test_reader_frames_and_yuv_frames_through_videodec():
    needs("videodec")
    with decode.VideoReader(FIXTURE, yuv=True) as r:
        got = []
        for idx, frame in r.frames():
            got.append(frame)
            if idx == 5:
                break
    with decode.VideoReader(FIXTURE, yuv=True) as r:
        packed = []
        for idx, p in r.yuv_frames(3):
            packed.append(p)
            if idx == 5:
                break
    cap = cv2.VideoCapture(FIXTURE)
    want = [cap.read()[1] for _ in range(6)]
    cap.release()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [p is None for p in packed] == [False, True, True, False, True, True]
    np.testing.assert_array_equal(native.i420_to_bgr_host(packed[3]), want[3])


def test_reader_without_cv2_reads_metadata_from_videodec(monkeypatch):
    needs("videodec")
    with decode.VideoReader(FIXTURE) as br:
        want = br.meta
    monkeypatch.setattr(decode, "cv2", None)
    with decode.VideoReader(FIXTURE, yuv=True) as r:
        assert r.decoder == "videodec" and r.meta == want
    with pytest.raises(IOError, match="needs cv2"):
        decode.VideoReader(FIXTURE)


def test_reader_falls_back_to_cv2_for_ineligible_streams(tmp_path):
    """H % 4 != 0 cannot be packed as (H*3//2, W) rows: cv2 decodes it."""
    needs("videodec")
    path = str(tmp_path / "h66.mp4")
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 66))
    for _ in range(3):
        out.write(np.zeros((66, 96, 3), np.uint8))
    out.release()
    with decode.VideoReader(path, yuv=True) as r:
        assert (r.decoder, r.yuv_active) == ("cv2", False)


def test_reader_keeps_rawavi_for_i420_avi(tmp_path):
    path = str(tmp_path / "a.avi")
    write_i420_avi(path, [np.zeros(32 * 16 * 3 // 2, np.uint8)] * 2, 32, 16)
    for yuv in (True, False):
        with decode.VideoReader(path, yuv=yuv) as r:
            assert r.decoder == "rawavi" and r.yuv_active == yuv


# ---------------------------------------------------------------------------
# videoenc and the writer
# ---------------------------------------------------------------------------


def test_writer_encodes_h264(tmp_path):
    """An mp4 path is H.264 from the native writer: the frames read back
    through cv2 and videodec, with the count written."""
    needs("videoenc")
    path = str(tmp_path / "enc.mp4")
    rng = np.random.default_rng(3)
    w, h = 96, 64
    with encode.VideoWriter(path, 10, w, h) as writer:
        assert writer.codec == "h264"
        for _ in range(7):
            writer.write(cv2.blur(rand_u8(rng, (h, w, 3)), (7, 7)))
    cap = cv2.VideoCapture(path)
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little").decode()
    assert fourcc.lower() in ("h264", "avc1")
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 7
    hnd, ww, hh, fn, fd, nb = videodec.open(path)
    assert (ww, hh, fn, fd, videodec.pixfmt(hnd), videodec.codec(hnd)) == \
        (w, h, 10, 1, "yuv420p", "h264")
    videodec.close(hnd)


def test_writer_mixes_i420_and_bgr(tmp_path):
    """Undrawn frames go in as I420 with no conversion, a drawn one as BGR:
    the output decodes to the source within x264's loss."""
    needs("videoenc")
    rng = np.random.default_rng(7)
    w, h = 96, 64
    pics = [smooth_i420(rng, w, h) for _ in range(6)]
    path = str(tmp_path / "mixed.mp4")
    with encode.VideoWriter(path, 30000 / 1001, w, h) as writer:
        for i, packed in enumerate(pics):
            if i == 3:
                writer.write(native.i420_to_bgr_host(packed))
            else:
                writer.write_i420(packed)
    with decode.VideoReader(path, yuv=True) as r:
        assert r.decoder == "videodec" and abs(r.meta.fps_exact - 30000 / 1001) < 1e-6
        got = [p for _, p in r.yuv_frames()]
    assert len(got) == 6
    for src, out in zip(pics, got):
        err = np.abs(native.i420_to_bgr_host(out).astype(int)
                     - native.i420_to_bgr_host(src).astype(int)).mean()
        assert err < 4.0


def test_videoenc_rejects_bad_input(tmp_path):
    needs("videoenc")
    with pytest.raises(ValueError):
        videoenc.open(str(tmp_path / "odd.mp4"), 97, 64, 10, 1)
    with pytest.raises(ValueError):
        videoenc.open(str(tmp_path / "crf.mp4"), 96, 64, 10, 1, crf=60)
    hnd = videoenc.open(str(tmp_path / "s.mp4"), 96, 64, 10, 1)
    with pytest.raises(ValueError):
        videoenc.write_i420(hnd, np.zeros((64, 96), np.uint8))
    with pytest.raises(ValueError):
        videoenc.write(hnd, np.zeros((64, 96, 4), np.uint8))
    videoenc.close(hnd)
    with pytest.raises(ValueError, match="closed"):
        videoenc.write_i420(hnd, np.zeros((96, 96), np.uint8))
    videoenc.close(hnd)
    with pytest.raises(IOError, match="could not open"):
        videoenc.open(str(tmp_path / "no" / "dir.mp4"), 96, 64, 10, 1)


def test_writer_without_cv2_encodes_h264(tmp_path, monkeypatch):
    needs("videoenc")
    monkeypatch.setattr(encode, "cv2", None)
    path = str(tmp_path / "o.mp4")
    with encode.VideoWriter(path, 10, 64, 48) as writer:
        assert writer.codec == "h264"
        writer.write_i420(np.zeros((72, 64), np.uint8))
    assert videoenc.has_x264()
