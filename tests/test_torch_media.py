"""The port's host media layer (``truely_tpu_torch/media``) against the JAX
package's (``truely_tpu/media``) and cv2, on seeded I420 AVI files.

``rawavi`` is the port's own I420 AVI reader and writer: what it reads must
be byte for byte what ``tests/rawavi.write_i420_avi`` wrote, its metadata
what cv2 reports, its BGR frames cv2's decode, and what it writes must read
back through cv2.  The reader's segments equal the JAX reader's (which
decodes through cv2) at every sample interval, pixels included, and the
overlay draws the JAX overlay's pixels.  The BGR->I420 conversion of the
writer has cv2's luma exactly; its chroma averages each 2x2 block, which
cv2 does not (cv2 takes the block's top-left pixel), so it is held within
1 of the mean of cv2's chroma of the four pixels.
"""

import os
import struct

import cv2
import numpy as np
import pytest
import torch

from tests.rawavi import write_i420_avi
from truely_tpu.media import decode as jdecode
from truely_tpu.media import native as jnative
from truely_tpu.media import overlay as joverlay
from truely_tpu_torch.media import decode, encode, native, overlay, rawavi, videodec, videoenc

torch.set_num_threads(2)


def random_i420(seed, w, h, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8) for _ in range(n)]


def packed(flat, w, h):
    return np.asarray(flat).reshape(h * 3 // 2, w)


def cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def build_avi(path, frames, w, h, *, fps=30, fourcc=b"I420", bits=12, movi_items=None,
              idx1=False, extra_top=b""):
    """An I420 AVI with chosen chunks: ``movi_items`` is the payload of the
    movi list (default: one ``00dc`` chunk a frame)."""
    fb = w * h * 3 // 2

    def chunk(tag, payload):
        return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) % 2 else b"")

    def lst(kind, payload):
        return chunk(b"LIST", kind + payload)

    if movi_items is None:
        movi_items = b"".join(chunk(b"00dc", f.tobytes()) for f in frames)
    avih = struct.pack("<14I", 1000000 // fps, fb * fps, 0, 0x10, len(frames), 0, 1, fb, w, h,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0,
                       len(frames), fb, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, bits, fourcc, fb, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    body = hdrl + extra_top + lst(b"movi", movi_items)
    if idx1:
        body += chunk(b"idx1", b"".join(struct.pack("<4sIII", b"00dc", 0x10, 4 + i * (8 + fb), fb)
                                         for i in range(len(frames))))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body)


@pytest.mark.parametrize("w,h,fps", [(64, 48, 30), (96, 64, 10), (32, 16, 14)])
def test_rawavi_reads_what_was_written(tmp_path, w, h, fps):
    frames = random_i420(w, w, h, 7)
    path = str(tmp_path / "a.avi")
    write_i420_avi(path, frames, w, h, fps=fps)
    reader = rawavi.RawAviReader(path)
    try:
        assert reader.frame_count == 7
        for k in (3, 0, 6, 1):  # any order: each frame is one positioned read
            np.testing.assert_array_equal(reader.read(k), packed(frames[k], w, h))
    finally:
        reader.close()


@pytest.mark.parametrize("writer", ["tests", "port"])
def test_meta_equals_the_jax_reader(tmp_path, writer):
    w, h = 64, 48
    frames = random_i420(1, w, h, 9)
    path = str(tmp_path / "m.avi")
    if writer == "tests":
        write_i420_avi(path, frames, w, h, fps=14)
    else:
        out = rawavi.RawAviWriter(path, 14, w, h)
        for f in frames:
            out.write_i420(packed(f, w, h))
        out.close()
    with jdecode.VideoReader(path) as jr, decode.VideoReader(path, yuv=True) as r:
        assert r.meta == decode.VideoMeta(**vars(jr.meta))
        assert r.yuv_active


def test_frames_equal_cv2_decode(tmp_path):
    w, h = 64, 48
    frames = random_i420(2, w, h, 6)
    path = str(tmp_path / "f.avi")
    write_i420_avi(path, frames, w, h)
    want = cv2_frames(path)
    with decode.VideoReader(path) as r:
        got = [f for _, f in r.frames()]
    with decode.VideoReader(path, rgb=True) as r:
        rgb = [f for _, f in r.frames()]
    assert len(got) == len(want) == 6
    for g, c, x in zip(got, want, rgb):
        np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(x, c[..., ::-1])


def test_host_conversion_equals_the_jax_numpy_version():
    rng = np.random.default_rng(3)
    for h, w in ((4, 2), (48, 64), (120, 160)):
        p = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
        for rgb in (False, True):
            np.testing.assert_array_equal(native.i420_to_bgr_host(p, rgb=rgb),
                                          jnative.i420_to_bgr_host(p, rgb=rgb))


def test_pack_frames_and_bgr_to_rgb_equal_the_jax_numpy_versions():
    rng = np.random.default_rng(18)
    frames = [rng.integers(0, 256, (6, 7, 3), dtype=np.uint8) for _ in range(3)]
    a, b = np.zeros((4, 6, 7, 3), np.uint8), np.zeros((4, 6, 7, 3), np.uint8)
    saved = jnative._ext
    jnative._ext = None  # the JAX package's numpy versions
    try:
        jnative.pack_frames(a, frames, [2, 0, 3])
        x = frames[0].copy()
        jnative.bgr_to_rgb(x)
    finally:
        jnative._ext = saved
    native.pack_frames(b, frames, [2, 0, 3])
    y = frames[0].copy()
    native.bgr_to_rgb(y)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(y, frames[0][..., ::-1])


def test_pad_junk_rec_list_and_no_idx1_parse(tmp_path):
    """An odd-size chunk with its pad byte, JUNK at the top and inside
    movi, another stream's chunks, frames inside ``LIST rec `` and no idx1:
    every frame is found, in order, and cv2 decodes the same pictures."""
    w, h = 32, 16
    frames = random_i420(4, w, h, 5)

    def chunk(tag, payload):
        return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) % 2 else b"")

    movi = (chunk(b"JUNK", b"\x07" * 13)
            + chunk(b"00dc", frames[0].tobytes())
            + chunk(b"01wb", b"\x01" * 7)
            + chunk(b"LIST", b"rec " + chunk(b"00dc", frames[1].tobytes())
                    + chunk(b"01wb", b"\x02" * 3) + chunk(b"00db", frames[2].tobytes()))
            + chunk(b"ix00", b"\x00" * 24)
            + chunk(b"00dc", frames[3].tobytes())
            + chunk(b"JUNK", b"")
            + chunk(b"00dc", frames[4].tobytes()))
    path = str(tmp_path / "odd.avi")
    build_avi(path, frames, w, h, movi_items=movi, extra_top=chunk(b"JUNK", b"\x00" * 5))
    reader = rawavi.RawAviReader(path)
    try:
        assert reader.frame_count == 5
        for k in range(5):
            np.testing.assert_array_equal(reader.read(k), packed(frames[k], w, h))
    finally:
        reader.close()
    with decode.VideoReader(path) as r:
        got = [f for _, f in r.frames()]
    want = cv2_frames(path)
    assert len(want) == 5
    for g, c in zip(got, want):
        np.testing.assert_array_equal(g, c)


def test_idx1_is_ignored(tmp_path):
    w, h = 32, 16
    frames = random_i420(5, w, h, 3)
    path = str(tmp_path / "idx.avi")
    build_avi(path, frames, w, h, idx1=True)
    reader = rawavi.RawAviReader(path)
    try:
        assert reader.frame_count == 3
        np.testing.assert_array_equal(reader.read(2), packed(frames[2], w, h))
    finally:
        reader.close()


@pytest.mark.parametrize("kw,reason", [
    (dict(fourcc=b"YV12"), "fourcc"),
    (dict(bits=16), "bits a pixel"),
    (dict(w=34, h=16, bad_w=33), "width"),
    (dict(w=32, h=18), "height"),
])
def test_ineligible_files_raise(tmp_path, kw, reason):
    w, h = kw.pop("w", 32), kw.pop("h", 16)
    bad_w = kw.pop("bad_w", None)
    path = str(tmp_path / "bad.avi")
    frames = random_i420(6, w, h, 2)
    if bad_w is not None:
        # An odd width: patch the BITMAPINFOHEADER after writing.
        build_avi(path, frames, w, h, **kw)
        data = bytearray(open(path, "rb").read())
        at = data.index(b"strf") + 8 + 4
        data[at:at + 4] = struct.pack("<i", bad_w)
        open(path, "wb").write(bytes(data))
    else:
        build_avi(path, frames, w, h, **kw)
    with pytest.raises(rawavi.NotEligible, match=reason):
        rawavi.probe(path)


def test_ineligible_avi_goes_through_cv2(tmp_path):
    """An I420 AVI whose height is not divisible by 4 is no rawavi file: the
    reader decodes it through cv2, to BGR, as the JAX reader does."""
    w, h = 32, 18
    frames = random_i420(7, w, h, 3)
    path = str(tmp_path / "h18.avi")
    write_i420_avi(path, frames, w, h)
    with decode.VideoReader(path, yuv=True) as r:
        assert not r.yuv_active
        got = [f for _, f in r.frames()]
    for g, c in zip(got, cv2_frames(path)):
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("cut", ["mid_frame", "mid_header"])
def test_truncated_file_raises(tmp_path, cut):
    w, h = 32, 16
    frames = random_i420(8, w, h, 4)
    path = str(tmp_path / "t.avi")
    write_i420_avi(path, frames, w, h)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - (100 if cut == "mid_frame" else 768 + 4))
    with pytest.raises(rawavi.Malformed, match="truncated"):
        rawavi.probe(path)
    # Once rawavi has taken the file, nothing retries through cv2.
    with pytest.raises(rawavi.Malformed):
        decode.VideoReader(path)


def test_wrong_frame_chunk_size_raises(tmp_path):
    w, h = 32, 16
    frames = random_i420(9, w, h, 2)
    movi = b"00dc" + struct.pack("<I", 10) + b"\0" * 10
    path = str(tmp_path / "s.avi")
    build_avi(path, frames, w, h, movi_items=movi)
    with pytest.raises(rawavi.Malformed, match="holds 10 bytes"):
        rawavi.probe(path)


def test_writer_round_trips_through_cv2_and_rawavi(tmp_path):
    w, h = 64, 48
    frames = random_i420(10, w, h, 5)
    bgr = np.random.default_rng(11).integers(0, 256, (h, w, 3), np.uint8)
    path = str(tmp_path / "out.avi")
    with encode.VideoWriter(path, 10, w, h) as out:
        assert out.codec == "I420"
        for f in frames:
            out.write_i420(packed(f, w, h))
        out.write(bgr)
    reader = rawavi.RawAviReader(path)
    try:
        assert reader.frame_count == 6
        for k, f in enumerate(frames):
            np.testing.assert_array_equal(reader.read(k), packed(f, w, h))
        np.testing.assert_array_equal(reader.read(5), rawavi.bgr_to_i420(bgr))
    finally:
        reader.close()
    want = cv2_frames(path)
    assert len(want) == 6
    for k, f in enumerate(frames):
        np.testing.assert_array_equal(want[k], native.i420_to_bgr_host(packed(f, w, h)))


def test_bgr_to_i420_against_cv2():
    """Luma equal to cv2's; chroma within 1 of the mean of cv2's chroma of
    the block's four pixels (each pixel brought to a block's top-left
    corner by a shift, where cv2 reads it)."""
    h, w = 48, 64
    bgr = np.random.default_rng(12).integers(0, 256, (h, w, 3), np.uint8)
    got = rawavi.bgr_to_i420(bgr)
    ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
    np.testing.assert_array_equal(got[:h], ref[:h])
    mean = np.zeros((h * w // 2,))
    for dy in (0, 1):
        for dx in (0, 1):
            shifted = np.pad(bgr, ((0, dy), (0, dx), (0, 0)), mode="edge")[dy:, dx:]
            mean += cv2.cvtColor(np.ascontiguousarray(shifted), cv2.COLOR_BGR2YUV_I420)[h:].ravel()
    assert np.abs(got[h:].ravel().astype(float) - mean / 4).max() <= 1.0
    # Flat 2x2 blocks: equal to cv2, chroma included.
    flat = np.repeat(np.repeat(bgr[::2, ::2], 2, 0), 2, 1)
    np.testing.assert_array_equal(rawavi.bgr_to_i420(flat),
                                  cv2.cvtColor(flat, cv2.COLOR_BGR2YUV_I420))


def test_writer_refuses_4gib(tmp_path, monkeypatch):
    """RIFF sizes are 32-bit: a frame that would take the file past them
    is refused, not wrapped (the limit shrunk to a few frames here)."""
    w, h = 32, 16
    fb = w * h * 3 // 2
    monkeypatch.setattr(rawavi, "_RIFF_MAX", 400 + 3 * (8 + fb + 16))
    out = rawavi.RawAviWriter(str(tmp_path / "big.avi"), 10, w, h)
    frame = np.zeros((h * 3 // 2, w), np.uint8)
    written = 0
    with pytest.raises(IOError, match="4 GiB"):
        for _ in range(10):
            out.write_i420(frame)
            written += 1
    out.close()
    assert 1 <= written < 10
    assert rawavi.RawAviReader(str(tmp_path / "big.avi")).frame_count == written


def test_writer_empty_output_check(tmp_path):
    """``__exit__`` raises when the encoder left no output (here: the file
    was removed under it), the reference's empty-output check."""
    path = str(tmp_path / "e.avi")
    with pytest.raises(IOError, match="empty output"):
        with encode.VideoWriter(path, 10, 64, 48):
            os.remove(path)


@pytest.mark.parametrize("flagged", [False, True])
@pytest.mark.parametrize("rgb", [False, True])
def test_annotate_frame_equals_jax(flagged, rgb):
    base = np.random.default_rng(13).integers(0, 256, (120, 160, 3), np.uint8)
    a, b = base.copy(), base.copy()
    joverlay.annotate_frame(a, (30.7, 40.2, 90.9, 100.1), flagged=flagged, frame_index=17, rgb=rgb)
    overlay.annotate_frame(b, (30.7, 40.2, 90.9, 100.1), flagged=flagged, frame_index=17, rgb=rgb)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, base)


@pytest.mark.parametrize("box", [
    (2, 2, 8, 7),         # interior
    (-3, -3, 5, 5),       # clipped top-left
    (8, 8, 30, 30),       # clipped bottom-right
    (0, 0, 13, 11),       # on the frame's edges
    (-1, 5, 14, 6),       # wider than the frame, one row high
])
def test_draw_rect_equals_jax_numpy(box):
    base = np.random.default_rng(14).integers(0, 256, (12, 14, 3), dtype=np.uint8)
    a, b = base.copy(), base.copy()
    saved = jnative._ext
    jnative._ext = None  # the JAX package's numpy version
    try:
        jnative.draw_rect(a, *box, color_bgr=(10, 200, 30), thickness=2)
    finally:
        jnative._ext = saved
    native.draw_rect(b, *box, color_bgr=(10, 200, 30), thickness=2)
    np.testing.assert_array_equal(a, b)


def test_without_cv2(tmp_path, monkeypatch):
    """Without cv2 and without the native libav reader and writer: boxes
    come from ``draw_rect`` and carry no text, landmarks and other
    containers raise, I420 AVI still reads and writes.  (Where the libav
    headers let them be built, the native reader and writer take mp4
    without cv2: ``tests/test_torch_native.py``.)"""
    for mod in (overlay, decode, encode):
        monkeypatch.setattr(mod, "cv2", None)
    monkeypatch.setattr(videodec, "available", lambda: False)
    monkeypatch.setattr(videoenc, "available", lambda: False)
    frame = np.zeros((40, 50, 3), np.uint8)
    overlay.annotate_frame(frame, (5, 6, 20, 30), flagged=True, frame_index=3)
    want = np.zeros_like(frame)
    native.draw_rect(want, 5, 6, 20, 30, overlay.RED, thickness=2)
    np.testing.assert_array_equal(frame, want)
    with pytest.raises(ImportError, match="cv2"):
        overlay.draw_landmarks(frame, np.array([[1.0, 2.0]]))
    with pytest.raises(IOError, match="needs cv2"):
        encode.VideoWriter(str(tmp_path / "o.mp4"), 10, 64, 48)
    mp4 = str(tmp_path / "x.mp4")
    with open(mp4, "wb") as f:
        f.write(b"\0\0\0\x18ftypmp42" + b"\0" * 64)
    with pytest.raises(IOError, match="needs cv2"):
        decode.VideoReader(mp4)
    w, h = 32, 16
    path = str(tmp_path / "ok.avi")
    write_i420_avi(path, random_i420(15, w, h, 2), w, h)
    with decode.VideoReader(path, yuv=True) as r:
        assert r.yuv_active and r.meta.frame_count == 2


def test_draw_landmarks_equals_jax():
    pts = np.array([[10.0, 10.0], [59.0, 49.0], [-5.0, 5.0], [100.0, 100.0]])
    a, b = np.zeros((50, 60, 3), np.uint8), np.zeros((50, 60, 3), np.uint8)
    joverlay.draw_landmarks(a, pts)
    overlay.draw_landmarks(b, pts)
    np.testing.assert_array_equal(a, b)
    assert b[10, 10].any() and b[49, 59].any()


def segments_of(reader, interval, batch):
    return [(s.frame_indices, s.sampled_indices, s.n_valid, s.n_frames, s) for s in
            reader.segments(interval, batch)]


def tail_merged(ref):
    """The JAX reader's segments with a last one that holds no sampled frame
    merged into the one before: the port's reader gives such frames to the
    last segment rather than a device step of their own."""
    if len(ref) < 2 or ref[-1][2]:
        return ref
    (fi, si, nv, nf, seg), (tfi, _, _, tnf, tail) = ref[-2], ref[-1]
    seg.frames = seg.frames + tail.frames
    return ref[:-2] + [(fi + tfi, si, nv, nf + tnf, seg)]


@pytest.mark.parametrize("interval,batch,n,tail", [
    (1, 4, 13, False), (2, 3, 13, False), (3, 4, 13, False), (5, 2, 13, False),
    (16, 4, 13, False),
    (2, 3, 12, True), (3, 5, 14, True),   # frames after a full last batch
])
def test_segments_equal_the_jax_reader(tmp_path, interval, batch, n, tail):
    """Indices, valid rows, frame counts and pixels of every segment equal
    the JAX reader's (cv2 BGR), in YUV mode with and without host frames
    and in BGR mode; a JAX segment without a sampled frame is merged into
    the one before."""
    w, h = 32, 16
    frames = random_i420(16, w, h, n)
    path = str(tmp_path / "s.avi")
    write_i420_avi(path, frames, w, h)
    with jdecode.VideoReader(path) as jr:
        ref = segments_of(jr, interval, batch)
    assert (ref[-1][2] == 0) == tail
    ref = tail_merged(ref)
    assert all(x[2] for x in ref)
    for kw in (dict(yuv=True), dict(yuv=True, host_frames=True), dict(yuv=False)):
        with decode.VideoReader(path, **kw) as r:
            got = segments_of(r, interval, batch)
        assert [g[:4] for g in got] == [x[:4] for x in ref], kw
        for (*_, g), (*_, x) in zip(got, ref):
            if r.yuv_active:
                bgr = np.stack([native.i420_to_bgr_host(p) for p in g.sampled])
                np.testing.assert_array_equal(bgr[: g.n_valid], x.sampled[: x.n_valid])
                assert not g.sampled[g.n_valid:].any()
                if kw.get("host_frames"):
                    assert g.frames_i420
                    np.testing.assert_array_equal(
                        np.stack([native.i420_to_bgr_host(p) for p in g.frames]),
                        np.stack(x.frames))
                else:
                    assert g.frames == []
            else:
                np.testing.assert_array_equal(g.sampled, x.sampled)
                np.testing.assert_array_equal(np.stack(g.frames), np.stack(x.frames))


def test_abandoned_segments_generator_stops_producer(tmp_path):
    """Closing ``segments()`` early stops the prefetch producer promptly, and
    ``close()`` then releases the file; the reader still serves a fresh
    pass."""
    w, h = 32, 16
    path = str(tmp_path / "long.avi")
    write_i420_avi(path, random_i420(17, w, h, 120), w, h)
    reader = decode.VideoReader(path, yuv=True)
    gen = reader.segments(1, 4)   # 30 segments; the queue holds 2
    next(gen)
    t = reader._active_thread
    gen.close()
    t.join(timeout=5)
    assert not t.is_alive() and reader._active_thread is None
    segs = list(reader.segments(1, 8))
    assert sum(s.n_valid for s in segs) == 120
    fd = reader._avi._fd
    reader.close()
    assert reader._avi is None
    with pytest.raises(OSError):
        os.fstat(fd)
