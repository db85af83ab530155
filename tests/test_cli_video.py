"""CLI and video engine round trips (image + frame-sequence paths)."""

import numpy as np
import pytest

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.image_io import read_pgm, read_raw_frame, write_pgm
from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu.engine.cli import main
from picsong_tpu.engine.video import decode_video, encode_video

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def test_cli_image_roundtrip_pgm(tmp_path):
    rng = np.random.default_rng(0)
    img = make_image(rng, 64, 64)
    src = str(tmp_path / "in.pgm")
    enc = str(tmp_path / "out.enc")
    dec = str(tmp_path / "out.pgm")
    write_pgm(src, img)
    assert main(["-cd", "0", "-i", src, "-o", enc, "-wl", "1", "-cp", "2",
                 "-type", "0", "-video", "0", "-LUTFolder", "neutral"]) == 0
    assert main(["-cd", "1", "-i", enc, "-o", dec, "-video", "0",
                 "-LUTFolder", "neutral"]) == 0
    assert np.array_equal(read_pgm(dec), img)


def test_cli_validation_rejects_bad_params(tmp_path):
    assert main(["-cd", "0", "-i", "x.raw", "-o", "y.enc", "-wl", "0",
                 "-xSize", "64", "-ySize", "64"]) == 1
    assert main(["-cd", "0", "-i", "x.raw", "-o", "y.enc", "-cbWidth", "63",
                 "-xSize", "64", "-ySize", "64"]) == 1
    assert main(["-cd", "5"]) == 1


def test_video_roundtrip_gray(tmp_path):
    rng = np.random.default_rng(1)
    frames = [make_image(rng, 64, 128) for _ in range(4)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=4)
    lut = neutral_lut(PARAMS, 1, 2)
    st = encode_video(raw, enc, cfg, [lut], PARAMS, frames=4)
    assert st.frames == 4
    st = decode_video(enc, dec, cfg, [lut], PARAMS)
    assert st.frames == 4
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 128, 64, i), fr)


def test_video_roundtrip_rgb(tmp_path):
    rng = np.random.default_rng(2)
    n_frames = 2
    planes = [[make_image(rng, 64, 64) for _ in range(3)]
              for _ in range(n_frames)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for frame in planes:
            for p in frame:
                f.write(p.tobytes())
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=n_frames,
                      is_rgb=True, components=3)
    lut = neutral_lut(PARAMS, 1, 2)
    encode_video(raw, enc, cfg, [lut] * 3, PARAMS, frames=n_frames)
    decode_video(enc, dec, cfg, [lut] * 3, PARAMS)
    for i, frame in enumerate(planes):
        for c, p in enumerate(frame):
            assert np.array_equal(read_raw_frame(dec, 64, 64, i * 3 + c), p)


def test_batched_video_streams_match_perframe(tmp_path):
    """The batched encoder must emit the same file bytes as the per-frame
    engine (frame batching changes dispatch shape, not the codestream)."""
    rng = np.random.default_rng(3)
    frames = [make_image(rng, 64, 128) for _ in range(5)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=5)
    lut = neutral_lut(PARAMS, 1, 2)
    enc_b = str(tmp_path / "b.enc")
    enc_p = str(tmp_path / "p.enc")
    st = encode_video(raw, enc_b, cfg, [lut], PARAMS, frames=5, batch=2)
    assert st.batches == 3          # 2+2+1(padded tail)
    encode_video(raw, enc_p, cfg, [lut], PARAMS, frames=5, batch=1)
    with open(enc_b, "rb") as f:
        got = f.read()
    with open(enc_p, "rb") as f:
        want = f.read()
    assert got == want


def test_batched_video_overflow_retry(tmp_path):
    """A first frame much tamer than later frames undercuts the video-wide
    bitplane bound; the writer must detect it (check_planes_bound) and
    re-encode with the corrected bound — round trip stays bit-exact."""
    rng = np.random.default_rng(4)
    tame = np.full((64, 64), 128, np.uint8)          # near-zero coefficients
    wild = (rng.integers(0, 2, size=(64, 64)) * 255).astype(np.uint8)
    frames = [tame, tame, wild, wild]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=4)
    lut = neutral_lut(PARAMS, 1, 2)
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    import picsong_tpu.engine.video as video_mod
    orig = video_mod.host_plane_bound
    # force an undercut bound (margin 0 from the flat first frame)
    video_mod.host_plane_bound = (
        lambda cfg, px, aw, ah, extra_margin=0: orig(cfg, px, aw, ah, 0))
    try:
        st = encode_video(raw, enc, cfg, [lut], PARAMS, frames=4, batch=2)
    finally:
        video_mod.host_plane_bound = orig
    assert st.n_planes >= 8          # retry raised the bound
    decode_video(enc, dec, cfg, [lut], PARAMS, batch=2)
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 64, 64, i), fr)


def test_batched_video_lossy(tmp_path):
    rng = np.random.default_rng(5)
    frames = [make_image(rng, 64, 64) for _ in range(3)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, frames=3,
                      is_lossy=True, qs=1.0)
    lut = neutral_lut(PARAMS, 2, 2)
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    encode_video(raw, enc, cfg, [lut], PARAMS, frames=3, batch=2)
    decode_video(enc, dec, cfg, [lut], PARAMS, batch=2)
    for i, fr in enumerate(frames):
        out = read_raw_frame(dec, 64, 64, i)
        err = out.astype(np.float64) - fr.astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / max(float(np.mean(err * err)), 1e-12))
        assert psnr > 40.0, f"frame {i}: PSNR {psnr:.2f}"


def test_sharded_video_matches_single_device(tmp_path):
    """Frame-DP video over the mesh (devices=4) must emit bytes identical
    to the single-device batched engine, from the product encode_video
    surface (BASELINE config 4)."""
    rng = np.random.default_rng(7)
    frames = [make_image(rng, 64, 128) for _ in range(8)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=8)
    lut = neutral_lut(PARAMS, 1, 2)
    enc1 = str(tmp_path / "single.enc")
    encN = str(tmp_path / "sharded.enc")
    dec = str(tmp_path / "v_dec.raw")
    encode_video(raw, enc1, cfg, [lut], PARAMS, frames=8, batch=4)
    st = encode_video(raw, encN, cfg, [lut], PARAMS, frames=8, batch=4,
                      devices=4)
    assert st.frames == 8
    with open(enc1, "rb") as f:
        want = f.read()
    with open(encN, "rb") as f:
        got = f.read()
    assert got == want
    decode_video(encN, dec, cfg, [lut], PARAMS, batch=4, devices=4)
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 128, 64, i), fr)


def test_sharded_video_reencode_dispatch_is_serialized(tmp_path, monkeypatch):
    """Noise overflows the dense-pack bucket, so the downloader thread
    re-encodes while the compute loop dispatches the next batch. On a mesh
    both dispatch collective-bearing programs, so they must never overlap
    (overlapping launches can reach the devices in different orders and
    deadlock the collectives); the bytes still equal one device's."""
    import threading
    import time
    from picsong_tpu.engine.batch import BatchCodec

    rng = np.random.default_rng(9)
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        f.write(rng.integers(0, 256, size=(8, 64, 64), dtype=np.uint8)
                .tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=8)
    lut = neutral_lut(PARAMS, 1, 2)
    orig = BatchCodec.encode_batch_packed
    state = {"active": 0, "peak": 0, "threads": set()}
    guard = threading.Lock()

    def spy(self, *args, **kwargs):
        with guard:
            state["active"] += 1
            state["peak"] = max(state["peak"], state["active"])
            state["threads"].add(threading.current_thread().name)
        time.sleep(0.05)               # widen any overlap window
        try:
            return orig(self, *args, **kwargs)
        finally:
            with guard:
                state["active"] -= 1

    enc1, encN = str(tmp_path / "single.enc"), str(tmp_path / "sharded.enc")
    encode_video(raw, enc1, cfg, [lut], PARAMS, frames=8, batch=4)
    monkeypatch.setattr(BatchCodec, "encode_batch_packed", spy)
    encode_video(raw, encN, cfg, [lut], PARAMS, frames=8, batch=4, devices=4)
    assert len(state["threads"]) == 2        # the downloader did re-encode
    assert state["peak"] == 1
    with open(enc1, "rb") as f1, open(encN, "rb") as fN:
        assert f1.read() == fN.read()


def test_cli_sharded_video_roundtrip(tmp_path):
    """-video 1 -sharded N end-to-end through the CLI."""
    rng = np.random.default_rng(8)
    frames = [make_image(rng, 64, 64) for _ in range(4)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    assert main(["-cd", "0", "-i", raw, "-o", enc, "-wl", "1", "-video", "1",
                 "-frames", "4", "-xSize", "64", "-ySize", "64",
                 "-numberOfStreams", "2", "-sharded", "2",
                 "-LUTFolder", "neutral"]) == 0
    assert main(["-cd", "1", "-i", enc, "-o", dec, "-video", "1",
                 "-numberOfStreams", "2", "-sharded", "2",
                 "-LUTFolder", "neutral"]) == 0
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 64, 64, i), fr)


def test_video_reader_error_fails_fast(tmp_path):
    """A truncated input must raise promptly instead of deadlocking the
    compute loop on a dead reader thread."""
    import pytest
    rng = np.random.default_rng(9)
    frames = [make_image(rng, 64, 64) for _ in range(2)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
        f.write(b"\x00" * 100)          # frame 2 is truncated
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=4)
    lut = neutral_lut(PARAMS, 1, 2)
    enc = str(tmp_path / "v.enc")
    with pytest.raises(Exception):
        encode_video(raw, enc, cfg, [lut], PARAMS, frames=4, batch=1)


@pytest.mark.parametrize("bpc_mode", ["staged", "fused"])
def test_video_bpc_modes_byte_identical(tmp_path, monkeypatch, bpc_mode):
    """PICSONG_VIDEO_BPC={staged,fused} must emit identical file bytes,
    so neither coder can regress silently."""
    monkeypatch.setenv("PICSONG_VIDEO_BPC", bpc_mode)
    monkeypatch.setenv("PICSONG_VIDEO_PACK", "off")
    rng = np.random.default_rng(10)           # same content for both params
    frames = [make_image(rng, 64, 64) for _ in range(4)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, frames=4)
    lut = neutral_lut(PARAMS, 2, 2)
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    encode_video(raw, enc, cfg, [lut], PARAMS, frames=4, batch=2)
    monkeypatch.setenv("PICSONG_VIDEO_PACK", "on")
    monkeypatch.setenv("PICSONG_VIDEO_BPC", "staged")
    ref = str(tmp_path / "ref.enc")
    encode_video(raw, ref, cfg, [lut], PARAMS, frames=4, batch=2)
    with open(enc, "rb") as f:
        got = f.read()
    with open(ref, "rb") as f:
        want = f.read()
    assert got == want
    monkeypatch.setenv("PICSONG_VIDEO_BPC", bpc_mode)
    monkeypatch.setenv("PICSONG_VIDEO_PACK", "off")
    decode_video(enc, dec, cfg, [lut], PARAMS, batch=2)
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 64, 64, i), fr)


def test_cli_sharded_image_roundtrip(tmp_path):
    """-sharded N routes single-image coding through ShardedCodec; the
    file bytes must match the unsharded path."""
    rng = np.random.default_rng(6)
    img = make_image(rng, 128, 64)
    src = str(tmp_path / "in.pgm")
    write_pgm(src, img)
    enc1 = str(tmp_path / "a.enc")
    enc2 = str(tmp_path / "b.enc")
    dec = str(tmp_path / "out.pgm")
    base = ["-cd", "0", "-i", src, "-wl", "1", "-cp", "2", "-type", "0",
            "-video", "0", "-LUTFolder", "neutral"]
    assert main(base + ["-o", enc1]) == 0
    assert main(base + ["-o", enc2, "-sharded", "2"]) == 0
    with open(enc1, "rb") as f:
        a = f.read()
    with open(enc2, "rb") as f:
        b = f.read()
    assert a == b
    assert main(["-cd", "1", "-i", enc2, "-o", dec, "-video", "0",
                 "-LUTFolder", "neutral", "-sharded", "2"]) == 0
    assert np.array_equal(read_pgm(dec), img)
