"""Distributed gates on an 8-device CPU mesh: sharded pipelines produce
bit-identical codestreams to the single-device engine."""

import jax
import numpy as np
import pytest

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu.dist.sharded import FrameParallelCodec, ShardedCodec, make_mesh
from picsong_tpu.engine.pipeline import TPUCodec

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_image_matches_single_device():
    mesh = make_mesh(4)
    rng = np.random.default_rng(0)
    img = make_image(rng, 256, 128)          # 4 codeblock-rows over 4 devices
    cfg = CodecConfig(width=128, height=256, wavelet_levels=2)
    lut = neutral_lut(PARAMS, 2, 2)
    single = TPUCodec(cfg, [lut], PARAMS)
    want = single.encode(img)[0]
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    got = sharded.encode(img)[0]
    assert np.array_equal(got, want)


def test_sharded_mono_path_matches_single_device(monkeypatch):
    """PICSONG_SHARDED_BPC=mono keeps the single-program coder wired as
    the alternative multi-chip formulation; it must emit the same bytes
    as the (default) staged path and the single-device engine."""
    monkeypatch.setenv("PICSONG_SHARDED_BPC", "mono")
    mesh = make_mesh(4)
    rng = np.random.default_rng(7)
    img = make_image(rng, 256, 128)
    cfg = CodecConfig(width=128, height=256, wavelet_levels=2)
    lut = neutral_lut(PARAMS, 2, 2)
    want = TPUCodec(cfg, [lut], PARAMS).encode(img)[0]
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    got = sharded.encode(img)[0]
    assert np.array_equal(got, want)
    assert np.array_equal(sharded.decode([got]), img)


def test_sharded_unknown_coder_mode_raises(monkeypatch):
    """PICSONG_SHARDED_BPC goes through the same validated selector as the
    single-device coder: an unknown name raises instead of running staged."""
    monkeypatch.setenv("PICSONG_SHARDED_BPC", "pallas")
    cfg = CodecConfig(width=64, height=128, wavelet_levels=1)
    sharded = ShardedCodec(cfg, [neutral_lut(PARAMS, 1, 2)], PARAMS,
                           make_mesh(2))
    img = make_image(np.random.default_rng(8), 128, 64)
    with pytest.raises(ValueError, match="PICSONG_SHARDED_BPC"):
        sharded.encode(img)


def test_sharded_decode_roundtrip():
    mesh = make_mesh(2)
    rng = np.random.default_rng(1)
    img = make_image(rng, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    offset = 1 << 7
    from picsong_tpu.core.image_io import mirror_pad
    plane = mirror_pad(img, *(128, 128)[::-1] if False else (128, 128)).astype(np.int32) - offset
    streams, sizes = sharded.encode_plane(plane)
    back = sharded.decode_plane(streams, sizes)
    assert np.array_equal(back, plane)


def test_frame_parallel_matches_single_device():
    mesh = make_mesh(8)
    rng = np.random.default_rng(2)
    frames = np.stack([make_image(rng, 64, 128) for _ in range(8)])
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    fp = FrameParallelCodec(cfg, [lut], PARAMS, mesh)
    streams, sizes = fp.encode_batch(frames)
    single = TPUCodec(cfg, [lut], PARAMS)
    from picsong_tpu.assembly.pack import pack_streams
    from picsong_tpu.core.header import pack_header
    for i in range(8):
        want = single.encode(frames[i])[0]
        got = pack_streams(streams[i], sizes[i], pack_header(cfg))
        assert np.array_equal(got, want), f"frame {i} codestream differs"
    out = fp.decode_batch(streams, sizes)
    assert np.array_equal(out, frames)


def test_frame_parallel_uneven_content():
    mesh = make_mesh(4)
    rng = np.random.default_rng(3)
    frames = np.stack([
        np.zeros((64, 64), np.uint8),
        np.full((64, 64), 255, np.uint8),
        make_image(rng, 64, 64),
        rng.integers(0, 256, size=(64, 64)).astype(np.uint8),
    ])
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    fp = FrameParallelCodec(cfg, [lut], PARAMS, mesh)
    streams, sizes = fp.encode_batch(frames)
    out = fp.decode_batch(streams, sizes)
    assert np.array_equal(out, frames)


def test_sharded_rgb_lossless_full_codestream():
    """ShardedCodec RGB file-level round trip, bit-identical streams to the
    single-device engine."""
    mesh = make_mesh(2)
    rng = np.random.default_rng(4)
    planes = [make_image(rng, 128, 64) for _ in range(3)]
    cfg = CodecConfig(width=64, height=128, wavelet_levels=1, is_rgb=True,
                      components=3)
    lut = neutral_lut(PARAMS, 1, 2)
    sharded = ShardedCodec(cfg, [lut] * 3, PARAMS, mesh)
    got = sharded.encode(planes)
    single = TPUCodec(cfg, [lut] * 3, PARAMS)
    want = single.encode(planes)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    out = sharded.decode(got)
    for p, orig in zip(out, planes):
        assert np.array_equal(p, orig)


def test_sharded_lossy_roundtrip():
    mesh = make_mesh(2)
    rng = np.random.default_rng(5)
    img = make_image(rng, 128, 64)
    cfg = CodecConfig(width=64, height=128, wavelet_levels=2, is_lossy=True,
                      qs=1.0)
    lut = neutral_lut(PARAMS, 2, 2)
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    streams = sharded.encode(img)
    out = sharded.decode(streams)
    err = out.astype(np.float64) - img.astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / max(float(np.mean(err * err)), 1e-12))
    assert psnr > 40.0, f"PSNR {psnr:.2f}"


@pytest.mark.parametrize("bps,signed", [(12, False), (16, False), (16, True)])
def test_sharded_highdepth_matches_single(bps, signed):
    """ShardedCodec must honor the sample type (>8-bit / signed) exactly
    like TPUCodec, never truncating to uint8."""
    mesh = make_mesh(2)
    rng = np.random.default_rng(20 + bps + signed)
    if signed:
        lo, hi, dtype = -(1 << (bps - 1)), (1 << (bps - 1)) - 1, np.int16
    else:
        lo, hi, dtype = 0, (1 << bps) - 1, np.uint16
    # compressible content: full-range noise would push codeblocks into the
    # raw expansion fallback, which stores only the low 16 coefficient bits
    # (BPCEngine.cu:1915-1922) and is inherently lossy for >15-bit samples
    span = hi - lo
    y, x = np.mgrid[0:128, 0:64]
    img = np.clip(lo + span / 2 + span / 3 * np.sin(x / 9.0) * np.cos(y / 13.0)
                  + rng.normal(0, span / 64, size=(128, 64)),
                  lo, hi).astype(dtype)
    cfg = CodecConfig(width=64, height=128, wavelet_levels=1, bit_depth=bps,
                      bps=bps, is_signed=signed)
    lut = neutral_lut(PARAMS, 1, 2)
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    single = TPUCodec(cfg, [lut], PARAMS)
    got, want = sharded.encode(img), single.encode(img)
    assert np.array_equal(got[0], want[0])
    out = sharded.decode(got)
    assert out.dtype == dtype
    assert np.array_equal(out, img)


def test_sharded_lossy_matches_single_device_bytes():
    """Sharded lossy 9/7 must emit the same codestream bytes as the
    single-device engine (and hence the oracle, which gates TPUCodec)."""
    mesh = make_mesh(2)
    rng = np.random.default_rng(21)
    img = make_image(rng, 128, 64)
    cfg = CodecConfig(width=64, height=128, wavelet_levels=2, is_lossy=True,
                      qs=1.0)
    lut = neutral_lut(PARAMS, 2, 2)
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    single = TPUCodec(cfg, [lut], PARAMS)
    got, want = sharded.encode(img), single.encode(img)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(sharded.decode(got), single.decode(want))


def test_sharded_uneven_rows_match_single():
    """A 1080p-class adapted height (1088 = 17 codeblock rows) must
    row-shard over 8 devices — 17 is not a multiple of 8, so GSPMD pads
    the shards internally — with codestream bytes identical to the
    single-device engine."""
    mesh = make_mesh(8)
    rng = np.random.default_rng(22)
    img = make_image(rng, 1080, 128)          # adapted height 1088
    cfg = CodecConfig(width=128, height=1080, wavelet_levels=2)
    lut = neutral_lut(PARAMS, 2, 2)
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    single = TPUCodec(cfg, [lut], PARAMS)
    got, want = sharded.encode(img), single.encode(img)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(sharded.decode(got), img)


def test_sharded_gray_full_codestream_matches_single():
    mesh = make_mesh(4)
    rng = np.random.default_rng(6)
    img = make_image(rng, 256, 64)
    cfg = CodecConfig(width=64, height=256, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    sharded = ShardedCodec(cfg, [lut], PARAMS, mesh)
    single = TPUCodec(cfg, [lut], PARAMS)
    got, want = sharded.encode(img), single.encode(img)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(sharded.decode(got), img)
