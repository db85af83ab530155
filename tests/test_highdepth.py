"""Sample-type generality: >8-bit, signed, and big-endian samples.

The reference handles arbitrary sample types through the templated
IOManager<T, Y> (IO/IOManager.ipp:72-138) with bps/endianess/signed
carried in the codestream header (BitStreamBuilder.cpp:70-84)."""

import numpy as np
import pytest

from picsong_tpu.core.header import CodecConfig, pack_header, unpack_header
from picsong_tpu.core.image_io import (append_raw_frame, read_pgm,
                                       read_raw_frame, sample_dtype,
                                       write_pgm)
from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle

PARAMS = LUTParams()


def make_image(rng, h, w, lo, hi, dtype):
    y, x = np.mgrid[0:h, 0:w]
    span = hi - lo
    base = (lo + span / 2 + span / 3 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, span / 64, size=(h, w)))
    return np.clip(base, lo, hi).astype(dtype)


def test_sample_dtype_mapping():
    assert sample_dtype(8) == np.uint8
    assert sample_dtype(8, is_signed=True) == np.int8
    assert sample_dtype(12) == np.dtype("<u2")
    assert sample_dtype(16, endianess=1) == np.dtype(">u2")
    assert sample_dtype(16, endianess=0, is_signed=True) == np.dtype("<i2")
    with pytest.raises(ValueError):
        sample_dtype(32)


def test_header_carries_sample_fields():
    cfg = CodecConfig(width=64, height=64, bit_depth=12, bps=12, endianess=1,
                      is_signed=False)
    cfg2 = unpack_header(pack_header(cfg))
    assert (cfg2.bit_depth, cfg2.bps, cfg2.endianess, cfg2.is_signed) == \
        (12, 12, 1, False)


@pytest.mark.parametrize("bps", [12, 16])
def test_highdepth_lossless_matches_oracle(bps):
    rng = np.random.default_rng(bps)
    img = make_image(rng, 64, 64, 0, (1 << bps) - 1, np.uint16)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, bit_depth=bps,
                      bps=bps)
    lut = neutral_lut(PARAMS, 1, 2)
    want = oracle.encode_image(img, cfg, [lut], PARAMS)
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0])
    out = codec.decode(got)
    assert out.dtype == np.uint16
    assert np.array_equal(out, img)
    cross = oracle.decode_image(got, cfg, [lut], PARAMS)
    assert np.array_equal(cross, img)


def test_signed_16bit_roundtrip():
    rng = np.random.default_rng(7)
    img = make_image(rng, 64, 64, -20000, 20000, np.int16)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, bit_depth=16,
                      bps=16, is_signed=True)
    lut = neutral_lut(PARAMS, 1, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    out = codec.decode(got)
    assert out.dtype == np.int16
    assert np.array_equal(out, img)


def test_highdepth_lossy_quality():
    rng = np.random.default_rng(9)
    img = make_image(rng, 64, 64, 0, 4095, np.uint16)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, bit_depth=12,
                      bps=12, is_lossy=True, qs=1.0)
    lut = neutral_lut(PARAMS, 2, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)
    out = codec.decode(codec.encode(img))
    err = out.astype(np.float64) - img.astype(np.float64)
    psnr = 10 * np.log10(4095.0 ** 2 / max(float(np.mean(err * err)), 1e-12))
    assert psnr > 40.0, f"PSNR {psnr:.2f}"


def test_bigendian_raw_io(tmp_path):
    rng = np.random.default_rng(3)
    img = make_image(rng, 32, 48, 0, 65535, np.uint16)
    path = str(tmp_path / "f.raw")
    dt = sample_dtype(16, endianess=1)
    append_raw_frame(path, img, dt)
    with open(path, "rb") as f:
        raw = f.read()
    # expectation via array astype (scalar .astype does not byteswap)
    assert raw[:2] == img[:1, :1].astype(">u2").tobytes()  # big-endian bytes
    back = read_raw_frame(path, 48, 32, 0, dt)
    assert back.dtype.byteorder in ("=", "<", "|")        # native on return
    assert np.array_equal(back, img)


def test_16bit_pgm_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    img = make_image(rng, 32, 32, 0, 4095, np.uint16)
    path = str(tmp_path / "x.pgm")
    write_pgm(path, img, bit_depth=12)
    back = read_pgm(path)
    assert back.dtype == np.uint16
    assert np.array_equal(back, img)


def test_highdepth_video_roundtrip(tmp_path):
    from picsong_tpu.engine.video import decode_video, encode_video
    rng = np.random.default_rng(11)
    frames = [make_image(rng, 64, 64, 0, 4095, np.uint16) for _ in range(3)]
    raw = str(tmp_path / "v.raw")
    dt = sample_dtype(12)
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.astype(dt).tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=3,
                      bit_depth=12, bps=12)
    lut = neutral_lut(PARAMS, 1, 2)
    enc = str(tmp_path / "v.enc")
    dec = str(tmp_path / "v_dec.raw")
    encode_video(raw, enc, cfg, [lut], PARAMS, frames=3, batch=2)
    decode_video(enc, dec, cfg, [lut], PARAMS, batch=2)
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 64, 64, i, dt), fr)
