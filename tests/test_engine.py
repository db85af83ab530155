"""Engine gates: JAX pipeline streams match the oracle bit-for-bit and the
vectorized pack matches the oracle pack."""

import numpy as np
import pytest

from picsong_tpu.assembly.pack import pack_streams, unpack_streams
from picsong_tpu.core.header import CodecConfig, unpack_header
from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu.engine.pipeline import TPUCodec
from picsong_tpu.reference import codec as oracle

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def test_vectorized_pack_matches_oracle():
    rng = np.random.default_rng(0)
    ncb = 7
    streams = np.full((ncb, 4096), -1, dtype=np.int32)
    sizes = np.zeros(ncb, dtype=np.int64)
    for i in range(ncb):
        n = int(rng.integers(1, 500))
        streams[i, 0] = int(rng.integers(0, 15))
        streams[i, 1:n] = rng.integers(0, 65536, size=n - 1)
        sizes[i] = n
    from picsong_tpu.core.header import pack_header
    header = pack_header(CodecConfig(width=448, height=64))
    want = oracle.pack_streams(streams, sizes, header)
    got = pack_streams(streams, sizes, header)
    assert np.array_equal(got, want)
    s2, n2 = unpack_streams(got, ncb)
    assert np.array_equal(n2, sizes)
    for i in range(ncb):
        assert np.array_equal(s2[i, :sizes[i]], streams[i, :sizes[i]])


def test_engine_lossless_matches_oracle_streams():
    """The full JAX pipeline emits the same bytes as the NumPy oracle."""
    rng = np.random.default_rng(1)
    img = make_image(rng, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=2)
    lut = neutral_lut(PARAMS, 2, 2)
    want = oracle.encode_image(img, cfg, [lut], PARAMS)
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0], want[0])
    out = codec.decode(got)
    assert np.array_equal(out, img)


def test_engine_lossless_nonmultiple_roundtrip():
    rng = np.random.default_rng(2)
    img = make_image(rng, 90, 130)
    cfg = CodecConfig(width=130, height=90, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)
    streams = codec.encode(img)
    cfg2 = unpack_header(streams[0][:9])
    assert (cfg2.width, cfg2.height) == (130, 90)
    out = TPUCodec(cfg2, [lut], PARAMS).decode(streams)
    assert np.array_equal(out, img)


def test_engine_lossy_psnr():
    rng = np.random.default_rng(3)
    img = make_image(rng, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=3, is_lossy=True,
                      qs=1.0)
    lut = neutral_lut(PARAMS, 3, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)
    out = codec.decode(codec.encode(img))
    err = out.astype(np.float64) - img.astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / max(float(np.mean(err * err)), 1e-12))
    assert psnr > 40.0, f"PSNR {psnr:.2f}"


def test_engine_rgb_lossless_roundtrip():
    rng = np.random.default_rng(4)
    planes = [make_image(rng, 64, 64) for _ in range(3)]
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, is_rgb=True,
                      components=3)
    lut = neutral_lut(PARAMS, 1, 2)
    codec = TPUCodec(cfg, [lut] * 3, PARAMS)
    streams = codec.encode(planes)
    assert len(streams) == 3
    out = codec.decode(streams)
    for got, want in zip(out, planes):
        assert np.array_equal(got, want)


def test_engine_rgb_lossy_quality():
    rng = np.random.default_rng(5)
    planes = [make_image(rng, 64, 64) for _ in range(3)]
    cfg = CodecConfig(width=64, height=64, wavelet_levels=2, is_rgb=True,
                      components=3, is_lossy=True, qs=1.0)
    lut = neutral_lut(PARAMS, 2, 2)
    codec = TPUCodec(cfg, [lut] * 3, PARAMS)
    out = codec.decode(codec.encode(planes))
    for got, want in zip(out, planes):
        err = got.astype(np.float64) - want.astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / max(float(np.mean(err * err)), 1e-12))
        assert psnr > 30.0, f"PSNR {psnr:.2f}"


@pytest.mark.parametrize("mode", ["staged", "mono"])
def test_engine_modes_lossless_bitexact(mode, monkeypatch):
    """Every coder path (staged / monolithic) must emit the oracle's exact
    bytes, so whichever is default cannot silently diverge."""
    monkeypatch.setenv("PICSONG_ENCODER", mode)
    monkeypatch.setenv("PICSONG_DECODER", mode)
    rng = np.random.default_rng(11)
    img = make_image(rng, 64, 128)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    want = oracle.encode_image(img, cfg, [lut], PARAMS)
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0]), f"{mode} stream differs"
    out = codec.decode(got)
    assert np.array_equal(out, img), f"{mode} round trip not bit-exact"


def test_engine_lossy_matches_oracle():
    """BASELINE config 2 semantics: at equal qs the JAX lossy pipeline must
    reconstruct at least as well as the reference decoder (the NumPy oracle
    IS the available reference), and the two coders must agree on each
    other's streams."""
    rng = np.random.default_rng(12)
    img = make_image(rng, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=3, is_lossy=True,
                      qs=1.0)
    lut = neutral_lut(PARAMS, 3, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)

    def psnr(a, b):
        err = a.astype(np.float64) - b.astype(np.float64)
        return 10 * np.log10(255.0 ** 2 / max(float(np.mean(err * err)), 1e-12))

    jax_streams = codec.encode(img)
    oracle_streams = oracle.encode_image(img, cfg, [lut], PARAMS)
    psnr_jax = psnr(codec.decode(jax_streams), img)
    psnr_oracle = psnr(oracle.decode_image(oracle_streams, cfg, [lut],
                                           PARAMS), img)
    assert psnr_jax >= psnr_oracle - 0.05, (
        f"JAX lossy {psnr_jax:.2f} dB < oracle {psnr_oracle:.2f} dB at equal qs")
    # cross-decode: the oracle decoder must accept the JAX stream
    cross = oracle.decode_image(jax_streams, cfg, [lut], PARAMS)
    assert psnr(cross, img) >= psnr_oracle - 0.05


def test_underestimated_plane_bound_fails_loudly():
    """An n_planes bound below the true MSB must raise, not silently emit a
    stream with uncoded high bitplanes (the lossy `max_mag *= 2` margin
    is a host-side guess, so the device-side MSB check must catch it)."""
    from picsong_tpu.entropy import bpc_jax
    rng = np.random.default_rng(7)
    img = make_image(rng, 64, 64)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)
    with pytest.raises(bpc_jax.PlaneOverflowError) as exc:
        codec._encode_attempt(img, n_planes=4)   # true MSB is ~8 here
    assert exc.value.needed > 4


def test_encode_retries_after_plane_overflow(monkeypatch):
    """encode() recovers from an undercut bound by re-encoding with the
    corrected n_planes — the stream must round-trip bit-exact."""
    rng = np.random.default_rng(8)
    img = make_image(rng, 64, 64)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    codec = TPUCodec(cfg, [lut], PARAMS)
    monkeypatch.setattr(TPUCodec, "planes_host", lambda self, pixels: 4)
    streams = codec.encode(img)
    out = codec.decode(streams)
    assert np.array_equal(out, img)


def test_engine_k_factor_roundtrip():
    rng = np.random.default_rng(6)
    img = make_image(rng, 128, 128)
    cfg = CodecConfig(width=128, height=128, wavelet_levels=2, k_factor=2.0)
    lut = neutral_lut(PARAMS, 2, 2, n_groups=PARAMS.n_bitplane_files)
    codec = TPUCodec(cfg, [lut], PARAMS)
    out = codec.decode(codec.encode(img))
    assert np.array_equal(out, img)


def test_engine_k_factor_matches_oracle_streams():
    """The staged bulk (complexity-scalability) path emits the exact
    oracle bytes through the full engine, including the chunked codeblock
    schedule (the 8K-regime shape with k > 0)."""
    rng = np.random.default_rng(41)
    img = make_image(rng, 128, 256)
    cfg = CodecConfig(width=256, height=128, wavelet_levels=2, k_factor=5.0)
    lut = neutral_lut(PARAMS, 2, 2, n_groups=PARAMS.n_bitplane_files)
    want = oracle.encode_image(img, cfg, [lut], PARAMS)
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0])
    chunked = TPUCodec(cfg, [lut], PARAMS, chunk_blocks=3)
    got_c = chunked.encode(img)
    assert np.array_equal(got_c[0], want[0])
    assert np.array_equal(chunked.decode(got_c), img)


def test_chunked_codeblock_batch_matches_unchunked():
    """chunk_blocks splits the staged coder's codeblock batch (the
    HBM-bounding knob for very large planes, BASELINE config 3); bytes and
    round trip must be identical to the unchunked engine, including an
    uneven final chunk."""
    rng = np.random.default_rng(31)
    img = make_image(rng, 128, 1024)         # 2 x 16 = 32 codeblocks
    cfg = CodecConfig(width=1024, height=128, wavelet_levels=2)
    lut = neutral_lut(PARAMS, 2, 2)
    plain = TPUCodec(cfg, [lut], PARAMS)
    chunked = TPUCodec(cfg, [lut], PARAMS, chunk_blocks=12)  # 12+12+8
    want = plain.encode(img)
    got = chunked.encode(img)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(chunked.decode(got), img)


def test_large_geometry_chunked_roundtrip():
    """BASELINE config 3 shape class (8K single image): a 1024x8192 plane
    (2048 codeblocks, wl=5) through the staged coder with an uneven
    chunk split must round-trip bit-exact. The reference's grid scales by
    block count alone (BPCEngine.cu:2307-2424); this exercises the same
    invariant plus the HBM-bounding chunk logic at a >10^7-pixel scale."""
    rng = np.random.default_rng(37)
    img = make_image(rng, 1024, 8192)
    cfg = CodecConfig(width=8192, height=1024, wavelet_levels=5)
    lut = neutral_lut(PARAMS, 5, 2)
    codec = TPUCodec(cfg, [lut], PARAMS, chunk_blocks=900)  # 900+900+248
    streams = codec.encode(img)
    assert np.array_equal(codec.decode(streams), img)


def test_staged_pair_bitexact(monkeypatch):
    """PICSONG_STAGED_PAIR=1 runs SPP+MRP as ONE program per bitplane
    (halves dispatches). Bytes must equal the oracle's and the split schedule's
    exactly; the round trip must be bit-exact."""
    rng = np.random.default_rng(17)
    img = make_image(rng, 64, 128)
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    want = oracle.encode_image(img, cfg, [lut], PARAMS)
    monkeypatch.setenv("PICSONG_STAGED_PAIR", "1")
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0]), "paired-pass stream differs"
    assert np.array_equal(codec.decode(got), img)


@pytest.mark.parametrize("group", [3, 16])
def test_staged_plane_group_bitexact(group, monkeypatch):
    """PICSONG_STAGED_GROUP=G codes G bitplanes (SPP+MRP each) per program
    via a nested fori_loop (entropy/bpc_jax.py pair_group). Bytes must
    equal the split schedule's exactly — including a final partial group
    whose below-zero planes must be no-ops — and the round trip must stay
    bit-exact."""
    from picsong_tpu.entropy import bpc_jax
    rng = np.random.default_rng(19)
    img = make_image(rng, 64, 192)
    cfg = CodecConfig(width=192, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    monkeypatch.setenv("PICSONG_STAGED_PAIR", "0")
    bpc_jax._staged_cache.clear()
    want = TPUCodec(cfg, [lut], PARAMS).encode(img)
    monkeypatch.setenv("PICSONG_STAGED_PAIR", "1")
    monkeypatch.setenv("PICSONG_STAGED_GROUP", str(group))
    bpc_jax._staged_cache.clear()
    codec = TPUCodec(cfg, [lut], PARAMS)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0]), "grouped-plane stream differs"
    assert np.array_equal(codec.decode(got), img)
    bpc_jax._staged_cache.clear()


@pytest.mark.parametrize("chunked,group,cp", [(False, "", 2), (True, "", 2),
                                              (False, "4", 2), (True, "4", 2),
                                              (False, "", 3), (True, "4", 3)])
def test_staged_fused_direction_bitexact(chunked, group, cp, monkeypatch):
    """PICSONG_STAGED_FUSED=1 fuses init + the all-planes grouped loop +
    finish into ONE program per direction (bpc_jax.StagedBPC
    ._fused_dir_prog). Bytes must equal the split-endpoint schedule's
    exactly, unchunked AND through the chunked (_at, dynamic-slice-inside)
    path with an uneven tail. The group="4" cases pin the split schedule's
    G BELOW the image's plane count, exercising the round-5 extension
    where the fused program covers MORE planes than one split grouped
    program would (the 16-plane lossy large-batch regime). cp=3 cases
    gate the round-5 three-pass fused direction (_spp_mrp_cp_pass body)."""
    from picsong_tpu.entropy import bpc_jax
    rng = np.random.default_rng(23)
    img = make_image(rng, 64, 320)
    cfg = CodecConfig(width=320, height=64, wavelet_levels=1,
                      coding_passes=cp)
    lut = neutral_lut(PARAMS, 1, cp)
    kw = dict(chunk_blocks=3) if chunked else {}
    if group:
        monkeypatch.setenv("PICSONG_STAGED_GROUP", group)
    monkeypatch.setenv("PICSONG_STAGED_FUSED", "0")
    bpc_jax._staged_cache.clear()
    want = TPUCodec(cfg, [lut], PARAMS, **kw).encode(img)
    monkeypatch.setenv("PICSONG_STAGED_FUSED", "1")
    bpc_jax._staged_cache.clear()
    codec = TPUCodec(cfg, [lut], PARAMS, **kw)
    got = codec.encode(img)
    assert np.array_equal(got[0], want[0]), "fused-direction stream differs"
    assert np.array_equal(codec.decode(got), img)
    bpc_jax._staged_cache.clear()


def test_unpack_dense_matches_host_layout():
    """StagedBPC.unpack_dense (device-side inverse of encode_packed) must
    reproduce the host unpack_streams layout exactly: word 0 = MSB, words
    1..size-1 = payload, -1 fill beyond."""
    import jax.numpy as jnp
    from picsong_tpu.engine.batch import BatchCodec
    rng = np.random.default_rng(23)
    frames = np.stack([make_image(rng, 64, 128) for _ in range(2)])
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1)
    lut = neutral_lut(PARAMS, 1, 2)
    bc = BatchCodec(cfg, [lut], PARAMS, batch=2)
    n_planes = 9
    (streams, sizes), = bc.encode_batch(frames, n_planes)
    sizes = np.asarray(sizes)
    bucket = int((sizes - 1).sum()) + 8
    (psizes, msb, dense), = bc.encode_batch_packed(frames, n_planes, bucket)
    assert np.array_equal(np.asarray(psizes), sizes)
    got = np.asarray(bc._staged.unpack_dense(
        jnp.asarray(dense), jnp.asarray(psizes, jnp.int32),
        jnp.asarray(msb, jnp.int32)))
    want = np.asarray(streams, np.uint16).astype(np.int64)
    want_full = np.where(want == 0xFFFF, -1, want)  # cast16 wraps -1 fill
    # word 0 (MSB) and payload words must match; fill must be -1
    assert np.array_equal(got[:, 0], np.asarray(msb))
    for i in range(got.shape[0]):
        n = int(sizes[i])
        assert np.array_equal(got[i, :n], want_full[i, :n])
        assert np.all(got[i, n:] == -1)


@pytest.mark.parametrize("var,value", [("PICSONG_ENCODER", "pallas"),
                                       ("PICSONG_DECODER", "bogus")])
def test_unknown_coder_mode_raises(var, value, monkeypatch):
    """An unknown coder name fails loudly, naming the valid modes, instead
    of silently running another coder."""
    rng = np.random.default_rng(13)
    img = make_image(rng, 64, 64)
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1)
    codec = TPUCodec(cfg, [neutral_lut(PARAMS, 1, 2)], PARAMS)
    streams = codec.encode(img)
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match="staged, mono"):
        if var == "PICSONG_ENCODER":
            codec.encode(img)
        else:
            codec.decode(streams)
