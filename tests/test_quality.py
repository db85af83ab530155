"""Compression-quality gates: LUT-driven context modeling must actually
compress (without a test of stream size, a codec emitting near-raw
streams would pass the suite).

The reference's whole point is stationary context-probability tables
(Engines/Engine.cu:8-185; LUT/n1_lossless). Gates here:
  1. a natural image at wl=5 lossless compresses >= 2x vs raw with the
     upstream reference tables,
  2. the repo's shipped trained tables (tools/lut_train.py) beat neutral
     and match-or-beat the reference tables on every image class
     (natural / noisy / edges),
  3. the shipped trained LOSSY tables match-or-beat the reference
     n1_lossy tables,
  4. the trained bitplane-group files (complexity scalability -k, bulk
     mode) carry real statistics: k > 0 streams stay bit-exact
     round-trippable and compress clearly better than neutral tables,
  5. streams stay bit-exact round-trippable with real (non-neutral) LUTs.
"""

import os

import numpy as np
import pytest

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.lut import LUTParams, load_luts, neutral_lut
from picsong_tpu.engine.pipeline import TPUCodec

REFERENCE_LUTS = "/root/reference/CUDA_ImCod/LUT/n1_lossless"
REFERENCE_LUTS_LOSSY = "/root/reference/CUDA_ImCod/LUT/n1_lossy"
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_LUTS = os.path.join(_REPO, "luts", "trained_lossless")
TRAINED_LUTS_LOSSY = os.path.join(_REPO, "luts", "trained_lossy")


def natural_image(size=256, seed=42, sigma=24, noise=2.0):
    """Filtered-noise stand-in for a natural photo: strong spatial
    correlation with mild sensor noise."""
    rng = np.random.default_rng(seed)
    n = rng.normal(0, 1, size=(size, size))
    f = np.fft.fft2(n)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    filt = np.exp(-(fx ** 2 + fy ** 2) * (sigma * size / 8) ** 2)
    img = np.real(np.fft.ifft2(f * filt))
    img = (img - img.min()) / max(np.ptp(img), 1e-9) * 255
    img = img + rng.normal(0, noise, size=(size, size))
    return np.clip(img, 0, 255).astype(np.uint8)


def noisy_image(size=256):
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, (size, size)))
    return np.clip(base, 0, 255).astype(np.uint8)


def edges_image(size=256, seed=9):
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size))
    for _ in range(40):
        x0, y0 = rng.integers(0, size, 2)
        w, h = rng.integers(20, 200, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


IMAGE_CLASSES = {"natural": natural_image, "noisy": noisy_image,
                 "edges": edges_image}


def encode_bytes(img, folder, lossy=False, qs=1.0, k=0.0):
    cfg = CodecConfig(width=img.shape[1], height=img.shape[0],
                      wavelet_levels=5, is_lossy=lossy, qs=qs, k_factor=k)
    params = LUTParams()
    if folder is None:
        lut = neutral_lut(params, 5, 2,
                          n_groups=params.n_bitplane_files if k > 0 else 1)
    else:
        luts, params = load_luts(folder, 5, 2, k)
        lut = luts[0]
    codec = TPUCodec(cfg, [lut], params)
    stream = codec.encode(img)[0]
    out = codec.decode([stream])
    if lossy:
        err = out.astype(np.float64) - img
        assert float(np.sqrt(np.mean(err * err))) < 4.0, \
            f"lossy reconstruction off with {folder}"
    else:
        assert np.array_equal(out, img), f"round trip broke with {folder}"
    return stream.size * 2


def test_reference_lut_compresses_2x():
    img = natural_image()
    nbytes = encode_bytes(img, REFERENCE_LUTS)
    ratio = img.size / nbytes
    assert ratio >= 2.0, f"reference-LUT ratio {ratio:.3f} < 2.0"


def test_trained_lut_beats_neutral():
    img = natural_image(seed=43)
    neutral_bytes = encode_bytes(img, None)
    trained_bytes = encode_bytes(img, TRAINED_LUTS)
    assert trained_bytes < 0.85 * neutral_bytes, (
        f"trained {trained_bytes} not clearly below neutral {neutral_bytes}")


@pytest.mark.parametrize("cls", sorted(IMAGE_CLASSES))
def test_trained_lut_matches_or_beats_reference(cls):
    """The shipped tables must be at least as good as the upstream
    n1_lossless tables on every image class."""
    img = IMAGE_CLASSES[cls]()
    ref_bytes = encode_bytes(img, REFERENCE_LUTS)
    trained_bytes = encode_bytes(img, TRAINED_LUTS)
    assert trained_bytes <= ref_bytes, (
        f"{cls}: trained {trained_bytes} > reference {ref_bytes}")


def test_trained_lut_matches_or_beats_reference_2048():
    """Large-geometry gate (BASELINE config 2 geometry): level/subband statistics shift with image size, and the
    r4 tables lost to the reference at 2048^2 natural (3.469 vs 3.446
    bpp). The round-5 tables add class-mixed 2048^2 training members
    with edge overlays (tools/lut_train.py --big-gray 4 --big-scale 8)
    and win every class at every geometry (512/256/2048 sweep recorded
    in QUALITY.md). One 2048 class here keeps the gate
    affordable; natural is the class that regressed."""
    img = natural_image(size=2048)
    ref_bytes = encode_bytes(img, REFERENCE_LUTS)
    trained_bytes = encode_bytes(img, TRAINED_LUTS)
    assert trained_bytes <= ref_bytes, (
        f"2048 natural: trained {trained_bytes} > reference {ref_bytes}")


def test_trained_lossy_lut_matches_or_beats_reference():
    """Same gate for the 9/7 path against the upstream n1_lossy tables
    (quantization is identical, so bytes are the whole comparison)."""
    img = natural_image(seed=45)
    ref_bytes = encode_bytes(img, REFERENCE_LUTS_LOSSY, lossy=True)
    trained_bytes = encode_bytes(img, TRAINED_LUTS_LOSSY, lossy=True)
    assert trained_bytes <= ref_bytes, (
        f"lossy: trained {trained_bytes} > reference {ref_bytes}")


def motion_image(size=256, seed=11):
    """Anisotropic (horizontally motion-blurred) frame: the video content
    class (reference LUT/video_{lossless,lossy})."""
    rng = np.random.default_rng(seed)
    n = rng.normal(0, 1, (size, size))
    f = np.fft.fft2(n)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    img = np.real(np.fft.ifft2(
        f * np.exp(-((fx * 24) ** 2 + (fy * 8) ** 2) * (size / 8) ** 2)))
    img = (img - img.min()) / max(np.ptp(img), 1e-9) * 255
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("lossy", [False, True])
def test_trained_video_lut_matches_or_beats_reference(lossy):
    """4-folder parity with the reference's LUT side data (Engine.cu:8-185
    loads one of n1/video x lossless/lossy): the shipped video-content
    tables must match-or-beat the upstream video tables on motion-blurred
    frames."""
    folder = "trained_video_lossy" if lossy else "trained_video_lossless"
    ref = ("/root/reference/CUDA_ImCod/LUT/video_lossy" if lossy
           else "/root/reference/CUDA_ImCod/LUT/video_lossless")
    img = motion_image()
    ref_bytes = encode_bytes(img, ref, lossy=lossy)
    trained_bytes = encode_bytes(img, os.path.join(_REPO, "luts", folder),
                                 lossy=lossy)
    assert trained_bytes <= ref_bytes, (
        f"video {'lossy' if lossy else 'lossless'}: trained "
        f"{trained_bytes} > reference {ref_bytes}")


def test_trained_bitplane_groups_compress():
    """Complexity scalability: with k > 0 the coder switches to the fused
    bulk mode using bitplane-group LUT file s (BPCEngine.cu:1285-1662,
    Engine.cu:12-100). The shipped group files are trained on the exact
    bulk-mode trajectory (tools/lut_train.py _collect_bulk); they must
    round-trip bit-exact and clearly beat neutral tables."""
    img = natural_image(seed=46, size=192)
    k = 2.0
    neutral_bytes = encode_bytes(img, None, k=k)
    trained_bytes = encode_bytes(img, TRAINED_LUTS, k=k)
    assert trained_bytes < 0.9 * neutral_bytes, (
        f"k>0 trained {trained_bytes} not clearly below neutral "
        f"{neutral_bytes}")
