"""End-to-end smoke run of the codec on one NVIDIA GPU.

    python chip_smoke.py              # five phases on one GPU
    python chip_smoke.py --four-gpus  # only the -sharded 4 phase, 4 GPUs

Every phase drives the reference-compatible CLI (`engine.cli.main`) in
this one process, at the sizes the codec's users run, and checks what
comes out against the NumPy oracle (`picsong_tpu/reference/`):

  gray_lossless  2048^2 8-bit PGM, wl=5, trained LUTs: bit-exact round
                 trip; the whole 5/3 DWT plane equals the oracle's; >= 32
                 codeblock streams (every level and subband) equal the
                 oracle coder's
  rgb_still      2560x2048 planar RGB (the reference's own still size):
                 RCT lossless bit-exact; ICT + 9/7 at qs=0.5 within the
                 lossy tolerance below
  coding_modes   256^2, -cp 3 and -k 4: codestream == oracle, byte for byte
  big_image      8192^2 lossless (16,384 codeblocks, the chunked coder)
  video          32 frames of 1080p gray, 8 frames per batch: bit-exact

Lossy tolerance: the 9/7 lifting is float32 elementwise work that XLA may
contract into FMAs, so at most 1e-4 of the quantized coefficients may
differ from the oracle's, by at most 1, and the decoded PSNR must be
within 0.05 dB of the oracle reconstruction's.

Each phase prints its cold (first, compiling) and warm (second) wall
time and the share of encode time spent in the host-side bitplane bound
(`encode/planes_host`). The first line of output is the card's name and
power limit; the last is one JSON object naming the device. The script
exits non-zero, printing no such line, when JAX finds no GPU or when any
phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from bench import card, make_image
from picsong_tpu import native
from picsong_tpu.core import spec
from picsong_tpu.core.geometry import codeblock_bands
from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.image_io import (mirror_pad, read_codestream, read_pgm,
                                       write_pgm)
from picsong_tpu.engine import cli
from picsong_tpu.obs.trace import GLOBAL_TIMERS
from picsong_tpu.reference import bpc as oracle_bpc
from picsong_tpu.reference import codec as oracle
from picsong_tpu.reference import dwt as oracle_dwt

REPO = os.path.dirname(os.path.abspath(__file__))
LUTS = os.path.join(REPO, "luts")
LOSSY_MAX_DIFF_FRACTION = 1e-4
LOSSY_PSNR_SLACK_DB = 0.05
PHASE_LIMIT_S = 480


# -- checks and helpers -------------------------------------------------------

def psnr(a: np.ndarray, b: np.ndarray) -> float:
    err = a.astype(np.float64) - b.astype(np.float64)
    return float(10 * np.log10(255.0 ** 2 / max(np.mean(err * err), 1e-12)))


# -- running the CLI -------------------------------------------------------

def run_cli(*argv) -> tuple[float, float]:
    """One in-process CLI call -> (wall seconds, planes_host seconds)."""
    ph0 = GLOBAL_TIMERS.totals.get("encode/planes_host", 0.0)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"CLI {' '.join(map(str, argv))} returned {rc}: "
                           f"{out.getvalue().strip()}")
    return wall, GLOBAL_TIMERS.totals.get("encode/planes_host", 0.0) - ph0


def round_trips(enc_args, dec_args, runs: int = 2) -> list[dict]:
    """Encode + decode `runs` times; the first run is the cold one."""
    out = []
    for _ in range(runs):
        enc_s, host_s = run_cli("-cd", 0, *enc_args)
        dec_s, _ = run_cli("-cd", 1, *dec_args)
        out.append({"encode_s": enc_s, "decode_s": dec_s,
                    "planes_host_s": host_s})
    return out


def timing_line(name: str, runs: list[dict], extra: str = "") -> str:
    cold, warm = runs[0], runs[-1]
    share = warm["planes_host_s"] / warm["encode_s"]
    return (f"{name}: cold {cold['encode_s'] + cold['decode_s']:.3f} s "
            f"(encode {cold['encode_s']:.3f}, decode {cold['decode_s']:.3f}); "
            f"warm {warm['encode_s'] + warm['decode_s']:.3f} s "
            f"(encode {warm['encode_s']:.3f}, decode {warm['decode_s']:.3f}); "
            f"planes_host {share:.1%} of warm encode{extra}")


def read_stream(path: str) -> np.ndarray:
    return read_codestream(path, 0, os.path.getsize(path) // 2)


def write_planes(path: str, planes) -> None:
    with open(path, "wb") as f:
        for p in planes:
            f.write(np.ascontiguousarray(p).tobytes())


def same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def say(line: str) -> str:
    """Print a result line as soon as it exists (a hang then shows where)."""
    print(line, flush=True)
    return line


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# -- phases -------------------------------------------------------------------

def pick_codeblocks(levels, subbands, n_blocks: int, seed: int = 0):
    """>= n_blocks codeblock indices covering every (level, subband)."""
    rng = np.random.default_rng(seed)
    pairs = sorted(set(zip(levels.tolist(), subbands.tolist())))
    per_pair = -(-n_blocks // len(pairs))
    picked = []
    for lv, sb in pairs:
        idx = np.flatnonzero((levels == lv) & (subbands == sb))
        picked += rng.choice(idx, min(per_pair, idx.size),
                             replace=False).tolist()
    rest = np.setdiff1d(np.arange(levels.size), picked)
    short = max(n_blocks - len(picked), 0)
    picked += rng.choice(rest, min(short, rest.size), replace=False).tolist()
    return sorted(picked), len(pairs)


def phase_gray_lossless(work: str, size: int = 2048, wl: int = 5,
                        n_blocks: int = 32) -> str:
    """Gray 5/3 round trip + whole-plane DWT and sampled codeblock checks."""
    import jax.numpy as jnp
    from picsong_tpu.assembly.pack import unpack_streams
    from picsong_tpu.transform.dwt import dwt_forward

    folder = os.path.join(LUTS, "trained_lossless")
    img = make_image(size, size, seed=1)
    src, enc, dec = (os.path.join(work, n)
                     for n in ("gray.pgm", "gray.enc", "gray_dec.pgm"))
    write_pgm(src, img)
    runs = round_trips(["-i", src, "-o", enc, "-wl", wl, "-cp", 2,
                        "-type", 0, "-LUTFolder", folder],
                       ["-i", enc, "-o", dec, "-LUTFolder", folder])
    _check(np.array_equal(read_pgm(dec), img), "gray round trip not bit-exact")

    aw, ah = spec.adapted_size(size, size)
    shifted = mirror_pad(img, aw, ah).astype(np.int32) - 128
    want = oracle_dwt.dwt_forward(shifted, wl, False, 1.0).astype(np.int32)
    got = np.asarray(dwt_forward(jnp.asarray(shifted), wl, False, 1.0))
    _check(np.array_equal(got, want), "5/3 DWT differs from the oracle")

    luts, params = cli._load_luts(folder, wl, 2, 0.0)
    levels, subbands = codeblock_bands(aw, ah, wl)
    streams, sizes = unpack_streams(read_stream(enc), levels.size)
    blocks = oracle.plane_to_codeblocks(want)
    picked, n_pairs = pick_codeblocks(levels, subbands, n_blocks)
    for i in picked:
        cs, n = oracle_bpc.encode_codeblock(
            blocks[i], int(levels[i]), int(subbands[i]), luts[0], params, wl)
        _check(n == sizes[i] and np.array_equal(cs[:n], streams[i, :n]),
               f"codeblock {i} (level {levels[i]}, subband {subbands[i]}) "
               "differs from the oracle coder")
    return say(timing_line(
        f"gray_lossless {size}x{size}", runs,
        f"; DWT exact over {want.size} coefficients; {len(picked)} "
        f"codeblocks over {n_pairs} (level, subband) pairs equal the "
        "oracle"))


def lossy_rgb_oracle(planes, wl: int, qs: float):
    """Oracle quantized coefficients and reconstruction for 9/7 + ICT."""
    h, w = planes[0].shape
    aw, ah = spec.adapted_size(w, h)
    shifted = [mirror_pad(p, aw, ah).astype(np.float32) - 128 for p in planes]
    comps = oracle.ict_forward(*shifted)
    coeffs = [oracle_dwt.dwt_forward(c, wl, True, qs).astype(np.int32)
              for c in comps]
    recon = oracle.ict_inverse(*[oracle_dwt.dwt_reverse(c, wl, True, qs)
                                 for c in coeffs])
    return coeffs, [np.clip(c + 128, 0, 255)[:h, :w] for c in recon]


def device_rgb_coefficients(planes, cfg: CodecConfig, luts, params):
    """The engine's quantized coefficient planes for an RGB image."""
    import jax.numpy as jnp
    from picsong_tpu.engine.pipeline import TPUCodec
    codec = TPUCodec(cfg, luts, params)
    padded = [jnp.asarray(mirror_pad(p, codec.aw, codec.ah)) for p in planes]
    return [np.asarray(codec._dwt_tile(c)[0])
            for c in codec._prep_rgb(*padded)]


def phase_rgb_still(work: str, width: int = 2560, height: int = 2048,
                    wl: int = 5, qs: float = 0.5) -> str:
    """Planar RGB still: RCT lossless bit-exact, ICT + 9/7 lossy in bounds."""
    base = make_image(height, width, seed=2).astype(np.int16)
    planes = [np.clip(base + d, 0, 255).astype(np.uint8)
              for d in (12, 0, -20)]
    src, enc, dec = (os.path.join(work, n)
                     for n in ("rgb.raw", "rgb.enc", "rgb_dec.raw"))
    write_planes(src, planes)
    geo = ["-isRGB", 1, "-xSize", width, "-ySize", height, "-wl", wl,
           "-LUTFolder", "trained"]
    lines = []
    runs = round_trips(["-i", src, "-o", enc, "-type", 0] + geo,
                       ["-i", enc, "-o", dec, "-LUTFolder", "trained"])
    _check(same_file(src, dec), "RGB lossless round trip not bit-exact")
    lines.append(say(timing_line(f"rgb_still lossless {width}x{height}",
                                 runs)))

    runs = round_trips(["-i", src, "-o", enc, "-type", 1, "-qs", qs] + geo,
                       ["-i", enc, "-o", dec, "-LUTFolder", "trained"])
    decoded = np.fromfile(dec, np.uint8).reshape(3, height, width)
    want_q, want_px = lossy_rgb_oracle(planes, wl, qs)
    cfg = CodecConfig(width=width, height=height, components=1, is_rgb=True,
                      wavelet_levels=wl, is_lossy=True, qs=qs)
    luts, params = cli._load_luts("trained", wl, 2, 0.0, lossy=True)
    got_q = device_rgb_coefficients(planes, cfg, luts, params)
    n_diff = max_diff = total = 0
    for got, want in zip(got_q, want_q):
        d = np.abs(got.astype(np.int64)
                   - oracle.plane_to_codeblocks(want).astype(np.int64))
        n_diff += int(np.count_nonzero(d))
        max_diff = max(max_diff, int(d.max()))
        total += d.size
    psnr_got = psnr(decoded, np.stack(planes))
    psnr_want = psnr(np.stack(want_px), np.stack(planes))
    _check(n_diff <= LOSSY_MAX_DIFF_FRACTION * total and max_diff <= 1,
           f"lossy coefficients: {n_diff} of {total} differ, max {max_diff}")
    _check(abs(psnr_got - psnr_want) <= LOSSY_PSNR_SLACK_DB,
           f"lossy PSNR {psnr_got:.3f} dB vs oracle {psnr_want:.3f} dB")
    lines.append(say(timing_line(
        f"rgb_still lossy qs={qs} {width}x{height}", runs,
        f"; {n_diff} of {total} coefficients differ from the oracle "
        f"(max {max_diff}); PSNR {psnr_got:.4f} dB vs oracle "
        f"{psnr_want:.4f} dB")))
    return "\n".join(lines)


def phase_coding_modes(work: str, size: int = 256, wl: int = 5) -> str:
    """-cp 3 and -k 4: the whole codestream equals the oracle's."""
    img = make_image(size, size, seed=3)
    src = os.path.join(work, "modes.pgm")
    write_pgm(src, img)
    lines = []
    for name, cp, k, folder in (
            ("cp3", 3, 0.0, "neutral"),
            ("k4", 2, 4.0, os.path.join(LUTS, "trained_lossless"))):
        enc, dec = (os.path.join(work, f"{name}{ext}")
                    for ext in (".enc", "_dec.pgm"))
        runs = round_trips(["-i", src, "-o", enc, "-wl", wl, "-cp", cp,
                            "-k", k, "-LUTFolder", folder],
                           ["-i", enc, "-o", dec, "-LUTFolder", folder])
        _check(np.array_equal(read_pgm(dec), img),
               f"{name} round trip not bit-exact")
        cfg = CodecConfig(width=size, height=size, coding_passes=cp,
                          wavelet_levels=wl, k_factor=k)
        luts, params = cli._load_luts(folder, wl, cp, k)
        want = oracle.encode_image(img, cfg, luts, params)[0]
        _check(np.array_equal(read_stream(enc), want),
               f"{name} codestream differs from the oracle")
        lines.append(say(timing_line(
            f"coding_modes {name} {size}x{size}", runs,
            f"; codestream == oracle ({want.size} shorts)")))
    return "\n".join(lines)


def phase_big_image(work: str, size: int = 8192, wl: int = 5) -> str:
    """Large gray lossless image through the chunked coder."""
    from picsong_tpu.entropy.bpc_jax import _auto_chunk
    img = make_image(size, size, seed=4)
    src, enc, dec = (os.path.join(work, n)
                     for n in ("big.pgm", "big.enc", "big_dec.pgm"))
    write_pgm(src, img)
    folder = os.path.join(LUTS, "trained_lossless")
    runs = round_trips(["-i", src, "-o", enc, "-wl", wl, "-LUTFolder",
                        folder],
                       ["-i", enc, "-o", dec, "-LUTFolder", folder])
    _check(np.array_equal(read_pgm(dec), img), "big image not bit-exact")
    ncb = spec.num_codeblocks(*spec.adapted_size(size, size))
    return say(timing_line(f"big_image {size}x{size}", runs,
                           f"; {ncb} codeblocks, chunk {_auto_chunk(ncb)}"))


def write_video(path: str, frames: int, width: int, height: int) -> None:
    base = make_image(height, width + 8 * frames, seed=5)
    rng = np.random.default_rng(6)
    with open(path, "wb") as f:
        for i in range(frames):
            frame = base[:, 8 * i:8 * i + width].astype(np.int16)
            frame = frame + rng.integers(-3, 4, frame.shape)
            f.write(np.clip(frame, 0, 255).astype(np.uint8).tobytes())


def phase_video(work: str, width: int = 1920, height: int = 1080,
                frames: int = 32, streams: int = 8, wl: int = 5) -> str:
    """Gray RAW video through the batched pipelined engine."""
    src, enc, dec = (os.path.join(work, n)
                     for n in ("video.raw", "video.enc", "video_dec.raw"))
    write_video(src, frames, width, height)
    folder = os.path.join(LUTS, "trained_video_lossless")
    runs = round_trips(["-i", src, "-o", enc, "-xSize", width, "-ySize",
                        height, "-video", 1, "-frames", frames,
                        "-numberOfStreams", streams, "-wl", wl,
                        "-LUTFolder", folder],
                       ["-i", enc, "-o", dec, "-video", 1,
                        "-numberOfStreams", streams, "-LUTFolder", folder])
    _check(same_file(src, dec), "video round trip not bit-exact")
    warm = runs[-1]
    return say(timing_line(
        f"video {frames} frames {width}x{height} batch {streams}", runs,
        f"; warm encode {frames / warm['encode_s']:.2f} frames/s, decode "
        f"{frames / warm['decode_s']:.2f} frames/s"))


def device_shares(arr) -> str:
    """Rows of the leading axis that each device holds."""
    return ", ".join(f"{s.device.platform}:{s.device.id}={s.data.shape[0]}"
                     for s in sorted(arr.addressable_shards,
                                     key=lambda s: s.device.id))


def phase_four_gpus(work: str, image: tuple[int, int] = (8192, 8192),
                    width: int = 1920, height: int = 1080, frames: int = 32,
                    streams: int = 8, n_dev: int = 4, wl: int = 5) -> str:
    """-sharded N image and video: bytes equal the single-device output."""
    import jax.numpy as jnp
    from picsong_tpu.dist.sharded import ShardedCodec, make_mesh
    from picsong_tpu.engine.batch import BatchCodec

    lines = []
    encs = {}
    vsrc = os.path.join(work, "video.raw")
    write_video(vsrc, frames, width, height)
    folder = os.path.join(LUTS, "trained_video_lossless")
    for tag, extra in (("single", []), ("sharded", ["-sharded", n_dev])):
        encs[tag] = os.path.join(work, f"video_{tag}.enc")
        dec = os.path.join(work, f"video_{tag}_dec.raw")
        runs = round_trips(["-i", vsrc, "-o", encs[tag], "-xSize", width,
                            "-ySize", height, "-video", 1, "-frames", frames,
                            "-numberOfStreams", streams, "-wl", wl,
                            "-LUTFolder", folder] + extra,
                           ["-i", encs[tag], "-o", dec, "-video", 1,
                            "-numberOfStreams", streams, "-LUTFolder",
                            folder] + extra)
        _check(same_file(vsrc, dec), f"{tag} video round trip not bit-exact")
        warm = runs[-1]
        lines.append(say(timing_line(
            f"four_gpus video {tag} {frames} frames", runs,
            f"; warm encode {frames / warm['encode_s']:.2f} frames/s, "
            f"decode {frames / warm['decode_s']:.2f} frames/s")))
    _check(same_file(encs["single"], encs["sharded"]),
           "sharded video codestream differs from single-device")
    luts, params = cli._load_luts(folder, wl, 2, 0.0)
    vcfg = CodecConfig(width=width, height=height, wavelet_levels=wl)
    bc = BatchCodec(vcfg, luts, params, streams, mesh=make_mesh(n_dev))
    batch = np.zeros((streams, bc.ah, bc.aw), np.uint8)
    lines.append(say(f"four_gpus video frames per device in a batch of "
                     f"{streams}: {device_shares(bc._put(batch))}"))

    folder = os.path.join(LUTS, "trained_lossless")
    img_h, img_w = image
    img = make_image(img_h, img_w, seed=4)
    src = os.path.join(work, "big.pgm")
    write_pgm(src, img)
    for tag, extra in (("single", []), ("sharded", ["-sharded", n_dev])):
        encs[tag] = os.path.join(work, f"big_{tag}.enc")
        dec = os.path.join(work, f"big_{tag}_dec.pgm")
        runs = round_trips(["-i", src, "-o", encs[tag], "-wl", wl,
                            "-LUTFolder", folder] + extra,
                           ["-i", encs[tag], "-o", dec, "-LUTFolder",
                            folder] + extra)
        _check(np.array_equal(read_pgm(dec), img),
               f"{tag} image round trip not bit-exact")
        lines.append(say(timing_line(
            f"four_gpus image {tag} {img_w}x{img_h}", runs)))
    _check(same_file(encs["single"], encs["sharded"]),
           "sharded image codestream differs from single-device")
    luts, params = cli._load_luts(folder, wl, 2, 0.0)
    cfg = CodecConfig(width=img_w, height=img_h, wavelet_levels=wl)
    codec = ShardedCodec(cfg, luts, params, make_mesh(n_dev))
    blocks, _ = codec._dwt_tile(jnp.asarray(codec._prep_host(img)[0]))
    lines.append(say(f"four_gpus image codeblocks per device: "
                     f"{device_shares(blocks)}"))
    return "\n".join(lines)


PHASES = {
    "gray_lossless": phase_gray_lossless,
    "rgb_still": phase_rgb_still,
    "coding_modes": phase_coding_modes,
    "big_image": phase_big_image,
    "video": phase_video,
}


# -- main ---------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the -sharded 4 phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax
    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or any(d.platform != "gpu" for d in devices):
        print(f"chip_smoke: no GPU (JAX backend {backend!r}, devices "
              f"{[d.platform for d in devices]})", file=sys.stderr)
        return 1
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    print(f"native relocation library: "
          f"{'built' if native.available() else 'unavailable, NumPy path'}",
          flush=True)

    phases = ({"four_gpus": phase_four_gpus} if args.four_gpus else PHASES)
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        # a hung device call cannot be interrupted from Python: dump every
        # thread's stack and exit non-zero instead of holding the card
        faulthandler.dump_traceback_later(PHASE_LIMIT_S, exit=True)
        try:
            with tempfile.TemporaryDirectory(prefix=f"smoke_{name}_") as work:
                fn(work)
        except Exception:                                 # noqa: BLE001
            failed.append(name)
            print(f"{name}: FAILED", flush=True)
            traceback.print_exc()
        faulthandler.cancel_dump_traceback_later()
        print(f"{name}: phase wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
