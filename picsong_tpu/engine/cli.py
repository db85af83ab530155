"""Command-line interface mirroring the reference PICSONG launcher.

Flags, defaults and validation follow Launcher.cu:36-163; on decode every
configuration value is recovered from the codestream header, never from
the CLI (DecodingEngine.cu:38-57). Extra conveniences beyond the
reference: `.pgm` inputs parse their own geometry, and `-LUTFolder
neutral` runs with flat probabilities (no LUT files needed).

Usage examples (matching README.md:104-115 of the reference):

  picsong -wl 5 -cp 2 -type 0 -qs 1 -i in.raw -o out.enc -cbWidth 64 \
          -cbHeight 18 -cd 0 -xSize 2048 -ySize 2560 -video 0 -isRGB 1 \
          -LUTFolder LUT/n1_lossless/ -k 0
  picsong -i out.enc -o decoded.raw -cd 1 -video 0 -LUTFolder LUT/n1_lossless/
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..core import spec
from ..core.header import CodecConfig, unpack_header
from ..core.image_io import (append_raw_frame, read_codestream,
                             read_header_shorts, read_pgm, read_raw_frame,
                             read_sizes, sample_dtype, write_codestream,
                             write_pgm)
from ..core.lut import LUTParams, load_luts, neutral_lut
from .pipeline import TPUCodec
from .video import decode_video, encode_video

HELP = """PICSONG codec. Options (reference-compatible):
  -h                 show this help
  -cd [0|1]          0 = encode, 1 = decode (required)
  -i FILE            input file (.pgm or planar RAW for encode)
  -o FILE            output file
  -wl N              wavelet decomposition levels, 1..10 (encode)
  -cp [2|3]          coding passes (3 is deprecated)
  -type [0|1]        0 = lossless 5/3, 1 = lossy 9/7
  -qs Q              quantization size in [0, 1] (lossy only)
  -cbWidth N         codeblock width knob (multiple of 64)
  -cbHeight N        DWT tile length knob (18..20)
  -xSize N -ySize N  image width / height (RAW inputs)
  -video [0|1]       frame-sequence mode
  -frames N          number of frames (video encode)
  -isRGB [0|1]       planar RGB input
  -components N      component count
  -bps N             bits per sample
  -endianess [0|1]   sample endianness
  -signedOrUnsigned [0|1]
  -numberOfStreams N video frame batch size (frames/dispatch)
  -sharded N         shard coding over N devices (image: row-sharded;
                     video: frame data parallel batches; 0 = off)
  -LUTFolder PATH    LUT folder (or 'neutral' / 'trained')
  -k K               complexity-scalability factor, 0..65.535
"""


def _parse_args(argv: list[str]) -> dict:
    opts = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "-h":
            opts["h"] = True
            i += 1
            continue
        if tok.startswith("-") and i + 1 < len(argv):
            opts[tok[1:]] = argv[i + 1]
            i += 2
        else:
            i += 1
    return opts


def _load_luts(folder: str, wavelet_levels: int, coding_passes: int,
               k_factor: float, lossy: bool = False):
    if folder == "trained":
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        folder = os.path.join(repo, "luts",
                              "trained_lossy" if lossy else "trained_lossless")
    if not folder or folder == "neutral" or not os.path.isdir(folder):
        params = LUTParams()
        groups = params.n_bitplane_files if k_factor > 0 else 1
        return [neutral_lut(params, wavelet_levels, coding_passes, groups)], params
    return load_luts(folder, wavelet_levels, coding_passes, k_factor)


def _make_image_codec(cfg: CodecConfig, luts, params, opts):
    """Single-device TPUCodec, or a row-sharded ShardedCodec over an
    N-device mesh when -sharded N > 1 (BASELINE configs 3-5 scaling)."""
    n = int(opts.get("sharded", 0))
    if n > 1:
        from ..dist.sharded import ShardedCodec, make_mesh
        return ShardedCodec(cfg, luts, params, make_mesh(n))
    return TPUCodec(cfg, luts, params)


def _read_encode_input(path: str, cfg: CodecConfig):
    if path.endswith(".pgm"):
        return read_pgm(path)
    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)
    if cfg.is_rgb:
        return [read_raw_frame(path, cfg.width, cfg.height, c, dtype)
                for c in range(3)]
    return read_raw_frame(path, cfg.width, cfg.height, 0, dtype)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = _parse_args(argv)
    if "h" in opts or not opts:
        print(HELP)
        return 0

    t_start = time.perf_counter()
    cd = int(opts.get("cd", 2))
    input_file = opts.get("i", "")
    output_file = opts.get("o", "")
    streams_depth = int(opts.get("numberOfStreams", 8))
    is_video = int(opts.get("video", 0)) == 1

    if cd == 0:
        wl = int(opts.get("wl", 5))
        cp = int(opts.get("cp", 2))
        lossy = int(opts.get("type", 0)) == 1
        qs = float(opts.get("qs", 1))
        cb_width = int(opts.get("cbWidth", 64))
        cb_height = int(opts.get("cbHeight", 18))
        x_size = int(opts.get("xSize", 0))
        y_size = int(opts.get("ySize", 0))
        frames = int(opts.get("frames", 0))
        components = int(opts.get("components", 1))
        is_rgb = int(opts.get("isRGB", 0)) == 1
        bps = int(opts.get("bps", 8))
        endianess = int(opts.get("endianess", 0))
        is_signed = int(opts.get("signedOrUnsigned", 0)) == 1
        k = float(opts.get("k", 0))

        if input_file.endswith(".pgm") and (x_size == 0 or y_size == 0):
            img = read_pgm(input_file)
            y_size, x_size = img.shape

        # validation predicate (Launcher.cu:132)
        if (not (0 <= qs <= 1) or not (1 <= wl <= 10) or x_size <= 0
                or y_size <= 0 or not input_file or not output_file
                or cb_width % 64 != 0 or not (18 <= cb_height <= 20)
                or cp not in (2, 3) or not (0 <= k <= 65.535)):
            print("Incorrect parameters. Please choose valid values.")
            return 1

        cfg = CodecConfig(width=x_size, height=y_size, components=components,
                          coding_passes=cp, cb_height=cb_height,
                          cb_width=cb_width, wavelet_levels=wl, bit_depth=bps,
                          is_lossy=lossy, qs=qs, is_rgb=is_rgb,
                          endianess=endianess, bps=bps, is_signed=is_signed,
                          frames=frames, k_factor=k)
        luts, params = _load_luts(opts.get("LUTFolder", ""), wl, cp, k, lossy)

        if is_video:
            stats = encode_video(input_file, output_file, cfg, luts, params,
                                 frames, batch=max(streams_depth, 1),
                                 progress=True,
                                 devices=max(int(opts.get("sharded", 0)), 1))
            print(f"Encoded {stats.frames} frames in {stats.wall_s:.3f}s "
                  f"(batch {stats.batch}, compute {stats.compute_s:.3f}s, "
                  f"reader stall {stats.reader_stall_s:.3f}s, writer stall "
                  f"{stats.writer_stall_s:.3f}s, writer busy "
                  f"{stats.writer_busy_s:.3f}s)")
        else:
            pixels = _read_encode_input(input_file, cfg)
            codec = _make_image_codec(cfg, luts, params, opts)
            streams = codec.encode(pixels)
            for j, s in enumerate(streams):
                write_codestream(output_file, s, first=(j == 0))
    elif cd == 1:
        header = read_header_shorts(input_file)
        cfg = unpack_header(header)
        luts, params = _load_luts(opts.get("LUTFolder", ""),
                                  cfg.wavelet_levels, cfg.coding_passes,
                                  cfg.k_factor, cfg.is_lossy)
        if is_video:
            stats = decode_video(input_file, output_file, cfg, luts, params,
                                 batch=max(streams_depth, 1),
                                 progress=True,
                                 devices=max(int(opts.get("sharded", 0)), 1))
            print(f"Decoded {stats.frames} frames in {stats.wall_s:.3f}s "
                  f"(compute {stats.compute_s:.3f}s)")
        else:
            sizes = (read_sizes(input_file)
                     if os.path.exists(input_file + "_SIZE") else None)
            if sizes is None:
                n_shorts = os.path.getsize(input_file) // 2
                comp_streams = [read_codestream(input_file, 0, n_shorts)]
            else:
                offsets = np.concatenate([[0], np.cumsum(sizes)])
                comp_streams = [read_codestream(input_file, int(offsets[j]),
                                                int(sizes[j]))
                                for j in range(len(sizes))]
            codec = _make_image_codec(cfg, luts, params, opts)
            out = codec.decode(comp_streams)
            dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)
            if cfg.is_rgb:
                if os.path.exists(output_file):
                    os.remove(output_file)
                for p in out:
                    append_raw_frame(output_file, p, dtype)
            elif output_file.endswith(".pgm"):
                write_pgm(output_file, out, cfg.bit_depth)
            else:
                if os.path.exists(output_file):
                    os.remove(output_file)
                append_raw_frame(output_file, out, dtype)
    else:
        print("Incorrect parameters. Please choose valid values.")
        return 1

    print(f"The time spent with the app is: {time.perf_counter() - t_start:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
