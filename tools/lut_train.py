"""LUT trainer: generate stationary context-probability tables from images.

The reference ships trained LUT folders (LUT/{n1,video}_{lossless,lossy})
but not the trainer that produced them (it belongs to the BPC-PaCo paper's
offline pipeline). This tool regenerates equivalent side information from
any set of training images: it runs the full prep (DC shift + RCT/ICT
color transform) and DWT, then simulates the exact SPP/MRP scan (same
context formation as the coder) while counting (context, bit) occurrences
per (wavelet level, subband, bitplane), and writes a LUT folder in the
reference's text format (IO/IOManager.ipp:404-612) that both this codec
and the reference parser understand.

Statistics are collected separately for
  * each channel (R/G/B file suffixes = post-color-transform components
    Y/U/V — LUT_N_FILES;3, Engines/Engine.cu:28-58), and
  * each bitplane-group file s (AMOUNT_OF_BITPLANE_FILES, used by the
    complexity-scalability mode `-k`): file s holds normal SPP/MRP
    statistics for bitplanes >= s and fused bulk-mode statistics
    (encodeBulkMode, BPCEngine.cu:1285-1662) for bitplanes < s, exactly
    the trajectory the coder takes when consecutiveBitplanes == s.

Probabilities are P(bit == 0) at 7-bit precision, clamped to [1, 127]
(the arithmetic coder needs both symbols representable).

Usage:
  python tools/lut_train.py --out luts/trained_lossless --levels 5 \
      [--lossy] [--qs 1.0] [--images a.pgm b.pgm ...] [--no-bulk]

Without --images, a synthetic natural-image RGB ensemble (filtered noise
at several correlation lengths, correlated chroma, edge content) is used.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from picsong_tpu.core import spec                       # noqa: E402
from picsong_tpu.core.geometry import (codeblock_bands,  # noqa: E402
                                       plane_to_codeblocks)
from picsong_tpu.core.image_io import read_pgm           # noqa: E402
from picsong_tpu.core.lut import LUTParams               # noqa: E402
from picsong_tpu.reference import bpc                    # noqa: E402
from picsong_tpu.reference.codec import (ict_forward,    # noqa: E402
                                         rct_forward)
from picsong_tpu.reference.dwt import dwt_forward        # noqa: E402

N_SIG_CTX, N_SIGN_CTX, N_REF_CTX = 9, 4, 1


class _Stats:
    """Per-channel (level|LL, subband, bitplane, ctx) -> [c0, c1] counters.

    `sig/sign/ref` hold normal-scan statistics; `bsig/bsign/bref[e]` hold
    bulk-mode statistics for entry plane e (these train bitplane-group
    file s = e + 1 at planes <= e)."""

    def __init__(self, levels: int, n_bitplanes: int):
        g = levels * 3 + 1
        self.sig = np.zeros((g, n_bitplanes, N_SIG_CTX, 2), dtype=np.int64)
        self.sign = np.zeros((g, n_bitplanes, N_SIGN_CTX, 2), dtype=np.int64)
        self.ref = np.zeros((g, n_bitplanes, N_REF_CTX, 2), dtype=np.int64)
        e = n_bitplanes
        self.bsig = np.zeros((e, g, n_bitplanes, N_SIG_CTX, 2), dtype=np.int64)
        self.bsign = np.zeros((e, g, n_bitplanes, N_SIGN_CTX, 2), dtype=np.int64)
        self.bref = np.zeros((e, g, n_bitplanes, N_REF_CTX, 2), dtype=np.int64)
        self.levels = levels
        self.nbp = n_bitplanes

    def group(self, level: int, subband: int) -> int:
        if level == self.levels:
            return self.levels * 3
        return level * 3 + subband


def _collect_bulk(stats: _Stats, coder, g: int, entry: int):
    """Count bulk-pass events from the coder's current state.

    Exact mirror of the encode side of reference/bpc.py _bulk_pass
    (encodeBulkMode, BPCEngine.cu:1285-1662): context captured once per
    cell at the entry plane, then every plane entry..0 coded for that
    cell before moving on."""
    bsig, bsign, bref = stats.bsig[entry], stats.bsign[entry], stats.bref[entry]
    for row in range(64):
        for phase in range(2):
            cur, cols = coder.cells(row, phase)
            nb = coder.neighbors(row, phase)
            if entry != 0:
                ctx = coder._sig_context_bulk(nb, entry)
            else:
                ctx = coder._sig_context(nb)
            work = cur.copy()
            for plane in range(entry, -1, -1):
                sig_lanes = ((work >> 31) & 1) == 1
                bits = (work >> (plane + 1)) & 1
                bref[g, plane, 0, 0] += int((sig_lanes & (bits == 0)).sum())
                bref[g, plane, 0, 1] += int((sig_lanes & (bits == 1)).sum())
                insig = ~sig_lanes
                np.add.at(bsig[g, plane], (ctx[insig], bits[insig]), 1)
                newly = insig & (bits == 1)
                if newly.any():
                    sctx = coder._sign_context_bulk(nb["up"], nb["lf"],
                                                    nb["rt"], nb["bt"], plane)
                    ssym = np.where((work & 1) == (sctx & 1), 0, 1)
                    np.add.at(bsign[g, plane],
                              ((sctx[newly] >> 1), ssym[newly]), 1)
                    work = np.where(newly, work | (1 << 31) | (plane << 24),
                                    work)
            coder.T[row + 1, cols] = work


def collect_block(stats: _Stats, block: np.ndarray, level: int, subband: int,
                  bulk: bool = True):
    """Count SPP/MRP (and bulk) events for one codeblock with the EXACT
    coder scan.

    Runs the same 64-row x 2-phase significance-propagation and refinement
    scan as the coder (reference/bpc.py _spp_pass/_mrp_pass, mirroring
    BPCEngine.cu:799-1022), including in-scan state updates — so the
    (context, bit) statistics are drawn from exactly the distribution the
    coder will index at code time. (A previous plane-synchronous
    approximation produced tables *worse* than neutral: it systematically
    undercounted contexts, because the coder's up/left neighbors already
    reflect the current plane's significance.)

    When `bulk` is set, the scan state is snapshotted before each plane
    and a bulk-mode simulation from that state feeds the bitplane-group
    tables (the trajectory the CS mode takes when it switches to
    encodeBulkMode at that plane).
    """
    g = stats.group(level, subband)
    mag = np.abs(block.astype(np.int64))
    signbit = (block < 0).astype(np.int64)
    T = (mag << 1) | signbit
    msb_or = int(np.bitwise_or.reduce((T >> 1).reshape(-1)))
    if not msb_or:
        return
    msb = msb_or.bit_length() - 1

    coder = bpc._CodeblockCoder(np.full(8, 64, np.int64), LUTParams(),
                                bpc._LutPtrs(0, 0, 0))
    coder.T[1:-1, 1:-1] = T
    snapshots: list[tuple[int, np.ndarray]] = []

    for plane in range(min(msb, stats.nbp - 1), -1, -1):
        if bulk:
            snapshots.append((plane, coder.T.copy()))
        # SPP: significance + sign (BPCEngine.cu:799-843)
        for row in range(64):
            for phase in range(2):
                cur, cols = coder.cells(row, phase)
                nb = coder.neighbors(row, phase)
                active = (cur >> 31) == 0
                ctx = coder._sig_context(nb)
                bits = (cur >> (plane + 1)) & 1
                np.add.at(stats.sig[g, plane], (ctx[active], bits[active]), 1)
                newly = active & (bits == 1)
                upd = cur
                if newly.any():
                    sctx = coder._sign_context(nb["up"], nb["lf"], nb["rt"],
                                               nb["bt"])
                    ssym = np.where((cur & 1) == (sctx & 1), 0, 1)
                    np.add.at(stats.sign[g, plane],
                              ((sctx[newly] >> 1), ssym[newly]), 1)
                    upd = np.where(newly, cur | (1 << 31) | (plane << 24), cur)
                coder.T[row + 1, cols] = upd
        # MRP: refinement (BPCEngine.cu:986-1022)
        for row in range(64):
            for phase in range(2):
                cur, cols = coder.cells(row, phase)
                refine = ((cur >> 29) & 1) == 1
                eligible_next = ~refine & (((cur >> 31) & 1) == 1)
                bits = (cur >> (plane + 1)) & 1
                stats.ref[g, plane, 0, 0] += int((refine & (bits == 0)).sum())
                stats.ref[g, plane, 0, 1] += int((refine & (bits == 1)).sum())
                coder.T[row + 1, cols] = np.where(eligible_next,
                                                  cur | (1 << 29), cur)

    for entry, snap in snapshots:
        coder.T = snap
        _collect_bulk(stats, coder, g, entry)


def _collect_plane(stats: _Stats, coeffs: np.ndarray, aw: int, ah: int,
                   levels: int, bulk: bool):
    lv, sb = codeblock_bands(aw, ah, levels)
    blocks = plane_to_codeblocks(coeffs)
    for i in range(blocks.shape[0]):
        collect_block(stats, blocks[i], int(lv[i]), int(sb[i]), bulk=bulk)


def _padded(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    aw, ah = spec.adapted_size(w, h)
    if (aw, ah) != (w, h):
        from picsong_tpu.core.image_io import mirror_pad
        plane = mirror_pad(plane.astype(np.uint8), aw, ah)
    return plane


def collect_gray(stats_per_ch: list[_Stats], plane: np.ndarray, levels: int,
                 lossy: bool, qs: float, bulk: bool):
    """Grayscale image: pooled into every channel table."""
    plane = _padded(plane)
    shifted = plane.astype(np.int32) - 128
    coeffs = dwt_forward(shifted.astype(np.float32) if lossy else shifted,
                         levels, lossy, qs).astype(np.int32)
    ah, aw = plane.shape
    _collect_plane(stats_per_ch[0], coeffs, aw, ah, levels, bulk)
    for st in stats_per_ch[1:]:
        for name in ("sig", "sign", "ref", "bsig", "bsign", "bref"):
            getattr(st, name)[...] = getattr(stats_per_ch[0], name)


def collect_rgb(stats_per_ch: list[_Stats], rgb: np.ndarray, levels: int,
                lossy: bool, qs: float, bulk: bool):
    """RGB image (H, W, 3): full prep (DC shift + RCT/ICT per
    CodingEngine.cu:357-403), per-channel statistics."""
    planes = [_padded(rgb[..., c]) for c in range(3)]
    shifted = [p.astype(np.int32) - 128 for p in planes]
    if lossy:
        comps = ict_forward(*[s.astype(np.float32) for s in shifted])
    else:
        comps = rct_forward(*shifted)
    ah, aw = planes[0].shape
    for ch, comp in enumerate(comps):
        coeffs = dwt_forward(comp.astype(np.float32) if lossy
                             else comp.astype(np.int32),
                             levels, lossy, qs).astype(np.int32)
        _collect_plane(stats_per_ch[ch], coeffs, aw, ah, levels, bulk)


def probabilities(counts: np.ndarray) -> np.ndarray:
    """counts (..., 2) -> 7-bit P(bit == 0).

    Krichevsky-Trofimov smoothing (+1/2 each symbol) with the 7-bit value
    chosen to minimize the idealized expected codelength
    -c0*log2(p/128) - c1*log2(1-p/128) over p in 1..127. KT keeps
    low-count cells informative instead of snapping them to neutral 64 —
    the previous total<16 cutoff wasted exactly the deep-level /
    high-plane cells where the upstream reference tables still carried
    signal (QUALITY.md r3: trained lost to reference by ~0.4% bpp on the
    natural image before this estimator).
    Unseen cells (no events at all) stay at neutral 64."""
    c0 = counts[..., 0].astype(np.float64) + 0.5
    c1 = counts[..., 1].astype(np.float64) + 0.5
    p = np.arange(1, 128, dtype=np.float64)
    cost = -(c0[..., None] * np.log2(p / 128.0)
             + c1[..., None] * np.log2(1.0 - p / 128.0))
    prob = 1 + np.argmin(cost, axis=-1)
    total = counts.sum(axis=-1)
    return np.where(total < 1, 64, prob).astype(np.int32)


def write_lut_folder(stats_per_ch: list[_Stats], out_dir: str,
                     n_bitplane_files: int = 15):
    stats0 = stats_per_ch[0]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "header.txt"), "w") as f:
        f.write(f"LUT_N_BITPLANES;{stats0.nbp}\nLUT_N_SUBBANDS;3\n"
                "N_CONTEXT_REFINEMENT;1\nN_CONTEXT_SIGN;4\n"
                "N_CONTEXT_SIGNIFICANCE;9\nMULT_PRECISION;7\nLUT_N_FILES;3\n"
                f"AMOUNT_OF_BITPLANE_FILES;{n_bitplane_files}")

    def records(stats: _Stats, normal: np.ndarray, bulk: np.ndarray, s: int):
        """Group file s: normal stats for planes >= s, bulk stats (entry
        s-1) for planes < s — the consecutiveBitplanes == s trajectory."""
        lines = []
        for g in range(normal.shape[0]):
            level, subband = (divmod(g, 3) if g < stats.levels * 3
                              else (stats.levels, 0))
            for bp in range(stats.nbp):
                src = normal[g, bp] if bp >= s else bulk[s - 1, g, bp]
                vals = probabilities(src)
                lines.append(f"{level} {subband} {bp} : "
                             + " ".join(str(int(v)) for v in vals))
        return "\n".join(lines) + "\n"

    for stem, norm_name, bulk_name in (("ref", "ref", "bref"),
                                       ("sig", "sig", "bsig"),
                                       ("sign", "sign", "bsign")):
        for ch, suffix in zip(range(3), ("R", "G", "B")):
            st = stats_per_ch[ch]
            for s in range(n_bitplane_files + 1):
                text = records(st, getattr(st, norm_name),
                               getattr(st, bulk_name), s)
                with open(os.path.join(out_dir,
                                       f"{stem}{suffix}.txt_{s}"), "w") as f:
                    f.write(text)


def synthetic_ensemble(rng, count=12, size=512, video=False):
    """Natural-image stand-ins: correlated RGB base + sensor-like noise.

    Diversity matters more than realism here: tables trained on only
    ultra-smooth images predict P(bit=0) ~ 127/128 at the low bitplanes
    and EXPAND noisy images (a 1 under p=127 costs ~7 bits), ending up
    worse than neutral. Mixing correlation lengths, noise amplitudes and
    edge content keeps every (plane, context) cell honestly populated;
    the heavier edge share targets the class where the reference tables
    used to win (QUALITY.md)."""
    out = []
    # (luma corr length, noise amp, edge style): 0=none 1=blocks 2=diag
    specs = [(2, 0.0, 0), (4, 2.0, 1), (8, 4.0, 0), (16, 8.0, 2),
             (32, 1.0, 1), (2, 8.0, 0), (8, 16.0, 2), (4, 0.5, 1),
             (16, 2.0, 0), (6, 1.0, 2), (24, 4.0, 1), (3, 2.0, 2),
             (8, 8.0, 0), (4, 12.0, 0),
             # smooth-isotropic members (round 4): the natural-image class
             # is dominated by long-correlation low-noise content, and the
             # r3 ensemble under-weighted it — trained tables tied but
             # did not beat the upstream ones there (QUALITY.md r3)
             (20, 1.5, 0), (28, 2.0, 0), (24, 2.0, 0), (12, 2.0, 0),
             (32, 3.0, 0), (18, 1.0, 0)]
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(count):
        sigma, namp, edge = specs[i % len(specs)]

        def field(corr):
            noise = rng.normal(0, 1, size=(size, size))
            f = np.fft.fft2(noise)
            fy = np.fft.fftfreq(size)[:, None]
            fx = np.fft.fftfreq(size)[None, :]
            # video ensemble: anisotropic correlation (horizontal motion
            # blur, the dominant statistic of the reference's
            # video_{lossless,lossy} content class)
            cx = corr * (3.0 if video else 1.0)
            filt = np.exp(-((fx * cx) ** 2 + (fy * corr) ** 2)
                          * (size / 8) ** 2)
            img = np.real(np.fft.ifft2(f * filt))
            return (img - img.min()) / max(np.ptp(img), 1e-9)

        luma = field(sigma) * 255.0
        if edge == 1:      # piecewise content: hard edges every ~96 px
            luma = np.where(((yy // 96) + (xx // 96)) % 2 == 0, luma,
                            255.0 - luma)
        elif edge == 2:    # diagonal ridges + a disc (curved edges)
            luma = np.where(((yy + xx) // 64) % 2 == 0, luma, 255.0 - luma)
            disc = ((yy - size // 2) ** 2 + (xx - size // 2) ** 2
                    < (size // 4) ** 2)
            luma = np.where(disc, 255.0 - luma, luma)
        # chroma: strongly correlated with low-frequency color casts
        cr = (field(max(sigma * 2, 8)) - 0.5) * 80.0
        cb = (field(max(sigma * 2, 8)) - 0.5) * 80.0
        r = luma + cr
        g = luma - 0.3 * cr - 0.3 * cb
        b = luma + cb
        img = np.stack([r, g, b], axis=-1)
        img = img + rng.normal(0, namp, size=img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def smooth_gray(rng, size: int, sigma: float, noise: float,
                edge: int = 0) -> np.ndarray:
    """Grayscale member at an arbitrary geometry, optional edge overlay.

    Large-geometry trainer input (--big-gray): level/subband statistics
    shift with image size (a 2048^2 plane at wl=5 populates the deep
    levels with far more energy than a 512^2 one), and tables trained at
    512 only lose to the upstream reference tables at the BASELINE
    config 2 geometry (QUALITY.md r4, 3.469 vs 3.446 bpp). `edge` mirrors
    the 512 ensemble's overlays (0=none, 1=blocks, 2=diag+disc) — all-
    smooth big members measurably dilute the edge-class statistics."""
    n = rng.normal(0, 1, size=(size, size))
    f = np.fft.fft2(n)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    img = np.real(np.fft.ifft2(
        f * np.exp(-(fx ** 2 + fy ** 2) * (sigma * size / 8) ** 2)))
    img = (img - img.min()) / max(np.ptp(img), 1e-9) * 255
    yy, xx = np.mgrid[0:size, 0:size]
    cell = size * 3 // 16
    if edge == 1:
        img = np.where(((yy // cell) + (xx // cell)) % 2 == 0, img,
                       255.0 - img)
    elif edge == 2:
        img = np.where(((yy + xx) // (size // 8)) % 2 == 0, img,
                       255.0 - img)
        disc = ((yy - size // 2) ** 2 + (xx - size // 2) ** 2
                < (size // 4) ** 2)
        img = np.where(disc, 255.0 - img, img)
    return np.clip(img + rng.normal(0, noise, img.shape), 0,
                   255).astype(np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--lossy", action="store_true")
    ap.add_argument("--qs", type=float, default=1.0)
    ap.add_argument("--bitplanes", type=int, default=15)
    ap.add_argument("--images", nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--count", type=int, default=14)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--no-bulk", action="store_true",
                    help="skip bitplane-group (bulk mode) statistics; "
                         "group files fall back to the normal-scan tables")
    ap.add_argument("--video", action="store_true",
                    help="video-content ensemble (horizontal motion blur; "
                         "the analogue of LUT/video_{lossless,lossy})")
    ap.add_argument("--big-gray", type=int, default=0,
                    help="additional smooth-class grayscale images at "
                         "2048^2 (large-geometry level/subband statistics)")
    ap.add_argument("--big-scale", type=int, default=8,
                    help="weight ratio: the 512 ensemble's counts are "
                         "multiplied by this before the big-geometry "
                         "counts are added, so the big images inform the "
                         "cells only they populate without swamping the "
                         "class mix of the shared cells (a 2048^2 image "
                         "carries ~16x the blocks of a 512^2 one)")
    args = ap.parse_args()

    stats = [_Stats(args.levels, args.bitplanes) for _ in range(3)]
    bulk = not args.no_bulk
    t0 = time.time()
    if args.images:
        for p in args.images:
            collect_gray(stats, read_pgm(p), args.levels, args.lossy,
                         args.qs, bulk)
            print(f"  {p}: done ({time.time() - t0:.0f}s)", flush=True)
    else:
        ens = synthetic_ensemble(np.random.default_rng(args.seed),
                                 count=args.count, size=args.size,
                                 video=args.video)
        for i, img in enumerate(ens):
            collect_rgb(stats, img, args.levels, args.lossy, args.qs, bulk)
            print(f"  image {i + 1}/{len(ens)}: done "
                  f"({time.time() - t0:.0f}s)", flush=True)
        big_rng = np.random.default_rng(args.seed + 1000)
        # class-mixed large-geometry members: all-smooth big images carry
        # ~1024 blocks each and would swamp the 512 ensemble's statistics
        # toward smooth content (measured: noisy-class bpp regressed from
        # 5.53 to 5.70 with 3 smooth-only big members; edge-free big
        # members then cost the edge class ~0.6% — hence the overlays)
        big_specs = [(24, 1.5, 0), (4, 8.0, 0), (12, 2.0, 1),
                     (8, 3.0, 2), (28, 2.0, 0), (6, 6.0, 1)]
        if args.big_gray:
            # scale the ensemble's counts up FIRST (integer-exact
            # downweighting of the big images relative to it)
            for st in stats:
                for name in ("sig", "sign", "ref", "bsig", "bsign",
                             "bref"):
                    getattr(st, name)[...] *= args.big_scale
        for j in range(args.big_gray):
            # seeds disjoint from the 512 ensemble AND the held-out
            # evaluation images (tools/quality_report.py uses seed 42).
            # Collected into a temp and ADDED to every channel —
            # collect_gray's pooling would overwrite the per-channel RGB
            # statistics gathered above.
            sigma, noise, edge = big_specs[j % len(big_specs)]
            img = smooth_gray(big_rng, 2048, sigma=sigma, noise=noise,
                              edge=edge)
            tmp = _Stats(args.levels, args.bitplanes)
            collect_gray([tmp], img, args.levels, args.lossy, args.qs,
                         bulk)
            for st in stats:
                for name in ("sig", "sign", "ref", "bsig", "bsign",
                             "bref"):
                    getattr(st, name)[...] += getattr(tmp, name)
            print(f"  big-gray {j + 1}/{args.big_gray}: done "
                  f"({time.time() - t0:.0f}s)", flush=True)
    if args.no_bulk:
        for st in stats:
            # neutral-free fallback: reuse normal stats for every group
            st.bsig[:] = st.sig[None]
            st.bsign[:] = st.sign[None]
            st.bref[:] = st.ref[None]
    write_lut_folder(stats, args.out)
    print(f"wrote LUT folder {args.out} "
          f"({stats[0].sig.sum():.0f} Y significance events, "
          f"{time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
