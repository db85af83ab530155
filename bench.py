"""Benchmark harness: MPixels/s/chip for encode+decode round trips.

Runs the jitted single-device pipeline on the default accelerator over
the BASELINE workload family and prints one JSON line:

  {"metric": ..., "value": N, "unit": "MPixels/s", "vs_baseline": N,
   "extra": {...}}

The reference publishes no numbers (BASELINE.md), so vs_baseline is
reported against the BASELINE.json north-star acceptance value of
100 MPixels/s/chip for a lossless 5/3 + BPC round trip.

`value` is the headline config (lossless 5/3, 2048x2048, wl=5 — BASELINE
config 1). A default run additionally times the whole recorded surface:

  lossy97_2048      BASELINE config 2 (9/7 + quantization)
  quick_512         the dispatch-overhead regime (512^2, wl=1)
  packed_2048       round trip THROUGH the device-side BitStreamBuilder
  cs_k5_2048        complexity scalability (-k 5) round trip
  lossless53_8192   BASELINE config 3 (8K single image)
  lossy97_8192      BASELINE config 3, lossy path
  video_1080p       BASELINE config 4 (frames/s; wall AND compute fps)

Budget: the run carries a wall-clock budget (PICSONG_BENCH_BUDGET_S,
default 1140 s). Extras are priority-ordered and skipped with a recorded
reason once their share of the budget is spent; a daemon watchdog prints
the JSON line from whatever has completed and exits non-zero if anything
(e.g. a compile, which cannot be interrupted from Python) overruns the
budget. The JSON line is emitted on EVERY path, and carries the card's
name and power limit (nvidia-smi). The exit code is non-zero when the
budget ran out or a verification failed; a measuring process that finds
no GPU exits non-zero before timing anything.

Flags:
  --size N       image edge (default 2048)
  --levels N     wavelet levels (default 5)
  --lossy        benchmark the 9/7 + quantization path
  --iters N      timed iterations (default 10)
  --quick        512x512, 1 level, 2 iters (smoke test)
  --packed       round trip through encode_packed/unpack_dense
  --video        run ONLY the video config (full cold+warm protocol)
  --no-extras    headline config only (single-config runs imply this)

Timing: per-iteration blocked timing with ONE round trip in flight,
medians reported; large geometries run through the engine's chunked
codeblock batches. All configs compile + warm + time first and every
correctness check runs after. The JSON line reports which encoder/decoder
path ran, per-sample times and the mean, so a silent path flip or an
async leak is visible from the recorded line alone.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

BASELINE_MPS = 100.0  # acceptance floor, MPixels/s/chip round trip

# -- wall-clock budget ------------------------------------------------------

_T0 = time.monotonic()
BUDGET_S = float(os.environ.get("PICSONG_BENCH_BUDGET_S", "1140"))


def elapsed() -> float:
    return time.monotonic() - _T0


def remaining() -> float:
    return BUDGET_S - elapsed()


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"


# Incrementally-built record; the watchdog snapshots it on budget overrun.
RESULTS: dict = {"configs": {}, "head": None, "single": False}
_EMIT_LOCK = threading.Lock()
_EMITTED = False


def _snapshot() -> dict:
    """Build the final JSON record from whatever has completed so far."""
    head = RESULTS.get("head")
    rec: dict = {}
    if RESULTS.get("head_rec"):          # suite mode: headline from a child
        rec.update(RESULTS["head_rec"])
    elif head is not None and head.samples_ms:
        rec.update({
            "metric": RESULTS["metric"],
            "value": round(head.mpix, 3),
            "unit": "MPixels/s",
            "vs_baseline": round(head.mpix / BASELINE_MPS, 4),
            "median_ms": round(head.median_ms, 3),
            "mean_ms": round(head.chained_ms, 3),
            "samples_ms": [round(s, 3) for s in head.samples_ms],
            "verified": head.verified is True,
        })
        if head.error:
            rec["error"] = head.error
    else:
        rec.update({
            "metric": RESULTS.get("metric", "MPixels/s/chip encode+decode"),
            "value": 0.0, "unit": "MPixels/s", "vs_baseline": 0.0,
            "error": (head.error if head is not None and head.error
                      else "headline config did not complete in budget"),
        })
    try:
        from picsong_tpu.engine.pipeline import _decoder_mode, _encoder_mode
        from picsong_tpu.entropy.bpc_jax import _pair_enabled
        rec["encoder"] = _encoder_mode()
        rec["decoder"] = _decoder_mode()
        rec["paired"] = _pair_enabled()
        rec["plane_group"] = os.environ.get("PICSONG_STAGED_GROUP",
                                            "adaptive")
    except Exception:  # noqa: BLE001 — never block the record on imports
        pass
    rec["card"] = card()
    rec["budget_s"] = BUDGET_S
    rec["elapsed_s"] = round(elapsed(), 1)
    for k in ("phase1_s", "video_done_s"):
        if k in RESULTS:
            rec[k] = RESULTS[k]
    if not RESULTS["single"]:
        rec["extra"] = dict(RESULTS["configs"])
    return rec


def emit(final: bool) -> int:
    """Print the ONE JSON line exactly once, from main or the watchdog.

    Returns the process exit code: non-zero unless the headline and every
    recorded config verified (a config skipped for budget is not a
    failure)."""
    global _EMITTED
    with _EMIT_LOCK:
        if _EMITTED:
            return 1
        _EMITTED = True
        rec = _snapshot()
        if not final:
            rec["budget_exceeded"] = True
        print(json.dumps(rec), flush=True)
    if not final:
        os._exit(1)  # a hung device call cannot be interrupted
    return 1 if failed(rec) else 0


def failed(rec: dict) -> bool:
    """True when the headline or any recorded config did not verify."""
    if rec.get("verified") is not True or rec.get("budget_exceeded"):
        return True
    for r in rec.get("extra", {}).values():
        if "skipped" in r:
            continue
        if ("error" in r or r.get("budget_exceeded")
                or r.get("verified", True) is not True
                or r.get("lossless_bitexact") is False):
            return True
    return False


def _start_watchdog() -> None:
    def run():
        while True:
            left = remaining()
            if left <= 0:
                break
            time.sleep(min(left, 5.0))
        emit(final=False)

    threading.Thread(target=run, daemon=True).start()


def make_image(height: int, width: int | None = None,
               seed: int = 0) -> np.ndarray:
    """8-bit synthetic content: smooth structure plus sensor noise."""
    width = height if width is None else width
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(height, width)))
    return np.clip(base, 0, 255).astype(np.uint8)


class Config:
    """One benchmark configuration: build/warm/time now, verify later."""

    def __init__(self, name: str, size: int, levels: int, lossy: bool,
                 iters: int, packed: bool = False, k: float = 0.0,
                 min_budget_s: float = 0.0):
        self.name, self.size, self.levels = name, size, levels
        self.lossy, self.iters, self.packed = lossy, iters, packed
        self.k = k
        # skip this config unless at least this much budget remains when
        # its turn comes (rough cold-compile + timing cost ceiling)
        self.min_budget_s = min_budget_s
        self.samples_ms: list[float] = []
        self.error: str | None = None
        self.skipped: str | None = None
        self.verified: bool | None = None

    def build(self):
        import jax.numpy as jnp

        from picsong_tpu.core.header import CodecConfig
        from picsong_tpu.core.lut import LUTParams, neutral_lut
        from picsong_tpu.engine.pipeline import TPUCodec

        cfg = CodecConfig(width=self.size, height=self.size,
                          wavelet_levels=self.levels, is_lossy=self.lossy,
                          qs=1.0, k_factor=self.k)
        params = LUTParams()
        lut = neutral_lut(params, cfg.wavelet_levels, cfg.coding_passes,
                          n_groups=params.n_bitplane_files if self.k else 1)
        self.codec = TPUCodec(cfg, [lut], params)
        img = make_image(self.size)
        self.n_planes = self.codec.planes_host(img)
        self.plane = jnp.asarray(self.codec._prep_gray(jnp.asarray(img)))
        if self.packed:
            # bucket: static dense-payload capacity in uint16 words. The
            # synthetic image compresses ~2x, so half the raw size plus
            # slack; overflow is checked post-timing and reported.
            self.bucket = self.size * self.size // 2 + (1 << 16)

    def roundtrip(self, plane):
        codec, lut = self.codec, self.codec.luts[0]
        if self.packed:
            import jax.numpy as jnp
            st = codec._staged
            blocks, _ = codec._dwt_tile(plane)
            sizes, msb, dense = st.encode_packed(
                blocks, lut, codec._meta, self.n_planes, self.bucket)
            streams = st.unpack_dense(dense, sizes,
                                      msb.astype(jnp.int32))
            blocks = st.decode(streams, sizes.astype(jnp.int32), lut,
                               codec._meta, self.n_planes)
            self._sizes = sizes
            return codec._untile_idwt(blocks)
        streams, sizes = codec._encode_plane(plane, lut, self.n_planes)
        return codec._decode_plane(streams, sizes, lut, self.n_planes)

    def seal(self):
        """Reduce the verify evidence to device scalars and FREE the big
        buffers (out/plane: 2 x 16.8 MB at 2048^2, 2 x 268 MB at 8K).

        Runs right after the timed loop and enqueues only tiny comparison
        programs, so the configs' planes and outputs are not held live
        through the later phases; after seal() each verify is a 4-byte
        scalar read."""
        import jax.numpy as jnp
        if self.packed:
            self._used_dev = (jnp.sum(self._sizes.astype(jnp.int64))
                              - self._sizes.shape[0])
            self._sizes = None
        if not self.lossy:
            self._ok_dev = jnp.array_equal(self.out, self.plane)
        else:
            err = self.out.astype(jnp.float32) - self.plane
            self._rms_dev = jnp.sqrt(jnp.mean(err * err))
        self.out = None
        self.plane = None

    def warm_and_time(self):
        """Per-iteration blocked timing, one round trip in flight.

        Big-geometry configs run through the engine's chunked codeblock
        batches. Medians over samples_ms are robust to the occasional
        outlier sample."""
        out = self.roundtrip(self.plane)
        out.block_until_ready()           # compile + warm up
        self.out = out                    # single-pass result for verify()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            ts = time.perf_counter()
            out = self.roundtrip(self.plane)
            out.block_until_ready()
            self.samples_ms.append((time.perf_counter() - ts) * 1e3)
        self.chained_ms = (time.perf_counter() - t0) * 1e3 / self.iters

    def verify(self):
        """Runs AFTER every config's timed loop.

        The comparisons were enqueued on device by seal(); each verify
        downloads one scalar instead of a full plane (see seal())."""
        if self.packed:
            used = int(self._used_dev)
            if used > self.bucket:
                raise AssertionError(
                    f"dense bucket overflow: {used} > {self.bucket}")
        if not self.lossy:
            if not bool(self._ok_dev):
                raise AssertionError("lossless round trip not bit-exact")
        else:
            rms = float(self._rms_dev)
            if rms > 4.0:
                raise AssertionError(f"lossy reconstruction RMS {rms:.2f}")
        self.verified = True

    @property
    def median_ms(self) -> float:
        return sorted(self.samples_ms)[len(self.samples_ms) // 2]

    @property
    def mpix(self) -> float:
        return self.size * self.size / (self.median_ms / 1e3) / 1e6

    def report(self) -> dict:
        if self.skipped:
            return {"skipped": self.skipped}
        if self.error and not self.samples_ms:
            return {"error": self.error}
        rec = {"mpix_s": round(self.mpix, 3),
               "median_ms": round(self.median_ms, 3),
               "mean_ms": round(self.chained_ms, 3),
               "samples_ms": [round(s, 3) for s in self.samples_ms]}
        if self.verified is not True:
            rec["verified"] = (self.error if self.error
                               else "skipped (budget)")
        return rec


class VideoBench:
    """BASELINE config 4 evidence: video frames/s through the batched
    pipelined engine (engine/video.py).

    Runs LAST, after the image configs' timed loops.

    Budget-adaptive protocol: one encode + one decode always (cold); a
    second warm encode/decode pair runs only if its projected cost fits
    the remaining budget. The record carries BOTH the wall fps and the
    enqueue-side fps (frames / compute_s), with the stage timers
    (download_s et al.) beside them."""

    name = "video_1080p"

    def __init__(self, frames: int = 16, width: int = 1920,
                 height: int = 1080, batch: int = 8, full: bool = False):
        self.frames, self.width, self.height = frames, width, height
        self.batch = batch
        self.full = full  # --video: unconditional cold+warm pairs
        self.rec: dict = {}  # mutated in place; see _run

    def run(self) -> dict:
        from picsong_tpu.core.header import CodecConfig
        from picsong_tpu.core.lut import LUTParams, neutral_lut
        from picsong_tpu.engine.video import decode_video, encode_video

        params = LUTParams()
        cfg = CodecConfig(width=self.width, height=self.height,
                          wavelet_levels=3, frames=self.frames)
        lut = neutral_lut(params, cfg.wavelet_levels, cfg.coding_passes)
        tmp = tempfile.mkdtemp(prefix="picsong_vbench_")
        try:
            return self._run(tmp, cfg, lut, params,
                             encode_video, decode_video)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _run(self, tmp, cfg, lut, params, encode_video, decode_video):
        raw = f"{tmp}/v.raw"
        base = make_image(2048)[:self.height, :self.width]
        rng = np.random.default_rng(1)
        with open(raw, "wb") as f:
            for i in range(self.frames):
                frame = np.roll(base, 7 * i, axis=1)
                frame = np.clip(frame.astype(np.int16)
                                + rng.integers(-4, 5, frame.shape), 0,
                                255).astype(np.uint8)
                f.write(frame.tobytes())
        enc = f"{tmp}/v.enc"
        dec = f"{tmp}/v_dec.raw"
        kw = dict(frames=self.frames, batch=self.batch)

        def fps(stats):
            return round(self.frames / max(stats.wall_s, 1e-9), 3)

        def cfps(stats):
            return round(self.frames / max(stats.compute_s, 1e-9), 3)

        def detail(st):
            return {k: round(getattr(st, k, 0.0), 3)
                    for k in ("wall_s", "compute_s", "download_s",
                              "reader_stall_s", "writer_stall_s")}

        # self.rec is registered in RESULTS BEFORE the runs and mutated
        # in place, so a watchdog firing mid-video still records every
        # completed sub-run instead of dropping the video evidence
        rec = self.rec
        rec.update({
            "frames": self.frames, "batch": self.batch,
            "geometry": f"{self.width}x{self.height} gray wl=3 lossless",
            "status": "encode running",
        })
        e1 = encode_video(raw, enc, cfg, [lut], params, **kw)
        rec.update({
            "encode_fps": fps(e1), "encode_fps_compute": cfps(e1),
            "encode_stats": detail(e1), "status": "decode pending",
            # wall fps includes D2H (download_s); the compute fps counts
            # only the compute loop's dispatch+enqueue time
            "fps_note": ("wall fps includes download_s; "
                         "*_compute = frames/compute_s"),
        })
        # warm encode only if its projected cost fits the budget
        if self.full or remaining() > 2.0 * e1.wall_s + 60:
            e2 = encode_video(raw, enc, cfg, [lut], params, **kw)
            rec["encode_fps_warm"] = fps(e2)
            rec["encode_fps_warm_compute"] = cfps(e2)
            rec["encode_stats_warm"] = detail(e2)
        d1 = decode_video(enc, dec, cfg, [lut], params, batch=self.batch)
        rec["decode_fps"] = fps(d1)
        rec["decode_fps_compute"] = cfps(d1)
        rec["decode_stats"] = detail(d1)
        if self.full or remaining() > 2.0 * d1.wall_s + 30:
            d2 = decode_video(enc, dec, cfg, [lut], params,
                              batch=self.batch)
            rec["decode_fps_warm"] = fps(d2)
            rec["decode_fps_warm_compute"] = cfps(d2)
        with open(raw, "rb") as f, open(dec, "rb") as g:
            exact = f.read() == g.read()
        rec["lossless_bitexact"] = exact
        rec.pop("status", None)
        if not exact:
            rec["error"] = "video round trip not bit-exact"
        return rec


# -- subprocess suite (default run) ------------------------------------------
#
# Every config runs in a FRESH SUBPROCESS, one after another, so exactly one
# process holds the device at a time; the parent never touches the device.
# Each child verifies inside its own budget and emits the same one-line
# JSON this file always emits; the parent assembles the records.
# PICSONG_BENCH_INPROC=1 runs the whole suite in one process instead.

SUITE = [
    # (name, child flags, min remaining seconds to attempt it)
    ("quick_512", ["--quick", "--iters", "10"], 120),
    ("lossy97_2048", ["--lossy"], 150),
    ("packed_2048", ["--packed"], 150),
    ("cs_k5_2048", ["--k", "5"], 200),
    ("lossless53_8192", ["--size", "8192", "--iters", "5"], 280),
    ("lossy97_8192", ["--size", "8192", "--lossy", "--iters", "5"], 280),
]

# parent seconds held back from every child budget so the video config
# always gets a shot (the video child itself adapts to what is left)
VIDEO_RESERVE_S = 200.0


def _run_child(extra_args, child_budget: float) -> dict:
    """Run one config in a fresh process; return its parsed JSON line."""
    import subprocess
    child_budget = max(child_budget, 60.0)
    env = dict(os.environ, PICSONG_BENCH_BUDGET_S=f"{child_budget:.0f}")
    cmd = [sys.executable, os.path.abspath(__file__)] + list(extra_args)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=child_budget + 120, env=env)
    except subprocess.TimeoutExpired:
        return {"error": f"child timeout after {child_budget + 120:.0f}s "
                         "(budget watchdog did not fire)"}
    line = None
    for ln in (proc.stdout or "").splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            line = ln                     # last JSON line wins
    if line is None:
        tail = (proc.stderr or "").strip().splitlines()[-1:]
        return {"error": f"child rc={proc.returncode}, no JSON line; "
                         f"stderr tail: {tail}"}
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return {"error": "child emitted an unparsable JSON line"}


def _child_report(rec: dict) -> dict:
    """Map a child's headline record to the extras-dict report shape."""
    if "value" not in rec:
        return {"error": rec.get("error", "child produced no record")}
    rep = {"mpix_s": rec.get("value"), "median_ms": rec.get("median_ms"),
           "mean_ms": rec.get("mean_ms"),
           "samples_ms": rec.get("samples_ms")}
    if rec.get("verified") is not True:
        rep["verified"] = rec.get("error", "unverified")
    if rec.get("budget_exceeded"):
        rep["budget_exceeded"] = True
    return rep


def run_suite(args) -> int:
    """Default run: headline + extras + video, one subprocess each."""
    RESULTS["single"] = False
    RESULTS["metric"] = ("MPixels/s/chip encode+decode lossless53 "
                         "2048x2048")

    def child_budget():
        return min(remaining() - VIDEO_RESERVE_S, 600.0)

    head_rec = _run_child(["--size", "2048", "--iters", str(args.iters)],
                          child_budget())
    hr = {k: head_rec[k] for k in
          ("metric", "value", "unit", "vs_baseline", "median_ms",
           "mean_ms", "samples_ms", "verified", "error", "encoder",
           "decoder", "paired", "plane_group") if k in head_rec}
    if "value" not in hr:
        hr.update({"metric": RESULTS["metric"], "value": 0.0,
                   "unit": "MPixels/s", "vs_baseline": 0.0,
                   "error": head_rec.get("error", "headline child failed")})
    RESULTS["head_rec"] = hr
    RESULTS["configs"]["lossless53_2048"] = _child_report(head_rec)

    for name, flags, need in SUITE:
        if remaining() < need + VIDEO_RESERVE_S:
            RESULTS["configs"][name] = {
                "skipped": f"budget: {remaining():.0f}s left < "
                           f"{need + VIDEO_RESERVE_S:.0f}s needed"}
            continue
        RESULTS["configs"][name] = _child_report(
            _run_child(flags, child_budget()))
    RESULTS["phase1_s"] = round(elapsed(), 1)

    if remaining() < 120:
        RESULTS["configs"]["video_1080p"] = {
            "skipped": f"budget: {remaining():.0f}s left"}
    else:
        rec = _run_child(["--video", "--video-frames", "16"],
                         remaining() - 30)
        RESULTS["configs"]["video_1080p"] = rec.get("extra", {}).get(
            "video_1080p",
            rec if "error" in rec else {"error": "no video record"})
    RESULTS["video_done_s"] = round(elapsed(), 1)
    return emit(final=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--lossy", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--k", type=float, default=0.0,
                    help="complexity-scalability factor (bulk bitplanes)")
    ap.add_argument("--video", action="store_true",
                    help="run ONLY the video frames/s config")
    ap.add_argument("--video-frames", type=int, default=32)
    ap.add_argument("--no-extras", action="store_true")
    args = ap.parse_args()

    _start_watchdog()
    single = (args.size is not None or args.quick or args.lossy
              or args.packed or args.no_extras or args.k > 0)
    suite = not (args.video or single
                 or os.environ.get("PICSONG_BENCH_INPROC") == "1")
    if not suite:
        # the measuring process needs a GPU; the suite parent only spawns
        # children and must not open the device itself
        import jax
        if jax.default_backend() != "gpu":
            print(f"bench: needs a GPU, JAX backend is "
                  f"{jax.default_backend()!r}", file=sys.stderr)
            return 1

    if args.video:
        global _EMITTED
        vb = VideoBench(frames=args.video_frames, full=True)
        rec = vb.run()
        with _EMIT_LOCK:
            if _EMITTED:
                return 1
            _EMITTED = True
            print(json.dumps({
                "metric": "video frames/s 1080p gray encode+decode",
                "value": rec["encode_fps"], "unit": "frames/s",
                "vs_baseline": rec["encode_fps"] / 24.0,  # realtime 24fps
                "card": card(), "extra": {vb.name: rec}}), flush=True)
        return 1 if "error" in rec or not rec["lossless_bitexact"] else 0

    if suite:
        return run_suite(args)
    RESULTS["single"] = single
    if args.quick:
        size, levels = 512, 1
        iters = 2 if args.iters == 10 else args.iters
    else:
        size, levels, iters = args.size or 2048, args.levels, args.iters

    mode = "lossy97" if args.lossy else "lossless53"
    if args.k > 0:
        mode = f"cs_k{args.k:g}_{mode}"
    RESULTS["metric"] = (f"MPixels/s/chip encode+decode {mode} "
                         f"{size}x{size}" + (" packed" if args.packed
                                             else ""))
    head = Config(f"{mode}_{size}", size, levels, args.lossy, iters,
                  packed=args.packed, k=args.k)
    RESULTS["head"] = head
    configs = [head]
    if not single:
        # priority order; min_budget_s gates each against the remaining
        # budget so a slow compile degrades to fewer configs, never to a
        # missing record
        configs += [
            Config("quick_512", 512, 1, False, max(iters, 10),
                   min_budget_s=120),
            Config("lossy97_2048", 2048, 5, True, iters, min_budget_s=150),
            Config("packed_2048", 2048, 5, False, iters, packed=True,
                   min_budget_s=120),
            Config("cs_k5_2048", 2048, 5, False, iters, k=5.0,
                   min_budget_s=200),
            Config("lossless53_8192", 8192, 5, False,
                   max(iters // 2, 3), min_budget_s=280),
            Config("lossy97_8192", 8192, 5, True, max(iters // 2, 3),
                   min_budget_s=280),
        ]

    # reserve a slice of the budget for the verify and video phases
    verify_reserve = 0.45 * BUDGET_S

    # Phase 1: build + warm + time (planes_host is a CPU-backend replica,
    # not a device read).
    for c in configs:
        if c is not head:
            need = max(c.min_budget_s, 0) + verify_reserve
            if remaining() < need:
                c.skipped = (f"budget: {remaining():.0f}s left < "
                             f"{need:.0f}s needed")
                RESULTS["configs"][c.name] = c.report()
                continue
        try:
            c.build()
            c.warm_and_time()
            c.seal()
        except Exception as e:                      # noqa: BLE001
            c.error = f"{type(e).__name__}: {e}"
            if c is head:
                # still emit the one JSON line (rc stays 0; the error is
                # in the record) — a missing record scores as no benchmark
                return emit(final=True)
        RESULTS["configs"][c.name] = c.report()

    RESULTS["phase1_s"] = round(elapsed(), 1)

    # Phase 2a: verify the HEADLINE config first, so the headline carries
    # verified=true even when the video phase consumes the rest of the
    # budget. Phase 2b: video frames/s (BASELINE config 4).
    if head.error is None and head.samples_ms:
        try:
            head.verify()
        except Exception as e:                      # noqa: BLE001
            head.error = f"{type(e).__name__}: {e}"
            if single:
                return emit(final=True)
    if not single:
        if remaining() < 150:
            RESULTS["configs"]["video_1080p"] = {
                "skipped": f"budget: {remaining():.0f}s left"}
        else:
            vb = VideoBench()
            # live registration: a watchdog firing mid-video still
            # records the completed sub-runs (vb.rec mutates in place)
            RESULTS["configs"]["video_1080p"] = vb.rec
            try:
                vb.run()
            except Exception as e:                   # noqa: BLE001
                vb.rec["error"] = f"{type(e).__name__}: {e}"
    RESULTS["video_done_s"] = round(elapsed(), 1)

    # Phase 3: correctness; each verify is a small comparison program +
    # scalar read.
    for c in configs:
        if c.error or c.skipped or c.verified:
            continue
        if c is not head and remaining() < 30:
            RESULTS["configs"][c.name] = c.report()   # verified: skipped
            continue
        try:
            c.verify()
        except Exception as e:                      # noqa: BLE001
            c.error = f"{type(e).__name__}: {e}"
            if c is head and single:
                return emit(final=True)
        if c is not head:
            RESULTS["configs"][c.name] = c.report()
    return emit(final=True)


if __name__ == "__main__":
    sys.exit(main())
