"""Device trace of one warm lossless round trip, reduced to launch counts.

    python tools/trace_roundtrip.py [--size 2048] [--levels 5]
                                    [--out traces/roundtrip]

Warms a TPUCodec round trip (trained lossless LUTs, the gray image of
chip_smoke.py's first phase), then captures one encode and one decode under
`obs.trace.device_trace`, each inside its own `jax.profiler`
annotation. The trace is reduced to, per direction:

  launches      device operations (kernels, copies, memsets) on the GPU
                streams whose start lies inside the direction's host window
  kernels       the launches that are kernels (not memcpy/memset)
  d2h_copies    device-to-host copies; XLA:GPU copies a while loop's
                predicate to the host once per iteration
  graph_launches  CUDA graph launches issued by the host (command buffers)
  busy_ms       union of the operations' device intervals
  idle_share    1 - busy / host window

and prints one JSON line. It refuses to run without a GPU: a CPU trace
has no device streams to count.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COPY_WORDS = ("memcpy", "memset")


def union_ns(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(ops, host, window) -> dict:
    """Reduce trace events to one direction's metrics.

    ops: (name, start_ns, end_ns) on GPU streams; host: the same for host
    threads; window: (start_ns, end_ns) of the direction's host span."""
    w0, w1 = window
    inside = [(n, s, e) for n, s, e in ops if w0 <= s < w1]
    busy = union_ns([(max(s, w0), min(e, w1)) for _, s, e in inside])
    kernels = [n for n, _, _ in inside
               if not any(w.lower() in n.lower() for w in COPY_WORDS)]
    return {"launches": len(inside), "kernels": len(kernels),
            "d2h_copies": sum(1 for n, _, _ in inside if n == "MemcpyD2H"),
            "graph_launches": sum(1 for n, s, _ in host if w0 <= s < w1
                                  and n.startswith("cuGraphLaunch")),
            "window_ms": (w1 - w0) / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / max(w1 - w0, 1.0)}


def read_trace(log_dir: str):
    """-> (host spans by name, stream ops, host events, line inventory)."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    spans, ops, host, lines = {}, [], [], {}
    for plane in ProfileData.from_file(path).planes:
        for line in plane.lines:
            events = [(e.name, e.start_ns, e.end_ns) for e in line.events]
            if plane.name.startswith("/device:GPU"):
                lines[f"{plane.name}|{line.name}"] = len(events)
                if "Stream" in line.name:
                    ops += events
            elif plane.name.startswith("/host"):
                host += events
                for name, s, e in events:
                    if name.startswith("roundtrip/"):
                        spans[name] = (s, e)
    return spans, ops, host, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--out", default="traces/roundtrip")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"trace_roundtrip: needs a GPU, JAX backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    from bench import make_image
    from chip_smoke import LUTS
    from picsong_tpu.core.header import CodecConfig
    from picsong_tpu.core.lut import load_luts
    from picsong_tpu.engine.pipeline import TPUCodec
    from picsong_tpu.obs.trace import device_trace

    cfg = CodecConfig(width=args.size, height=args.size,
                      wavelet_levels=args.levels)
    luts, params = load_luts(os.path.join(LUTS, "trained_lossless"),
                             args.levels, 2, 0.0)
    codec = TPUCodec(cfg, luts, params)
    img = make_image(args.size, args.size, seed=1)
    for _ in range(3):                                 # compile + warm
        streams = codec.encode(img)
        assert np.array_equal(codec.decode(streams), img)
    with device_trace(args.out):
        with jax.profiler.TraceAnnotation("roundtrip/encode"):
            streams = codec.encode(img)
        with jax.profiler.TraceAnnotation("roundtrip/decode"):
            out = codec.decode(streams)
    assert np.array_equal(out, img)

    spans, ops, host, lines = read_trace(args.out)
    dev = jax.devices()[0]
    rec = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "size": args.size, "levels": args.levels,
           "encode": summarize(ops, host, spans["roundtrip/encode"]),
           "decode": summarize(ops, host, spans["roundtrip/decode"]),
           "device_lines": lines}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
