"""Multi-host frame striping: slab partition, rank-ordered merge equals the
single-host byte stream, scaling-efficiency accounting (BASELINE config 5;
hosts simulated sequentially in one process — the data plane has no
cross-host dependency, so sequential simulation is exact)."""

import numpy as np

from picsong_tpu.core.header import CodecConfig
from picsong_tpu.core.lut import LUTParams, neutral_lut
from picsong_tpu.dist.multihost import (ScalingReport, encode_video_part,
                                        frame_slab, init_distributed,
                                        merge_parts)
from picsong_tpu.engine.video import decode_video, encode_video

PARAMS = LUTParams()


def make_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = (96 + 64 * np.sin(x / 9.0) * np.cos(y / 13.0)
            + rng.normal(0, 8, size=(h, w)))
    return np.clip(base, 0, 255).astype(np.uint8)


def test_frame_slab_partition():
    for frames, hosts in ((10, 3), (8, 8), (5, 8), (2090, 4), (7, 1)):
        ranges = [frame_slab(frames, hosts, h) for h in range(hosts)]
        covered = []
        for start, stop in ranges:
            covered.extend(range(start, stop))
        assert covered == list(range(frames)), (frames, hosts, ranges)
        lens = [stop - start for start, stop in ranges]
        assert max(lens) - min(lens) <= 1   # balanced slabs


def test_init_distributed_single_process():
    assert init_distributed() == (0, 1)


def test_multihost_merge_matches_single_host(tmp_path):
    rng = np.random.default_rng(0)
    frames = [make_image(rng, 64, 128) for _ in range(7)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=7)
    lut = neutral_lut(PARAMS, 1, 2)

    single = str(tmp_path / "single.enc")
    encode_video(raw, single, cfg, [lut], PARAMS, frames=7, batch=2)

    merged = str(tmp_path / "merged.enc")
    hosts = 3
    for h in range(hosts):      # sequential simulation of 3 host processes
        encode_video_part(raw, merged, cfg, [lut], PARAMS, frames=7,
                          num_hosts=hosts, host_id=h, batch=2)
    merge_parts(merged, hosts)

    with open(single, "rb") as f:
        want = f.read()
    with open(merged, "rb") as f:
        got = f.read()
    assert got == want, "rank-ordered merge differs from single-host stream"
    with open(single + "_SIZE") as f:
        want_sizes = f.read()
    with open(merged + "_SIZE") as f:
        got_sizes = f.read()
    assert got_sizes == want_sizes

    dec = str(tmp_path / "dec.raw")
    decode_video(merged, dec, cfg, [lut], PARAMS, batch=2)
    from picsong_tpu.core.image_io import read_raw_frame
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 128, 64, i), fr)


def test_multihost_more_hosts_than_frames(tmp_path):
    rng = np.random.default_rng(1)
    frames = [make_image(rng, 64, 64) for _ in range(2)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=2)
    lut = neutral_lut(PARAMS, 1, 2)
    merged = str(tmp_path / "m.enc")
    for h in range(4):
        encode_video_part(raw, merged, cfg, [lut], PARAMS, frames=2,
                          num_hosts=4, host_id=h, batch=2)
    merge_parts(merged, 4)
    dec = str(tmp_path / "dec.raw")
    decode_video(merged, dec, cfg, [lut], PARAMS, batch=2)
    from picsong_tpu.core.image_io import read_raw_frame
    for i, fr in enumerate(frames):
        assert np.array_equal(read_raw_frame(dec, 64, 64, i), fr)


def test_multihost_decode_slab_matches_single(tmp_path):
    """decode_video_part + merge_raw_parts: per-host slab decode via the
    _SIZE prefix offsets reassembles the exact single-host raw output
    (DecodingEngine.cu:866-1043 analogue)."""
    from picsong_tpu.dist.multihost import decode_video_part, merge_raw_parts

    rng = np.random.default_rng(5)
    frames = [make_image(rng, 64, 128) for _ in range(7)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=128, height=64, wavelet_levels=1, frames=7)
    lut = neutral_lut(PARAMS, 1, 2)
    enc = str(tmp_path / "v.enc")
    encode_video(raw, enc, cfg, [lut], PARAMS, frames=7, batch=2)

    merged = str(tmp_path / "dec.raw")
    hosts = 3
    for h in range(hosts):      # sequential simulation of 3 host processes
        decode_video_part(enc, merged, cfg, [lut], PARAMS,
                          num_hosts=hosts, host_id=h, batch=2)
    merge_raw_parts(merged, hosts)

    single = str(tmp_path / "dec_single.raw")
    decode_video(enc, single, cfg, [lut], PARAMS, batch=2)
    with open(single, "rb") as f:
        want = f.read()
    with open(merged, "rb") as f:
        got = f.read()
    assert got == want, "slab decode merge differs from single-host raw"
    with open(raw, "rb") as f:
        assert got == f.read()       # lossless: decoded == original frames


def test_real_multiprocess_distributed(tmp_path):
    """Spawns TWO actual processes that form a jax.distributed cluster on
    CPU and run the full multihost encode+decode through init_distributed
    + sync_global_devices + rank-0 merges."""
    import os
    import socket
    import subprocess
    import sys

    rng = np.random.default_rng(7)
    frames = [make_image(rng, 64, 64) for _ in range(5)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=5)
    lut = neutral_lut(PARAMS, 1, 2)
    single = str(tmp_path / "single.enc")
    encode_video(raw, single, cfg, [lut], PARAMS, frames=5, batch=2)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, \
                f"worker {pid} failed:\n{out.decode(errors='replace')}"
            assert f"WORKER-OK {pid}" in out.decode(errors="replace")
    finally:
        for p in procs:          # exact-PID cleanup, never by pattern
            if p.poll() is None:
                p.kill()

    with open(single, "rb") as f:
        want = f.read()
    with open(tmp_path / "mp.enc", "rb") as f:
        assert f.read() == want, "multi-process encode differs"
    with open(single + "_SIZE") as f, \
            open(str(tmp_path / "mp.enc") + "_SIZE") as g:
        assert f.read() == g.read()
    with open(tmp_path / "mp_dec.raw", "rb") as f, open(raw, "rb") as g:
        assert f.read() == g.read(), "multi-process decode differs"


def test_scaling_report():
    rep = ScalingReport(frames=100, num_hosts=4,
                        host_wall_s=[2.5, 2.6, 2.4, 2.6],
                        single_host_wall_s=10.0)
    assert abs(rep.aggregate_fps - 100 / 2.6) < 1e-9
    assert abs(rep.efficiency - 10.0 / (4 * 2.6)) < 1e-9
    d = rep.as_dict()
    assert d["efficiency"] > 0.8    # the BASELINE-5 pass criterion shape


def _timed(fn):
    import time
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def test_measured_scaling_efficiency_is_plausible(tmp_path):
    """Warm steady-state efficiency measured on real encodes must land in
    (0, 1.05] — a compile-polluted baseline would report a superlinear
    value. Hosts run sequentially, so superlinear is impossible once
    every program is warm."""
    rng = np.random.default_rng(2)
    n_frames = 16
    frames = [make_image(rng, 64, 64) for _ in range(n_frames)]
    raw = str(tmp_path / "v.raw")
    with open(raw, "wb") as f:
        for fr in frames:
            f.write(fr.tobytes())
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=n_frames)
    lut = neutral_lut(PARAMS, 1, 2)

    import time
    single = str(tmp_path / "single.enc")
    encode_video(raw, single, cfg, [lut], PARAMS, frames=n_frames,
                 batch=4)                                 # warm-up compile

    # min-of-repeats timing: a contention spike during the single-host run
    # (e.g. the rest of the suite on a loaded CI box) would otherwise make
    # sequential identical work look superlinear. The minimum over repeats
    # estimates the uncontended wall for both sides, and the sides take
    # turns within each repeat so a long burst of load hits both alike.
    reps = 5
    merged = str(tmp_path / "m.enc")
    hosts = 2
    singles, walls = [], [[] for _ in range(hosts)]
    for _ in range(reps):
        singles.append(_timed(lambda: encode_video(
            raw, single, cfg, [lut], PARAMS, frames=n_frames, batch=4)))
        for h in range(hosts):
            walls[h].append(_timed(lambda: encode_video_part(
                raw, merged, cfg, [lut], PARAMS, frames=n_frames,
                num_hosts=hosts, host_id=h, batch=4)))
    t_single = min(singles)
    walls = [min(w) for w in walls]
    merge_parts(merged, hosts)

    rep = ScalingReport(frames=n_frames, num_hosts=hosts, host_wall_s=walls,
                        single_host_wall_s=t_single)
    eff = rep.efficiency
    assert eff is not None and 0 < eff <= 1.05, \
        f"implausible warm scaling efficiency {eff}"
