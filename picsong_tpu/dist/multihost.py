"""Multi-host scaling: per-host frame striping with rank-ordered concat.

BASELINE config 5 asks for multi-host video (N >= 2 hosts, >= 80% frames/s
scaling efficiency). The reference is single-process (SURVEY.md section 2);
its reader/writer-thread pipeline (Engines/CodingEngine.cu:212-326,463-550)
generalizes to multi-host as:

  - each host reads ITS OWN contiguous slab of frames straight from the
    shared input (replacing the reader thread's role: no frame ever moves
    between hosts — video frames are embarrassingly parallel),
  - each host encodes its slab with the local-chip batched engine
    (engine/video.py: batching + defer-downloads + device pack),
  - each host writes a part file `<out>.part<rank>` + `_SIZE` sidecar,
  - rank 0 concatenates parts in rank order into the final codestream
    (the codestream is an appended sequence of per-frame streams, so
    rank-ordered concat of contiguous slabs is exactly the single-host
    byte stream).

Control-plane setup uses jax.distributed.initialize (one process per
host); the video data plane itself needs NO cross-host collectives — the
only global values are the static bitplane bound (derived per-host from
its first frame, validated per-stream by check_planes_bound) and the
part lengths (exchanged through the filesystem at merge time). Image-mode
tile sharding (ShardedCodec) runs over the global mesh instead, where
GSPMD inserts the halo collectives between devices and hosts.

Scaling efficiency is computed from per-host wall times:
  efficiency = T_1 / (N * max_h T_h)   for the same total frame count.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..core.header import CodecConfig
from ..engine.video import VideoStats, decode_video, encode_video


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize the JAX distributed runtime (one process per host).

    Returns (process_id, num_processes). With no arguments and no
    JAX_COORDINATOR_ADDRESS in the environment this is a single-process
    no-op returning (0, 1) — the same code path then works on a laptop,
    a single GPU host, and a cluster.

    This starts one process per call and pins no device. On a host with
    several GPUs each process needs its own card: a JAX process reserves
    most of a card's memory when it first touches it, so start each
    process with its own CUDA_VISIBLE_DEVICES (e.g. 0, 1, ...). Nothing
    here discovers a cluster: pass coordinator_address ("host:port"),
    num_processes and process_id, or set JAX_COORDINATOR_ADDRESS."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return 0, 1
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index(), jax.process_count()


def frame_slab(frames: int, num_hosts: int, host_id: int) -> tuple[int, int]:
    """Contiguous frame range [start, stop) owned by a host.

    Contiguous slabs (not round-robin stripes) keep each host's disk
    reads sequential and make the rank-ordered merge a plain concat."""
    base = frames // num_hosts
    extra = frames % num_hosts
    start = host_id * base + min(host_id, extra)
    stop = start + base + (1 if host_id < extra else 0)
    return start, stop


def part_path(output_path: str, host_id: int) -> str:
    return f"{output_path}.part{host_id}"


def encode_video_part(input_path: str, output_path: str, cfg: CodecConfig,
                      luts, params, frames: int, num_hosts: int,
                      host_id: int, batch: int = 8,
                      progress: bool = False) -> VideoStats:
    """Encode this host's frame slab into its rank part file."""
    start, stop = frame_slab(frames, num_hosts, host_id)
    if stop <= start:
        # still create empty part files so merge_parts needs no special case
        for suffix in ("", "_SIZE"):
            open(part_path(output_path, host_id) + suffix, "w").close()
        return VideoStats()
    return encode_video(input_path, part_path(output_path, host_id), cfg,
                        luts, params, frames=stop - start, batch=batch,
                        progress=progress, frame_offset=start)


def encode_video_multihost(input_path: str, output_path: str,
                           cfg: CodecConfig, luts, params, frames: int,
                           batch: int = 8,
                           progress: bool = False) -> VideoStats:
    """Full multi-host encode: slab encode -> barrier -> rank-0 merge.

    Call init_distributed first; in a single process this degenerates to
    a plain encode_video with a rename."""
    import jax

    pid, n = jax.process_index(), jax.process_count()
    stats = encode_video_part(input_path, output_path, cfg, luts, params,
                              frames, n, pid, batch=batch, progress=progress)
    if n > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("picsong-video-parts")
    if pid == 0:
        merge_parts(output_path, n)
    if n > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("picsong-video-merged")
    return stats


def decode_video_part(input_path: str, output_path: str, cfg: CodecConfig,
                      luts, params, num_hosts: int, host_id: int,
                      batch: int = 8, progress: bool = False) -> VideoStats:
    """Decode this host's frame slab into its rank part file (raw planes).

    The `_SIZE` sidecar's prefix offsets give every host random access to
    its slab without touching other hosts' bytes — the multi-host mirror
    of the reference's pipelined video decode
    (DecodingEngine.cu:866-1043) + its resume-at-frame-i offsets
    (IOManager.ipp:196-208)."""
    from ..core.image_io import read_sizes

    sizes = read_sizes(input_path)
    n_comp = 3 if cfg.is_rgb else 1
    total = len(sizes) // n_comp
    start, stop = frame_slab(total, num_hosts, host_id)
    part = part_path(output_path, host_id)
    if stop <= start:
        open(part, "w").close()
        return VideoStats()
    return decode_video(input_path, part, cfg, luts, params, batch=batch,
                        progress=progress, frame_offset=start,
                        frames=stop - start)


def decode_video_multihost(input_path: str, output_path: str,
                           cfg: CodecConfig, luts, params,
                           batch: int = 8,
                           progress: bool = False) -> VideoStats:
    """Full multi-host decode: slab decode -> barrier -> rank-0 raw concat."""
    import jax

    pid, n = jax.process_index(), jax.process_count()
    stats = decode_video_part(input_path, output_path, cfg, luts, params,
                              n, pid, batch=batch, progress=progress)
    if n > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("picsong-video-dec-parts")
    if pid == 0:
        merge_raw_parts(output_path, n)
    if n > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("picsong-video-dec-merged")
    return stats


def merge_raw_parts(output_path: str, num_hosts: int) -> None:
    """Rank-ordered concat of decoded raw part files (rank 0).

    Raw planar frames have no sidecar; contiguous slabs concat to exactly
    the single-host output file."""
    import shutil

    with open(output_path, "wb") as out:
        for h in range(num_hosts):
            part = part_path(output_path, h)
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out, length=16 * 1024 * 1024)
            os.remove(part)


def merge_parts(output_path: str, num_hosts: int) -> None:
    """Rank-ordered concat of part files + merged _SIZE sidecar (rank 0)."""
    import shutil

    sizes: list[str] = []
    with open(output_path, "wb") as out:
        for h in range(num_hosts):
            part = part_path(output_path, h)
            with open(part, "rb") as f:
                # stream the concat: rank 0's RSS must not scale with the
                # whole compressed video
                shutil.copyfileobj(f, out, length=16 * 1024 * 1024)
            with open(part + "_SIZE", "r") as f:
                tok = f.read().strip()
                if tok:
                    sizes.append(tok)
            os.remove(part)
            os.remove(part + "_SIZE")
    with open(output_path + "_SIZE", "w") as f:
        f.write(",".join(sizes))


@dataclass
class ScalingReport:
    """Frames/s scaling-efficiency accounting (BASELINE config 5)."""

    frames: int
    num_hosts: int
    host_wall_s: list[float]
    single_host_wall_s: float | None = None

    @property
    def aggregate_fps(self) -> float:
        return self.frames / max(self.host_wall_s)

    @property
    def efficiency(self) -> float | None:
        """T_1 / (N * max_h T_h); None when no single-host baseline ran."""
        if self.single_host_wall_s is None:
            return None
        return self.single_host_wall_s / (self.num_hosts
                                          * max(self.host_wall_s))

    def as_dict(self) -> dict:
        return dict(frames=self.frames, num_hosts=self.num_hosts,
                    host_wall_s=self.host_wall_s,
                    single_host_wall_s=self.single_host_wall_s,
                    aggregate_fps=self.aggregate_fps,
                    efficiency=self.efficiency)
