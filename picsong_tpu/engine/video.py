"""Pipelined video engine: the equivalent of runVideo.

The reference overlaps disk reads, H2D copies, kernels, D2H copies and
disk writes with N CUDA streams fed by reader/writer CPU threads that
handshake through polled flag arrays (Engines/CodingEngine.cu:758-983,
203-262; DecodingEngine.cu:866-1043). This design replaces the
N streams with FRAME BATCHING (engine/batch.py): B frames' codeblocks ride
one staged dispatch chain — bigger lane axis, 1/B dispatch overhead — and
the host-side overlap comes from three thread roles:

  reader thread     -> bounded queue of padded frame batches (disk + pad)
  compute loop      -> enqueues device programs (async dispatch, no sync)
  downloader thread -> ordered device->host drains, overlapping dispatch
  writer thread     -> packs + writes results, in batch order

Download scheduling has two modes (PICSONG_VIDEO_MODE), differing only
in the downloader queue depth:

  defer (default)  deep queue (max_inflight batches = the device-memory
                   budget): the compute loop keeps dispatching while
                   downloads drain on the downloader thread.
  overlap          shallow queue (eager per-batch downloads), which bounds
                   device memory for unbounded video length.

Which of the two is faster on the GPU is not measured yet.

Encoded streams are downloaded as uint16 (a device-side cast halves the
D2H transfer; codewords are 16-bit by construction).

The static bitplane count is derived ONCE from the first batch (host-side
CPU-backend replica, + safety margin) instead of a per-frame CPU DWT;
every downloaded stream's true MSB is validated
(check_planes_bound) and a batch is re-encoded with a corrected bound if
content ever exceeds it, so the bound is a performance hint, never a
correctness risk.

Stage timers mirror the reference's printed metrics with honest semantics
(reader/writer stall = time the COMPUTE loop was blocked on that side;
CodingEngine.cu:258,495,1049).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..core import spec
from ..core.header import CodecConfig, pack_header
from ..core.image_io import (append_raw_frame, mirror_pad, read_codestream,
                             read_raw_frame, read_sizes, sample_dtype,
                             write_codestream)
from ..entropy import bpc_jax
from .batch import BatchCodec
from .pipeline import TPUCodec, host_plane_bound, pack_streams, unpack_streams


def _video_mode() -> str:
    return os.environ.get("PICSONG_VIDEO_MODE", "defer")


@dataclass
class VideoStats:
    frames: int = 0
    reader_stall_s: float = 0.0   # compute loop blocked waiting for frames
    writer_stall_s: float = 0.0   # compute loop blocked on writer backlog
    writer_busy_s: float = 0.0    # writer thread pack+write time
    download_s: float = 0.0       # device->host result transfers
    compute_s: float = 0.0        # device enqueue time in the compute loop
    wall_s: float = 0.0
    batches: int = 0
    batch: int = 1
    n_planes: int = 0

    def as_dict(self) -> dict:
        return dict(frames=self.frames, reader_stall_s=self.reader_stall_s,
                    writer_stall_s=self.writer_stall_s,
                    writer_busy_s=self.writer_busy_s,
                    download_s=self.download_s,
                    compute_s=self.compute_s, wall_s=self.wall_s,
                    batches=self.batches, batch=self.batch,
                    n_planes=self.n_planes)


class _ReaderError:
    """Sentinel carrying a reader-thread exception to the compute loop."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclass
class _Prefetcher:
    """Reader thread with a bounded queue (the double-buffer input lane).

    A fetch failure (truncated frame, unreadable file) is forwarded as a
    sentinel so the compute loop's get() re-raises instead of blocking
    forever on a dead thread (the reference's reader thread fails the
    whole process on I/O error, CodingEngine.cu:231-254)."""

    fetch: callable
    count: int
    depth: int
    q: queue.Queue = field(init=False)

    def __post_init__(self):
        self.q = queue.Queue(maxsize=self.depth)
        self._stop = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for i in range(self.count):
            try:
                item = (i, self.fetch(i))
            except BaseException as e:   # surfaced on the consumer's get()
                item = _ReaderError(e)
            while not self._stop:
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop or isinstance(item, _ReaderError):
                return

    def get(self):
        item = self.q.get()
        if isinstance(item, _ReaderError):
            raise item.exc
        return item

    def close(self):
        """Release the thread if the consumer stops early (error paths):
        a reader blocked in q.put on a full queue would otherwise leak one
        thread + one frame batch per failed call."""
        self._stop = True


class _Writer:
    """Ordered writer thread: items are processed in put() order."""

    def __init__(self, fn, depth: int):
        self.fn = fn
        self.q = queue.Queue(maxsize=depth)
        self.busy_s = 0.0
        self.error: BaseException | None = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            t0 = time.perf_counter()
            try:
                self.fn(*item)
            except BaseException as e:   # surfaced on put()/join()
                self.error = e
                # keep draining so a producer blocked in q.put() wakes up
                # (otherwise a full queue deadlocks the pipeline and holds
                # the device for the next process)
                while True:
                    item = self.q.get()
                    if item is None:
                        return
            self.busy_s += time.perf_counter() - t0

    def put(self, *item):
        if self.error is not None:
            raise self.error
        self.q.put(item)
        if self.error is not None:
            raise self.error

    def join(self):
        self.q.put(None)
        self.t.join()
        if self.error is not None:
            raise self.error

    def shutdown(self):
        """Idempotent, non-raising sentinel + join for error-path cleanup:
        without it, a raise during the compute loop or an earlier join
        leaves this thread blocked on its queue forever — one leaked
        thread per failed call in a long-lived process."""
        if self.t.is_alive():
            self.q.put(None)
            self.t.join()


# --------------------------------------------------------------------------
# Encode
# --------------------------------------------------------------------------

def encode_video(input_path: str, output_path: str, cfg: CodecConfig,
                 luts, params, frames: int, batch: int = 8,
                 prefetch_depth: int = 2, progress: bool = False,
                 max_inflight: int | None = None,
                 frame_offset: int = 0, devices: int = 1) -> VideoStats:
    """Encode a planar RAW video (grayscale or RGB) frame sequence.

    frame_offset encodes frames [frame_offset, frame_offset + frames) of
    the input — the per-host slab window for multi-host striping
    (dist/multihost.py). devices > 1 shards each batch's frame axis over
    an N-device mesh (BASELINE config 4): same codestream bytes, the
    batch is data-parallel across devices (the multi-device
    generalization of the reference's N CUDA streams,
    CodingEngine.cu:758-983)."""
    if frames <= 1 or batch <= 1:
        return _encode_video_perframe(input_path, output_path, cfg, luts,
                                      params, frames,
                                      max(batch, 2), progress, frame_offset)
    mesh = None
    if devices > 1:
        from ..dist.sharded import make_mesh
        mesh = make_mesh(devices)
        batch = -(-batch // devices) * devices
    codec = BatchCodec(cfg, luts, params, batch, mesh=mesh)
    codec_header = pack_header(cfg)
    stats = VideoStats(batch=batch)
    t0 = time.perf_counter()
    n_comp = 3 if cfg.is_rgb else 1
    n_batches = -(-frames // batch)
    if max_inflight is None:
        # bound in-flight device stream buffers to ~2 GB of device memory
        # (a budget set for a 16 GB device; not yet re-sized for the GPU)
        per_batch = batch * codec.ncb * spec.CBLOCK_SIZE * 2 * n_comp
        max_inflight = max(1, int(2e9) // per_batch)

    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)

    def read_frame(i):
        i = min(i, frames - 1) + frame_offset   # tail: repeat last frame
        if cfg.is_rgb:
            return np.stack([
                mirror_pad(read_raw_frame(input_path, cfg.width, cfg.height,
                                          i * 3 + c, dtype),
                           codec.aw, codec.ah)
                for c in range(3)])
        return mirror_pad(read_raw_frame(input_path, cfg.width, cfg.height, i,
                                         dtype),
                          codec.aw, codec.ah)

    def fetch_batch(bi):
        return np.stack([read_frame(bi * batch + j) for j in range(batch)])

    reader = _Prefetcher(fetch_batch, n_batches, prefetch_depth)

    # shared mutable state, bumped on overflow (affects later batches too):
    # n_planes = static bitplane bound; bucket = device-pack payload capacity
    bound = {}
    use_pack = os.environ.get("PICSONG_VIDEO_PACK", "on") != "off"
    ncb_b = batch * codec.ncb

    def _assemble_frame(msb_f, sizes_f, payload, header):
        """Wire a frame's codestream from device-packed pieces (layout of
        assembly/pack.py: header, (MSB, size) short pairs, dense payload,
        one trailing filler short)."""
        ncb = len(msb_f)
        length = int(sizes_f.sum()) + 9 + 2 * ncb - ncb + 1
        out = np.full(length, 0xFFFF, dtype=np.uint16)
        if header is not None:
            out[:9] = header
        out[9:9 + 2 * ncb:2] = msb_f.astype(np.uint16)
        out[10:10 + 2 * ncb:2] = (sizes_f & 0xFFFF).astype(np.uint16)
        out[9 + 2 * ncb:9 + 2 * ncb + payload.size] = payload
        return out

    def write_host_batch(bi, host):
        """host: per-component ("dense", msb, sizes, payload) or
        ("full", streams, sizes)."""
        nreal = min(frames - bi * batch, batch)
        for f in range(nreal):
            for c, item in enumerate(host):
                header = codec_header if c == 0 else None
                if item[0] == "dense":
                    _, m, z, dense = item
                    zf = z.reshape(batch, codec.ncb)[f]
                    counts = z - 1
                    starts = np.concatenate([[0], np.cumsum(counts)])
                    lo = int(starts[f * codec.ncb])
                    hi = int(starts[(f + 1) * codec.ncb])
                    packed = _assemble_frame(
                        m.reshape(batch, codec.ncb)[f], zf, dense[lo:hi],
                        header)
                else:
                    _, s, z = item
                    sf = s.reshape(batch, codec.ncb, -1)[f]
                    zf = z.reshape(batch, codec.ncb)[f]
                    packed = pack_streams(sf, zf, header)
                write_codestream(output_path, packed,
                                 first=(bi == 0 and f == 0 and c == 0))
        stats.frames += nreal
        if progress:
            print(f"\rframe {stats.frames}/{frames}", end="", flush=True)

    def download_checked(bi, comp_outs):
        """Download a batch (dense payload when it fits the bucket, full
        streams otherwise); re-encode with a corrected bitplane bound if
        content exceeded it (re-reads the frames from disk)."""
        while True:
            host = []
            retry = False
            try:
                for item in comp_outs:
                    td = time.perf_counter()
                    if not isinstance(item, tuple):  # fused packed encode
                        # ONE device->host read per component: the fused
                        # [sizes|msb|dense] buffer (fuse_packed)
                        fused = np.asarray(item)
                        z, m, dense = bpc_jax.StagedBPC.split_packed(
                            fused, ncb_b)
                        bpc_jax.check_planes_bound(m, z, bound["n_planes"])
                        total = int(z.sum()) - len(z)
                        # compare against the capacity this batch was
                        # actually encoded with (dense.shape[0]), not the
                        # current bound — the bucket may have grown since
                        if total > dense.shape[0]:   # bucket overflow
                            grown = -(-total * 3 // 2 // ncb_b) * ncb_b
                            bound["bucket"] = max(bound["bucket"],
                                                  dense.shape[0] * 2, grown)
                            retry = True
                            stats.download_s += time.perf_counter() - td
                            break
                        host.append(("dense", m, z, dense[:total]))
                    else:
                        s, z = np.asarray(item[0]), np.asarray(item[1])
                        bpc_jax.check_planes_bound(s[:, 0], z,
                                                   bound["n_planes"])
                        host.append(("full", s, z))
                    stats.download_s += time.perf_counter() - td
                if not retry:
                    return host
            except bpc_jax.PlaneOverflowError as e:
                bound["n_planes"] = max(bound["n_planes"], e.needed)
            comp_outs = encode_one(fetch_batch(bi))

    # The compute loop and the downloader's re-encode both dispatch device
    # programs. On a mesh those programs carry collectives, which every
    # device must enqueue in the same order: two threads dispatching at
    # once can interleave their launches differently per device and
    # deadlock the collectives. One lock keeps dispatch in a single order.
    dispatch_lock = threading.Lock()

    def encode_one(frames_np):
        with dispatch_lock:
            if use_pack:
                outs = codec.encode_batch_packed(frames_np, bound["n_planes"],
                                                 bound["bucket"])
                return [bpc_jax.StagedBPC.fuse_packed(z, m, d)
                        for z, m, d in outs]
            return codec.encode_batch(frames_np, bound["n_planes"])

    writer = _Writer(write_host_batch, depth=prefetch_depth)
    # Downloader thread: downloads overlap dispatch instead of
    # serializing behind it. The compute loop keeps enqueuing device work
    # while this thread drains batch outputs in order; the bounded queue
    # (max_inflight) is the device-memory budget.
    # PICSONG_VIDEO_MODE=overlap keeps a shallow queue (eager downloads).
    depth = prefetch_depth if _video_mode() == "overlap" else max_inflight
    downloader = _Writer(
        lambda bi, co: writer.put(bi, download_checked(bi, co)),
        depth=depth)

    try:
        for bi in range(n_batches):
            tr = time.perf_counter()
            _, frames_np = reader.get()
            stats.reader_stall_s += time.perf_counter() - tr
            if "n_planes" not in bound:
                first = ([frames_np[0][c] for c in range(3)] if cfg.is_rgb
                         else frames_np[0])
                bound["n_planes"] = host_plane_bound(cfg, first, codec.aw,
                                                     codec.ah,
                                                     extra_margin=2)
                # device-pack payload capacity: start at 1/4 of the full
                # buffer (ratio 2 with margin); overflow falls back to a
                # full download and grows the bucket for later batches
                bound["bucket"] = ncb_b * (spec.CBLOCK_SIZE // 4)
            # `bound` is written by the downloader thread's overflow
            # retry (download_checked) and read here; the GIL makes the
            # int reads/writes safe, and this fresh read means every
            # batch dispatched AFTER a bump uses the corrected values —
            # only batches already in flight pay one re-encode each
            tc = time.perf_counter()
            comp_outs = encode_one(frames_np)
            stats.compute_s += time.perf_counter() - tc
            stats.batches += 1
            tw = time.perf_counter()
            downloader.put(bi, comp_outs)
            stats.writer_stall_s += time.perf_counter() - tw
        downloader.join()
        writer.join()
    finally:
        # error path: release all three threads (reader may be blocked in
        # put, downloader/writer waiting on their queues) so a failed
        # call never leaks threads
        reader.close()
        downloader.shutdown()
        writer.shutdown()
    stats.writer_busy_s = writer.busy_s
    stats.n_planes = bound["n_planes"]
    if progress:
        print()
    stats.wall_s = time.perf_counter() - t0
    return stats


def _encode_video_perframe(input_path, output_path, cfg, luts, params,
                           frames, prefetch_depth, progress,
                           frame_offset: int = 0) -> VideoStats:
    """Per-frame fallback (degenerate frame/batch counts)."""
    codec = TPUCodec(cfg, luts, params)
    stats = VideoStats()
    t0 = time.perf_counter()
    n_planes = 3 if cfg.is_rgb else 1

    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)

    def fetch(i):
        i = i + frame_offset
        if cfg.is_rgb:
            return [read_raw_frame(input_path, cfg.width, cfg.height,
                                   i * n_planes + c, dtype)
                    for c in range(3)]
        return read_raw_frame(input_path, cfg.width, cfg.height, i, dtype)

    reader = _Prefetcher(fetch, frames, prefetch_depth)

    def write_frame(i, streams):
        for j, s in enumerate(streams):
            write_codestream(output_path, s, first=(i == 0 and j == 0))
        stats.frames += 1
        if progress:
            print(f"\rframe {stats.frames}/{frames}", end="", flush=True)

    writer = _Writer(write_frame, depth=prefetch_depth)
    try:
        for i in range(frames):
            tr = time.perf_counter()
            _, frame = reader.get()
            stats.reader_stall_s += time.perf_counter() - tr
            tc = time.perf_counter()
            streams = codec.encode(frame)
            stats.compute_s += time.perf_counter() - tc
            tw = time.perf_counter()
            writer.put(i, streams)
            stats.writer_stall_s += time.perf_counter() - tw
        writer.join()
    finally:
        reader.close()
        writer.shutdown()
    stats.writer_busy_s = writer.busy_s
    if progress:
        print()
    stats.wall_s = time.perf_counter() - t0
    return stats


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def decode_video(input_path: str, output_path: str, cfg: CodecConfig,
                 luts, params, batch: int = 8, prefetch_depth: int = 2,
                 progress: bool = False,
                 max_inflight: int | None = None,
                 devices: int = 1, frame_offset: int = 0,
                 frames: int | None = None) -> VideoStats:
    """Decode an appended-codestream video file back to planar RAW.

    frame_offset/frames select a window of the video — the `_SIZE`
    sidecar's prefix offsets give random access to any frame (the
    reference's resume-at-frame-i analogue, IOManager.ipp:176-208,
    DecodingEngine.cu:257-283); dist/multihost.py uses this for per-host
    slab decode."""
    all_sizes = read_sizes(input_path)
    n_comp = 3 if cfg.is_rgb else 1
    total_frames = len(all_sizes) // n_comp
    if frames is None:
        frames = total_frames - frame_offset
    all_offsets = np.concatenate([[0], np.cumsum(all_sizes)])
    lo = frame_offset * n_comp
    sizes = all_sizes[lo:(frame_offset + frames) * n_comp]
    offsets = all_offsets[lo:]          # absolute byte offsets, local index
    n_frames = frames
    if n_frames <= 1 or batch <= 1:
        return _decode_video_perframe(input_path, output_path, cfg, luts,
                                      params, sizes, offsets, n_frames,
                                      max(batch, 2), progress)
    mesh = None
    if devices > 1:
        from ..dist.sharded import make_mesh
        mesh = make_mesh(devices)
        batch = -(-batch // devices) * devices
    codec = BatchCodec(cfg, luts, params, batch, mesh=mesh)
    stats = VideoStats(batch=batch)
    t0 = time.perf_counter()
    n_batches = -(-n_frames // batch)
    if max_inflight is None:
        per_batch = batch * codec.ah * codec.aw * (3 if cfg.is_rgb else 1)
        max_inflight = max(1, int(2e9) // per_batch)

    def fetch_batch(bi):
        """Read + unpack B frames -> per-component (B*ncb, 4096) arrays."""
        comp_streams = [np.empty((batch * codec.ncb, spec.CBLOCK_SIZE),
                                 np.int32) for _ in range(n_comp)]
        comp_sizes = [np.empty(batch * codec.ncb, np.int64)
                      for _ in range(n_comp)]
        for j in range(batch):
            f = min(bi * batch + j, n_frames - 1)   # tail: repeat last frame
            for c in range(n_comp):
                k = f * n_comp + c
                shorts = read_codestream(input_path, int(offsets[k]),
                                         int(sizes[k]))
                s, z = unpack_streams(shorts, codec.ncb)
                comp_streams[c][j * codec.ncb:(j + 1) * codec.ncb] = s
                comp_sizes[c][j * codec.ncb:(j + 1) * codec.ncb] = z
        n_planes = max(bpc_jax.planes_for_streams(s[:, 0], z)
                       for s, z in zip(comp_streams, comp_sizes))
        return list(zip(comp_streams, comp_sizes)), n_planes

    reader = _Prefetcher(fetch_batch, n_batches, prefetch_depth)
    if os.path.exists(output_path):
        os.remove(output_path)

    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)

    def write_host_batch(bi, planes):
        nreal = min(n_frames - bi * batch, batch)
        for f in range(nreal):
            if cfg.is_rgb:
                for c in range(3):
                    append_raw_frame(output_path,
                                     planes[f, c, :cfg.height, :cfg.width],
                                     dtype)
            else:
                append_raw_frame(output_path,
                                 planes[f, :cfg.height, :cfg.width], dtype)
        stats.frames += nreal
        if progress:
            print(f"\rframe {stats.frames}/{n_frames}", end="", flush=True)

    writer = _Writer(write_host_batch, depth=prefetch_depth)

    def _download(bi, planes_dev):
        td = time.perf_counter()
        planes = np.asarray(planes_dev)
        stats.download_s += time.perf_counter() - td
        writer.put(bi, planes)

    # downloader thread: downloads overlap dispatch (see encode_video);
    # queue depth = max_inflight is the device-memory budget
    depth = prefetch_depth if _video_mode() == "overlap" else max_inflight
    downloader = _Writer(_download, depth=depth)

    try:
        for bi in range(n_batches):
            tr = time.perf_counter()
            _, (comp_streams, n_planes) = reader.get()
            stats.reader_stall_s += time.perf_counter() - tr
            tc = time.perf_counter()
            planes = codec.decode_batch(comp_streams, n_planes)
            stats.compute_s += time.perf_counter() - tc
            stats.batches += 1
            stats.n_planes = max(stats.n_planes, n_planes)
            tw = time.perf_counter()
            downloader.put(bi, planes)
            stats.writer_stall_s += time.perf_counter() - tw
        downloader.join()
        writer.join()
    finally:
        reader.close()
        downloader.shutdown()
        writer.shutdown()
    stats.writer_busy_s = writer.busy_s
    if progress:
        print()
    stats.wall_s = time.perf_counter() - t0
    return stats


def _decode_video_perframe(input_path, output_path, cfg, luts, params,
                           sizes, offsets, n_frames, prefetch_depth,
                           progress) -> VideoStats:
    codec = TPUCodec(cfg, luts, params)
    stats = VideoStats()
    t0 = time.perf_counter()
    n_comp = 3 if cfg.is_rgb else 1

    def fetch(i):
        return [read_codestream(input_path,
                                int(offsets[i * n_comp + c]),
                                int(sizes[i * n_comp + c]))
                for c in range(n_comp)]

    reader = _Prefetcher(fetch, n_frames, prefetch_depth)
    if os.path.exists(output_path):
        os.remove(output_path)

    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed)

    def write_frame(i, out):
        if cfg.is_rgb:
            for p in out:
                append_raw_frame(output_path, p, dtype)
        else:
            append_raw_frame(output_path, out, dtype)
        stats.frames += 1
        if progress:
            print(f"\rframe {stats.frames}/{n_frames}", end="", flush=True)

    writer = _Writer(write_frame, depth=prefetch_depth)
    try:
        for i in range(n_frames):
            tr = time.perf_counter()
            _, comp_streams = reader.get()
            stats.reader_stall_s += time.perf_counter() - tr
            tc = time.perf_counter()
            out = codec.decode(comp_streams)
            stats.compute_s += time.perf_counter() - tc
            tw = time.perf_counter()
            writer.put(i, out)
            stats.writer_stall_s += time.perf_counter() - tw
        writer.join()
    finally:
        reader.close()
        writer.shutdown()
    stats.writer_busy_s = writer.busy_s
    if progress:
        print()
    stats.wall_s = time.perf_counter() - t0
    return stats
