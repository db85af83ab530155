"""Device-mesh sharded pipelines: multi-chip scaling for images and video.

The reference is single-GPU (SURVEY.md section 2); this layer is the new
capability mandated by BASELINE configs 3-5. Design follows the standard
JAX recipe — pick a mesh, annotate shardings, let XLA's SPMD partitioner
insert the collectives between devices:

- Image mode: the plane is sharded by rows across the mesh. The lifting
  DWT's neighbor reads (`concatenate` of shifted slices) become halo
  exchanges; the Mallat deinterleave and codeblock tiling become
  all-to-alls; BPC codeblocks are embarrassingly parallel on the codeblock
  axis (the only cross-device value is the global max-MSB plane count, a
  scalar all-reduce). The per-block sizes are gathered to the host for
  packing — the distributed generalization of the reference's CUB prefix
  sum round trip (BitStreamBuilder.cu:300).

- Video mode: frames are data-parallel across the mesh (the multi-device
  analogue of the reference's N CUDA streams, CodingEngine.cu:758-983): a
  batch of F frames is sharded on the frame axis and encoded by one SPMD
  program.

Sharded programs produce bit-identical codestreams to the single-device
engine (gated in tests/test_dist.py on an 8-device CPU mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..assembly.pack import pack_streams
from ..core import spec
from ..core.geometry import codeblock_bands, plane_to_codeblocks
from ..core.header import CodecConfig, pack_header
from ..core.image_io import mirror_pad
from ..core.lut import LUTParams
from ..entropy import bpc_jax
from ..transform.dwt import dwt_forward, dwt_reverse
from ..core.geometry import codeblocks_to_plane


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


class ShardedCodec:
    """Row-sharded single-image pipeline over a 1-D device mesh."""

    def __init__(self, cfg: CodecConfig, luts, params: LUTParams, mesh: Mesh):
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.luts = [jnp.asarray(l, jnp.int32) for l in luts]
        self.aw, self.ah = spec.adapted_size(cfg.width, cfg.height)
        # No mesh-multiple constraint on the adapted height: the codeblock
        # batch is padded with empty (all-zero) codeblocks up to a mesh
        # multiple and the pad rows dropped after download — the
        # mesh-level extension of the reference's mirror padding to
        # codeblock multiples (IOManager.ipp:82-110). Codeblocks are
        # independent, so a 1080p frame (adapted height 1088 = 17
        # codeblock rows) row-shards over any device count with bytes
        # identical to single-device (gated in
        # tests/test_dist.py::test_sharded_uneven_rows_match_single).
        levels, subbands = codeblock_bands(self.aw, self.ah, cfg.wavelet_levels)
        self.ncb = len(levels)
        self.ndev = int(mesh.devices.size)
        self.ncb_pad = -(-self.ncb // self.ndev) * self.ndev
        pad = self.ncb_pad - self.ncb
        meta = bpc_jax._meta_args(levels, subbands, params, cfg.wavelet_levels,
                                  cfg.coding_passes, cfg.k_factor)
        self._meta = tuple(jnp.asarray(np.pad(np.asarray(m), (0, pad)))
                           for m in meta)
        self._kw = dict(params=params, wavelet_levels=cfg.wavelet_levels,
                        coding_passes=cfg.coding_passes,
                        has_k=cfg.k_factor > 0)

        row_sharded = NamedSharding(mesh, P(self.axis, None))
        cb_sharded = NamedSharding(mesh, P(self.axis, None, None))
        repl = NamedSharding(mesh, P())

        self._cb_sharded = cb_sharded
        self._repl = repl
        self._dwt_tile = jax.jit(
            self._dwt_tile_impl, in_shardings=(row_sharded,),
            out_shardings=(cb_sharded, repl))
        self._encode_cache = {}
        self._decode_cache = {}
        self._untile_idwt = jax.jit(
            self._untile_idwt_impl, in_shardings=(cb_sharded,),
            out_shardings=row_sharded)
        # Staged entropy path (default): the SAME per-pass StagedBPC
        # programs the single-device engine runs, entered with the
        # codeblock batch sharded on its lane axis. Sharding rides GSPMD input propagation (the idiom
        # BatchCodec's frame-DP video mode already uses): blocks arrive
        # P(d, None, None) from _dwt_tile, the LUT and per-block metadata
        # are replicated, and every carry tensor ((66,33,N) grids,
        # (32,N) AC state, (N,4096) streams) is elementwise on N, so the
        # partitioner shards each pass program over the codeblock axis
        # with no collectives — the hot kernel class is unchanged
        # (BPCEngine.cu:1929-2121 stays the hot path when the reference
        # scales). The monolithic single-program coder stays available
        # via PICSONG_SHARDED_BPC=mono.
        self._staged = bpc_jax.get_staged(params, cfg.wavelet_levels,
                                          cfg.coding_passes,
                                          cfg.k_factor > 0)
        self.luts = [jax.device_put(l, repl) for l in self.luts]
        self._meta = tuple(jax.device_put(m, repl) for m in self._meta)

    def _dwt_tile_impl(self, plane):
        cfg = self.cfg
        coeffs = dwt_forward(plane, cfg.wavelet_levels, cfg.is_lossy, cfg.qs)
        coeffs = coeffs.astype(jnp.int32)
        blocks = plane_to_codeblocks(coeffs)
        if self.ncb_pad != self.ncb:
            blocks = jnp.pad(blocks, ((0, self.ncb_pad - self.ncb),
                                      (0, 0), (0, 0)))
        blocks = jax.lax.with_sharding_constraint(
            blocks, NamedSharding(self.mesh, P(self.axis, None, None)))
        return blocks, jnp.max(jnp.abs(blocks))

    def _untile_idwt_impl(self, blocks):
        cfg = self.cfg
        mallat = codeblocks_to_plane(blocks[:self.ncb], self.ah, self.aw)
        mallat = jax.lax.with_sharding_constraint(
            mallat, NamedSharding(self.mesh, P(self.axis, None)))
        return dwt_reverse(mallat, cfg.wavelet_levels, cfg.is_lossy, cfg.qs)

    def _encode_fn(self, n_planes):
        if n_planes not in self._encode_cache:
            self._encode_cache[n_planes] = jax.jit(
                lambda blocks, lut: bpc_jax.encode_blocks(
                    blocks, lut, *self._meta, **self._kw, n_planes=n_planes),
                in_shardings=(self._cb_sharded, self._repl),
                out_shardings=(NamedSharding(self.mesh, P(self.axis, None)),
                               NamedSharding(self.mesh, P(self.axis))))
        return self._encode_cache[n_planes]

    def _decode_fn(self, n_planes):
        if n_planes not in self._decode_cache:
            self._decode_cache[n_planes] = jax.jit(
                lambda streams, sizes, lut: bpc_jax.decode_blocks(
                    streams, sizes, lut, *self._meta, **self._kw,
                    n_planes=n_planes),
                in_shardings=(NamedSharding(self.mesh, P(self.axis, None)),
                              NamedSharding(self.mesh, P(self.axis)),
                              self._repl),
                out_shardings=self._cb_sharded)
        return self._decode_cache[n_planes]

    @staticmethod
    def _bpc_mode() -> str:
        """PICSONG_SHARDED_BPC: 'staged' (default) or 'mono'; any other
        value raises ValueError."""
        from ..engine.pipeline import _bpc_mode
        return _bpc_mode("PICSONG_SHARDED_BPC")

    def encode_plane(self, plane_shifted, n_planes: int | None = None,
                     lut_index: int = 0):
        """Encode one DC-shifted component plane; returns (streams, sizes).

        n_planes=None derives the static bitplane bound by reading the
        device max (a host sync); encode() passes the host-derived bound
        (pipeline.host_plane_bound) instead."""
        lut = self.luts[min(lut_index, len(self.luts) - 1)]
        blocks, max_mag = self._dwt_tile(jnp.asarray(plane_shifted))
        if n_planes is None:
            n_planes = bpc_jax.planes_for_magnitude(int(max_mag))
        if self._bpc_mode() == "mono":
            streams, sizes = self._encode_fn(n_planes)(blocks, lut)
        else:
            # chunk=0: the mesh already tiles the batch — each device
            # holds ncb_pad/ndev blocks; host-side chunk slicing would cut
            # ACROSS the contiguous row shards and force resharding per
            # chunk
            streams, sizes = self._staged.encode(blocks, lut, self._meta,
                                                 n_planes, chunk=0)
        return (np.asarray(streams)[:self.ncb],
                np.asarray(sizes)[:self.ncb])

    def decode_plane(self, streams, sizes, lut_index: int = 0):
        lut = self.luts[min(lut_index, len(self.luts) - 1)]
        streams = np.asarray(streams, dtype=np.int32)
        sizes = np.asarray(sizes, dtype=np.int64)
        n_planes = bpc_jax.planes_for_streams(streams[:, 0], sizes)
        if self.ncb_pad != self.ncb:
            # pad with empty-block streams (MSB word 32, used size 1 —
            # the encoder's empty-codeblock wire form, BPCEngine.cu:1998)
            pad = self.ncb_pad - self.ncb
            empty = np.full((pad, spec.CBLOCK_SIZE), -1, np.int32)
            empty[:, 0] = 32
            streams = np.concatenate([streams, empty])
            sizes = np.concatenate([sizes, np.ones(pad, sizes.dtype)])
        if self._bpc_mode() == "mono":
            blocks = self._decode_fn(n_planes)(
                jnp.asarray(streams, jnp.int32),
                jnp.asarray(sizes, jnp.int32), lut)
        else:
            s_dev = jax.device_put(streams.astype(np.int32),
                                   NamedSharding(self.mesh,
                                                 P(self.axis, None)))
            z_dev = jax.device_put(sizes.astype(np.int32),
                                   NamedSharding(self.mesh, P(self.axis)))
            blocks = self._staged.decode(s_dev, z_dev, lut, self._meta,
                                         n_planes, chunk=0)
            # _untile_idwt's in_shardings=(cb_sharded,) re-lays blocks out
            # if the partitioner chose a different decode output sharding
        out = self._untile_idwt(blocks)
        return np.asarray(out)

    # -- host-facing API (mirrors TPUCodec.encode/decode) --------------------

    @property
    def _sample_np_dtype(self):
        """Host sample dtype from bps/endianess/signedness (the templated
        IOManager<T,Y> generalization, IOManager.ipp:72-138)."""
        from ..core.image_io import sample_dtype
        cfg = self.cfg
        return sample_dtype(cfg.bps, cfg.endianess,
                            cfg.is_signed).newbyteorder("=")

    def _prep_host(self, pixels):
        """Mirror-pad + DC shift + color transform on the host."""
        cfg = self.cfg
        offset = 0 if cfg.is_signed else (1 << (cfg.bit_depth - 1))
        planes = pixels if cfg.is_rgb else [pixels]
        dt = self._sample_np_dtype
        padded = [mirror_pad(np.asarray(p).astype(dt, copy=False),
                             self.aw, self.ah)
                  .astype(np.int32) - offset for p in planes]
        if cfg.is_rgb:
            if cfg.is_lossy:
                r, g, b = (p.astype(np.float32) for p in padded)
                m = np.asarray(spec.ICT_FORWARD)
                comps = [m[i, 0] * r + m[i, 1] * g + m[i, 2] * b
                         for i in range(3)]
            else:
                r, g, b = padded
                comps = [(r + 2 * g + b) >> 2, b - g, r - g]
        else:
            comps = ([padded[0].astype(np.float32)] if cfg.is_lossy
                     else [padded[0]])
        return comps

    def encode(self, pixels) -> list[np.ndarray]:
        """uint8 plane (gray) or [R, G, B] -> packed component codestreams.

        The bitplane bound comes from the host-side CPU replica (no device
        read; see encode_plane) and is validated against each downloaded
        stream's true MSB."""
        from ..engine.pipeline import host_plane_bound
        cfg = self.cfg
        n_planes = host_plane_bound(cfg, pixels, self.aw, self.ah)
        comps = self._prep_host(pixels)
        while True:
            try:
                out = []
                for i, comp in enumerate(comps):
                    streams, sizes = self.encode_plane(comp, n_planes, i)
                    bpc_jax.check_planes_bound(streams[:, 0], sizes, n_planes)
                    out.append(pack_streams(streams, sizes,
                                            pack_header(cfg) if i == 0
                                            else None))
                return out
            except bpc_jax.PlaneOverflowError as e:
                n_planes = e.needed

    def decode(self, component_streams: list[np.ndarray]):
        """Packed component codestreams -> sample-typed plane(s), cropped.

        Clamp range follows the sample type (removeOffsetAndApplyMaxMin
        generalized, DecodingEngine.cu:706-729), matching TPUCodec."""
        from ..assembly.pack import unpack_streams
        from ..engine.pipeline import _sample_range
        cfg = self.cfg
        offset = 0 if cfg.is_signed else (1 << (cfg.bit_depth - 1))
        mn, mx = _sample_range(cfg)
        dt = self._sample_np_dtype
        planes = []
        for i, shorts in enumerate(component_streams):
            streams, sizes = unpack_streams(shorts, self.ncb)
            planes.append(self.decode_plane(streams, sizes, i))
        if cfg.is_rgb:
            c0, c1, c2 = planes
            if cfg.is_lossy:
                m = np.asarray(spec.ICT_BACKWARD)
                outs = [np.rint(m[r, 0] * c0 + m[r, 1] * c1 + m[r, 2] * c2
                                + np.float32(0.01)).astype(np.int32)
                        for r in range(3)]
                r, g, b = outs
            else:
                y, u, v = (p.astype(np.int32) for p in planes)
                g = y - ((u + v) >> 2)
                r = v + g
                b = u + g
            return [np.clip(c + offset, mn, mx).astype(dt)
                    [:cfg.height, :cfg.width] for c in (r, g, b)]
        plane = planes[0]
        if cfg.is_lossy:
            plane = np.rint(plane + np.float32(offset) + np.float32(0.01))
        else:
            plane = plane + offset
        return np.clip(plane, mn, mx).astype(dt)[:cfg.height, :cfg.width]


class FrameParallelCodec:
    """Data-parallel video: a frame batch sharded over the mesh.

    Thin wrapper over the mesh-aware BatchCodec (engine/batch.py) — the
    frame axis is sharded over the mesh and GSPMD partitions the whole
    staged chain, so this shares the production video kernels (including
    RGB, high bit depth and the device-side dense pack) instead of
    carrying a second demo implementation. The static bitplane count comes
    from a CPU-backend host bound, never a device read (the reference
    reads MSBs on-device per warp, BPCEngine.cu:1998).
    """

    def __init__(self, cfg: CodecConfig, luts, params: LUTParams, mesh: Mesh):
        from ..engine.batch import BatchCodec
        self.cfg = cfg
        self.mesh = mesh
        self.batch = int(mesh.devices.size)
        self._bc = BatchCodec(cfg, luts, params, self.batch, mesh=mesh)
        self.aw, self.ah = self._bc.aw, self._bc.ah
        self.ncb = self._bc.ncb
        self._n_planes: int | None = None

    def _plane_bound(self, frames: np.ndarray) -> int:
        """Bitplane bound derived ONCE per codec: first frame of the first
        batch + one safety quantum (the engine/video.py pattern,
        video.py) instead of a full CPU DWT replica over every frame of
        every batch. An undercut bound is
        caught by check_planes_bound and the batch re-encoded."""
        if self._n_planes is None:
            from ..engine.pipeline import host_plane_bound
            self._n_planes = host_plane_bound(self.cfg, frames[0],
                                              self.aw, self.ah,
                                              extra_margin=1)
        return self._n_planes

    def encode_batch(self, frames: np.ndarray):
        """(F, H, W) padded frames -> ((F, ncb, 4096) int32, (F, ncb))."""
        frames = np.asarray(frames)
        n_planes = self._plane_bound(frames)
        while True:
            [(streams, sizes)] = self._bc.encode_batch(frames, n_planes)
            s = np.asarray(streams).astype(np.int32)
            z = np.asarray(sizes)
            try:
                bpc_jax.check_planes_bound(s[:, 0], z, n_planes)
                break
            except bpc_jax.PlaneOverflowError as e:
                n_planes = self._n_planes = e.needed
        return (s.reshape(self.batch, self.ncb, -1),
                z.reshape(self.batch, self.ncb))

    def decode_batch(self, streams, sizes):
        streams = np.asarray(streams)
        sizes = np.asarray(sizes)
        n_planes = bpc_jax.planes_for_streams(
            streams[:, :, 0].reshape(-1), sizes.reshape(-1))
        out = self._bc.decode_batch(
            [(streams.reshape(self.batch * self.ncb, -1),
              sizes.reshape(-1))], n_planes)
        return np.asarray(out)
