"""Frame-batched codec: many frames per device dispatch.

The reference overlaps N CUDA streams to keep the GPU busy across frames
(Engines/CodingEngine.cu:758-983). The equivalent here is batching:
BPC-PaCo codeblocks are independent along the lane axis, so a batch of B
frames is just B x ncb codeblocks in ONE staged program — a wider
codeblock axis and 1/B the dispatch overhead. The DWT runs
vmapped over the frame axis in the same prep program.

The static bitplane count is computed ONCE per video from a host-side
bound on the first frame plus one safety quantum (not a per-frame CPU
DWT replica); the encoder writes
each codeblock's true MSB as stream word 0, so an undercut bound is
detected on the already-downloaded streams (check_planes_bound) and the
batch is re-encoded with the corrected bound instead of shipping corrupt
planes.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def _force_staged() -> bool:
    """PICSONG_VIDEO_BPC selects the coder for batched video.

    'staged' (default): the multi-dispatch staged chain.
    'fused': the one-dispatch FusedBPC program (bit-exact). It was far
    slower to compile and run on the accelerator the defaults were first
    chosen on; the two are not yet compared on the GPU."""
    return os.environ.get("PICSONG_VIDEO_BPC", "staged") == "staged"

from ..core import spec
from ..core.geometry import (codeblock_bands, codeblocks_to_plane,
                             plane_to_codeblocks)
from ..core.header import CodecConfig
from ..core.lut import LUTParams
from ..entropy import bpc_jax
from ..transform.dwt import dwt_forward, dwt_reverse
from .pipeline import _jnp_sample_dtype, _sample_range


class BatchCodec:
    """Encode/decode batches of B frames with one staged dispatch chain.

    Grayscale batches are (B, H, W) uint8; RGB batches are (B, 3, H, W)
    uint8 (already mirror-padded to the adapted size). Covers cp=2 and
    cp=3, with or without complexity scalability (k > 0 runs the staged
    bulk pass; the fused one-dispatch programs remain k == 0 only).
    """

    def __init__(self, cfg: CodecConfig, luts, params: LUTParams, batch: int,
                 mesh=None):
        """mesh: optional jax.sharding.Mesh — frames are data-parallel over
        its first axis (the multi-device generalization of the
        reference's N CUDA streams, CodingEngine.cu:758-983). Inputs are
        device_put with the frame axis sharded; GSPMD propagates the
        sharding through the whole prep/BPC/finish chain, so every
        dispatch is one SPMD program and the codestream bytes are
        identical to single-device."""
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.mesh = mesh
        self.luts = [jnp.asarray(l, jnp.int32) for l in luts]
        self.aw, self.ah = spec.adapted_size(cfg.width, cfg.height)
        levels, subbands = codeblock_bands(self.aw, self.ah,
                                           cfg.wavelet_levels)
        self.ncb = len(levels)
        meta = bpc_jax._meta_args(np.tile(levels, batch),
                                  np.tile(subbands, batch), params,
                                  cfg.wavelet_levels, cfg.coding_passes,
                                  cfg.k_factor)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            ndev = int(mesh.devices.size)
            if batch % ndev != 0:
                raise ValueError(
                    f"batch {batch} must be a multiple of the mesh size "
                    f"{ndev} for frame data parallelism")
            axis = mesh.axis_names[0]
            repl = NamedSharding(mesh, P())
            self._frame_sharding = NamedSharding(mesh, P(axis))
            self.luts = [jax.device_put(l, repl) for l in self.luts]
            self._meta = tuple(jax.device_put(jnp.asarray(m), repl)
                               for m in meta)
        else:
            self._meta = tuple(jnp.asarray(m) for m in meta)
        self._staged = bpc_jax.get_staged(params, cfg.wavelet_levels,
                                          cfg.coding_passes,
                                          cfg.k_factor > 0)
        self._fused = (bpc_jax.get_fused(params, cfg.wavelet_levels)
                       if cfg.coding_passes == 2 and cfg.k_factor == 0
                       else None)
        self._prep_gray = jax.jit(self._prep_gray_impl)
        self._prep_rgb = jax.jit(self._prep_rgb_impl)
        self._finish_gray = jax.jit(self._finish_gray_impl)
        self._finish_rgb = jax.jit(self._finish_rgb_impl)
        # codewords are 16-bit by construction; casting on device halves
        # the D2H transfer (the -1 filler wraps to 0xFFFF, same as the
        # packed wire format)
        self._cast16 = jax.jit(lambda s: s.astype(jnp.uint16))
        # fused single-dispatch programs: prep + coder (+ finish) in ONE
        # program per component, each containing exactly one big-carry
        # loop (PICSONG_VIDEO_BPC=fused)
        self._enc_gray_prog = jax.jit(self._enc_gray_prog_impl,
                                      static_argnums=(2,))
        self._enc_comp_prog = jax.jit(self._enc_comp_prog_impl,
                                      static_argnums=(2,))
        self._dec_gray_prog = jax.jit(self._dec_gray_prog_impl,
                                      static_argnums=(3,))
        self._dec_comp_prog = jax.jit(self._dec_comp_prog_impl,
                                      static_argnums=(3,))

    @property
    def _offset(self) -> int:
        return 0 if self.cfg.is_signed else (1 << (self.cfg.bit_depth - 1))

    @property
    def _meta_chunks(self):
        """Per-chunk meta slices, built once per codec (see
        pipeline.TPUCodec._meta_chunks)."""
        if not hasattr(self, "_meta_chunks_cache"):
            spans = bpc_jax.StagedBPC._spans(self.batch * self.ncb, None)
            self._meta_chunks_cache = (
                None if spans is None else
                [tuple(m[s:e] for m in self._meta) for s, e in spans])
        return self._meta_chunks_cache

    def _put(self, x, dtype=None):
        """Upload with the frame/codeblock axis sharded over the mesh.

        Works for (B, ...) frame batches and (B*ncb, ...) stream/size
        arrays alike: P(axis) constrains only dim 0, and both axes are
        frame-major, so an even split is frame data parallelism."""
        if self.mesh is None:
            return jnp.asarray(x, dtype)
        if isinstance(x, jax.Array) and x.sharding == self._frame_sharding:
            return x if dtype is None else x.astype(dtype)
        arr = np.asarray(x) if dtype is None else np.asarray(x, dtype)
        return jax.device_put(arr, self._frame_sharding)

    # -- device programs ----------------------------------------------------

    def _dwt_tile_one(self, plane_i32):
        cfg = self.cfg
        x = plane_i32.astype(jnp.float32) if cfg.is_lossy else plane_i32
        coeffs = dwt_forward(x, cfg.wavelet_levels, cfg.is_lossy, cfg.qs)
        return plane_to_codeblocks(coeffs.astype(jnp.int32))

    def _prep_gray_impl(self, frames_u8):
        """(B, ah, aw) u8 -> (B*ncb, 64, 64) int32 codeblocks."""
        shifted = frames_u8.astype(jnp.int32) - self._offset
        blocks = jax.vmap(self._dwt_tile_one)(shifted)
        return blocks.reshape(-1, spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH)

    def _prep_rgb_impl(self, frames_u8):
        """(B, 3, ah, aw) u8 -> 3 x (B*ncb, 64, 64) component codeblocks."""
        cfg = self.cfg
        ri = frames_u8[:, 0].astype(jnp.int32) - self._offset
        gi = frames_u8[:, 1].astype(jnp.int32) - self._offset
        bi = frames_u8[:, 2].astype(jnp.int32) - self._offset
        if cfg.is_lossy:
            rf, gf, bf = (x.astype(jnp.float32) for x in (ri, gi, bi))
            m = spec.ICT_FORWARD
            comps = (m[0, 0] * rf + m[0, 1] * gf + m[0, 2] * bf,
                     m[1, 0] * rf + m[1, 1] * gf + m[1, 2] * bf,
                     m[2, 0] * rf + m[2, 1] * gf + m[2, 2] * bf)
        else:
            comps = ((ri + 2 * gi + bi) >> 2, bi - gi, ri - gi)
        out = []
        for comp in comps:
            blocks = jax.vmap(self._dwt_tile_one)(comp)
            out.append(blocks.reshape(-1, spec.CBLOCK_LENGTH,
                                      spec.CBLOCK_WIDTH))
        return tuple(out)

    def _idwt_one(self, blocks):
        cfg = self.cfg
        mallat = codeblocks_to_plane(blocks, self.ah, self.aw)
        return dwt_reverse(mallat, cfg.wavelet_levels, cfg.is_lossy, cfg.qs)

    def _finish_gray_impl(self, blocks_flat):
        cfg = self.cfg
        blocks = blocks_flat.reshape(self.batch, self.ncb,
                                     spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH)
        planes = jax.vmap(self._idwt_one)(blocks)
        mn, mx = _sample_range(cfg)
        out_dtype = _jnp_sample_dtype(cfg)
        if cfg.is_lossy:
            vals = jnp.rint(planes + np.float32(self._offset)
                            + np.float32(0.01))
            return jnp.clip(vals, mn, mx).astype(out_dtype)
        return jnp.clip(planes + self._offset, mn, mx).astype(out_dtype)

    def _finish_rgb_impl(self, c0_flat, c1_flat, c2_flat):
        cfg = self.cfg
        shape = (self.batch, self.ncb, spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH)
        c0, c1, c2 = (jax.vmap(self._idwt_one)(c.reshape(shape))
                      for c in (c0_flat, c1_flat, c2_flat))
        off = self._offset
        if cfg.is_lossy:
            m = spec.ICT_BACKWARD
            outs = []
            for row in range(3):
                v = m[row, 0] * c0 + m[row, 1] * c1 + m[row, 2] * c2
                outs.append(jnp.rint(v + np.float32(0.01)).astype(jnp.int32))
            r, g, b = outs
        else:
            y, u, v = (c.astype(jnp.int32) for c in (c0, c1, c2))
            g = y - ((u + v) >> 2)
            r = v + g
            b = u + g
        mn, mx = _sample_range(cfg)
        out_dtype = _jnp_sample_dtype(cfg)
        return jnp.stack([jnp.clip(c + off, mn, mx).astype(out_dtype)
                          for c in (r, g, b)], axis=1)

    # -- fused one-dispatch programs ----------------------------------------

    def _enc_gray_prog_impl(self, frames_u8, lut, n_planes: int):
        blocks = self._prep_gray_impl(frames_u8)
        streams, sizes = self._fused._encode_impl(blocks, lut,
                                                  self._meta[:3], n_planes)
        return streams.astype(jnp.uint16), sizes

    def _enc_comp_prog_impl(self, blocks, lut, n_planes: int):
        streams, sizes = self._fused._encode_impl(blocks, lut,
                                                  self._meta[:3], n_planes)
        return streams.astype(jnp.uint16), sizes

    def _dec_gray_prog_impl(self, streams, sizes, lut, n_planes: int):
        blocks = self._fused._decode_impl(streams, sizes, lut,
                                          self._meta[:3], n_planes)
        return self._finish_gray_impl(blocks)

    def _dec_comp_prog_impl(self, streams, sizes, lut, n_planes: int):
        return self._fused._decode_impl(streams, sizes, lut,
                                        self._meta[:3], n_planes)

    # -- batch API (device in, device out; caller downloads) ----------------

    def encode_batch(self, frames_u8: np.ndarray, n_planes: int):
        """Padded frame batch -> list per component of (streams, sizes).

        Outputs are DEVICE arrays shaped (B*ncb, 4096) / (B*ncb,); the
        caller downloads them (ideally on a writer thread) and must run
        bpc_jax.check_planes_bound on each component's word-0 column.
        """
        use_fused = self._fused is not None and not _force_staged()
        if self.cfg.is_rgb:
            comps = self._prep_rgb(self._put(frames_u8))
            out = []
            for i, blocks in enumerate(comps):
                lut = self.luts[min(i, len(self.luts) - 1)]
                if use_fused:
                    out.append(self._enc_comp_prog(blocks, lut, n_planes))
                else:
                    s, z = self._staged.encode(blocks, lut, self._meta,
                                               n_planes,
                                               meta_chunks=self._meta_chunks)
                    out.append((self._cast16(s), z))
            return out
        if use_fused:
            return [self._enc_gray_prog(self._put(frames_u8), self.luts[0],
                                        n_planes)]
        blocks = self._prep_gray(self._put(frames_u8))
        s, z = self._staged.encode(blocks, self.luts[0], self._meta, n_planes,
                                   meta_chunks=self._meta_chunks)
        return [(self._cast16(s), z)]

    def encode_batch_packed(self, frames_u8: np.ndarray, n_planes: int,
                            bucket: int):
        """Encode + device-side dense pack (staged engine).

        Returns per component (sizes_dev, msb_dev, dense_dev): the host
        downloads ~the compressed bytes instead of the (N, 4096) padded
        buffer. A bucket overflow (total payload > bucket) is detected
        host-side from sizes; the caller re-encodes with a larger bucket.
        """
        if self.cfg.is_rgb:
            comps = self._prep_rgb(self._put(frames_u8))
        else:
            comps = (self._prep_gray(self._put(frames_u8)),)
        out = []
        for i, blocks in enumerate(comps):
            lut = self.luts[min(i, len(self.luts) - 1)]
            out.append(self._staged.encode_packed(
                blocks, lut, self._meta, n_planes, bucket,
                meta_chunks=self._meta_chunks))
        return out

    def decode_batch(self, comp_streams, n_planes: int) -> np.ndarray:
        """[(streams, sizes)] per component -> (B, ah, aw[, 3]) u8 planes.

        comp_streams holds (B*ncb, 4096) int32 streams and (B*ncb,) sizes
        (host or device); returns a DEVICE array — the caller crops to
        (height, width) after download.
        """
        use_fused = self._fused is not None and not _force_staged()
        if use_fused and not self.cfg.is_rgb:
            streams, sizes = comp_streams[0]
            return self._dec_gray_prog(self._put(streams, np.int32),
                                       self._put(sizes, np.int32),
                                       self.luts[0], n_planes)
        blocks = []
        for i, (streams, sizes) in enumerate(comp_streams):
            lut = self.luts[min(i, len(self.luts) - 1)]
            s = self._put(streams, np.int32)
            z = self._put(sizes, np.int32)
            if use_fused:
                blocks.append(self._dec_comp_prog(s, z, lut, n_planes))
            else:
                blocks.append(self._staged.decode(
                    s, z, lut, self._meta, n_planes,
                    meta_chunks=self._meta_chunks))
        if self.cfg.is_rgb:
            return self._finish_rgb(*blocks)
        return self._finish_gray(blocks[0])
