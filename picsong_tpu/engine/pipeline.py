"""Single-device encode/decode engine: the equivalent of runImage.

Orchestration mirror of Engines/CodingEngine.cu:593-753 and
Engines/DecodingEngine.cu:734-861, re-shaped for XLA: the whole per-plane
compute path — DC shift / color transform, multi-level DWT, codeblock
tiling, BPC-PaCo — is one jit-compiled device program per component; the
host only does file IO, mirror padding and codestream relocation (the
reference also round-trips packing sizes through the host,
BitStreamBuilder.cu:300).

A `TPUCodec` instance caches the compiled programs and per-geometry
codeblock metadata, so video frames reuse the same executable.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..assembly.pack import pack_streams as _py_pack
from ..assembly.pack import unpack_streams as _py_unpack

# host relocation: native C++ when the toolchain is present, NumPy otherwise
pack_streams = native.pack_streams if native.available() else _py_pack
unpack_streams = native.unpack_streams if native.available() else _py_unpack
from ..core import spec
from ..core.geometry import (codeblock_bands, codeblocks_to_plane,
                             plane_to_codeblocks)
from ..core.header import CodecConfig, pack_header
from ..core.image_io import mirror_pad, sample_dtype
from ..core.lut import LUTParams
from ..entropy import bpc_jax
from ..obs.trace import stage
from ..transform.dwt import dwt_forward, dwt_reverse

import os


_BPC_MODES = ("staged", "mono")


def _bpc_mode(var: str) -> str:
    """Entropy-coder selection from an environment variable.

    'staged' (default when unset or empty; host-sequenced
    one-loop-per-program StagedBPC) or 'mono' (one program holding every
    pass). Any other value raises, so a typo cannot silently select
    another coder."""
    mode = os.environ.get(var) or "staged"
    if mode not in _BPC_MODES:
        raise ValueError(f"{var}={mode!r} is not a valid coder; "
                         f"choose one of {', '.join(_BPC_MODES)}")
    return mode


def _decoder_mode() -> str:
    return _bpc_mode("PICSONG_DECODER")


def _sample_range(cfg: CodecConfig) -> tuple[int, int]:
    """Reconstruction clamp range from bit depth / signedness
    (removeOffsetAndApplyMaxMin generalizes 0..255 to the sample type,
    DecodingEngine.cu:706-729 + templated writers IOManager.ipp:214-261)."""
    if cfg.is_signed:
        return -(1 << (cfg.bit_depth - 1)), (1 << (cfg.bit_depth - 1)) - 1
    return 0, (1 << cfg.bit_depth) - 1


def _jnp_sample_dtype(cfg: CodecConfig):
    if cfg.bps <= 8:
        return jnp.int8 if cfg.is_signed else jnp.uint8
    return jnp.int16 if cfg.is_signed else jnp.uint16


def _encoder_mode() -> str:
    return _bpc_mode("PICSONG_ENCODER")


class TPUCodec:
    """Reusable encoder/decoder for one image geometry + configuration.

    chunk_blocks > 0 splits the per-plane codeblock batch into chunks of
    that many codeblocks for the staged entropy coder (the analogue of
    capping the reference's grid size; its kernelLauncher scales by block
    count alone, BPCEngine.cu:2307-2424). Codeblocks are independent, so
    chunking changes peak live-buffer footprint and program shape, never
    bytes. Default 0 = AUTO: batches over 2048 codeblocks split into
    1024-block chunks (bpc_jax._auto_chunk; the threshold is not yet
    measured on the GPU). PICSONG_CHUNK_BLOCKS overrides."""

    def __init__(self, cfg: CodecConfig, luts: list[np.ndarray],
                 params: LUTParams, chunk_blocks: int | None = None):
        self.cfg = cfg
        self.params = params
        if chunk_blocks is None:
            chunk_blocks = int(os.environ.get("PICSONG_CHUNK_BLOCKS", "0"))
        self._chunk = chunk_blocks
        self.luts = [jnp.asarray(l, jnp.int32) for l in luts]
        self.aw, self.ah = spec.adapted_size(cfg.width, cfg.height)
        self.dtype = sample_dtype(cfg.bps, cfg.endianess,
                                  cfg.is_signed).newbyteorder("=")
        levels, subbands = codeblock_bands(self.aw, self.ah, cfg.wavelet_levels)
        self.ncb = len(levels)
        meta = bpc_jax._meta_args(levels, subbands, params, cfg.wavelet_levels,
                                  cfg.coding_passes, cfg.k_factor)
        self._meta = tuple(jnp.asarray(m) for m in meta)
        self._kw = dict(params=params, wavelet_levels=cfg.wavelet_levels,
                        coding_passes=cfg.coding_passes,
                        has_k=cfg.k_factor > 0)
        self._dwt_tile = jax.jit(self._dwt_tile_impl)
        self._untile_idwt = jax.jit(self._untile_idwt_impl)
        self._prep_gray = jax.jit(self._prep_gray_impl)
        self._prep_rgb = jax.jit(self._prep_rgb_impl)
        self._finish_gray = jax.jit(self._finish_gray_impl)
        self._finish_rgb = jax.jit(self._finish_rgb_impl)
        # Default path is 'staged' (host-sequenced one-loop-per-program);
        # the monolithic formulation stays reachable via
        # PICSONG_{ENCODER,DECODER}=mono (see _bpc_mode).
        self._encode_mono = jax.jit(self._encode_mono_impl,
                                    static_argnums=(2,))
        self._decode_mono = jax.jit(self._decode_mono_impl,
                                    static_argnums=(3,))

    def _encode_mono_impl(self, plane, lut, n_planes: int):
        blocks, _ = self._dwt_tile_impl(plane)
        return bpc_jax.encode_blocks(blocks, lut, *self._meta, **self._kw,
                                     n_planes=n_planes)

    def _decode_mono_impl(self, streams, sizes, lut, n_planes: int):
        blocks = bpc_jax.decode_blocks(streams, sizes, lut, *self._meta,
                                       **self._kw, n_planes=n_planes)
        return self._untile_idwt_impl(blocks)

    # -- device programs ---------------------------------------------------

    @property
    def _offset(self) -> int:
        return 0 if self.cfg.is_signed else (1 << (self.cfg.bit_depth - 1))

    def _prep_gray_impl(self, plane_u8):
        """DC level shift (offsetImage, CodingEngine.cu:581-588)."""
        shifted = plane_u8.astype(jnp.int32) - self._offset
        return shifted.astype(jnp.float32) if self.cfg.is_lossy else shifted

    def _prep_rgb_impl(self, r, g, b):
        """Color transform + DC shift (CodingEngine.cu:357-403)."""
        ri = r.astype(jnp.int32) - self._offset
        gi = g.astype(jnp.int32) - self._offset
        bi = b.astype(jnp.int32) - self._offset
        if self.cfg.is_lossy:
            rf, gf, bf = (x.astype(jnp.float32) for x in (ri, gi, bi))
            m = spec.ICT_FORWARD
            return (m[0, 0] * rf + m[0, 1] * gf + m[0, 2] * bf,
                    m[1, 0] * rf + m[1, 1] * gf + m[1, 2] * bf,
                    m[2, 0] * rf + m[2, 1] * gf + m[2, 2] * bf)
        y = (ri + 2 * gi + bi) >> 2
        return y, bi - gi, ri - gi

    def _dwt_tile_impl(self, plane):
        """Stage 1 of encode: DWT + codeblock tiling + max-|coefficient|.

        The max feeds the host-chosen static bitplane count for stage 2
        (the bitplane loop is unrolled at trace time; see
        entropy/bpc_jax.py)."""
        cfg = self.cfg
        coeffs = dwt_forward(plane, cfg.wavelet_levels, cfg.is_lossy, cfg.qs)
        coeffs = coeffs.astype(jnp.int32)
        blocks = plane_to_codeblocks(coeffs)
        return blocks, jnp.max(jnp.abs(blocks))

    @property
    def _staged(self):
        return bpc_jax.get_staged(self.params, self.cfg.wavelet_levels,
                                  self.cfg.coding_passes,
                                  self.cfg.k_factor > 0)

    @property
    def _meta_chunks(self):
        """Per-chunk meta slices, built once per codec geometry (saves
        six slice dispatches per chunk per call in the 8K regime)."""
        if not hasattr(self, "_meta_chunks_cache"):
            spans = bpc_jax.StagedBPC._spans(self.ncb, self._chunk or None)
            self._meta_chunks_cache = (
                None if spans is None else
                [tuple(m[s:e] for m in self._meta) for s, e in spans])
        return self._meta_chunks_cache

    def _staged_encode_chunked(self, blocks, lut, n_planes: int):
        return self._staged.encode(blocks, lut, self._meta, n_planes,
                                   chunk=self._chunk or None,
                                   meta_chunks=self._meta_chunks)

    def _staged_decode_chunked(self, streams, sizes, lut, n_planes: int):
        return self._staged.decode(streams, sizes, lut, self._meta,
                                   n_planes, chunk=self._chunk or None,
                                   meta_chunks=self._meta_chunks)

    def _encode_plane(self, plane, lut, n_planes: int | None = None):
        """n_planes=None reads the coefficient max from the device (a
        host sync between the DWT and the coder); encode() passes the
        host-derived bound from planes_host instead."""
        mode = _encoder_mode()
        if n_planes is None:
            blocks, max_mag = self._dwt_tile(plane)
            n_planes = bpc_jax.planes_for_magnitude(int(max_mag))
            if mode == "staged":
                return self._staged_encode_chunked(blocks, lut, n_planes)
            return bpc_jax.encode_blocks(blocks, lut, *self._meta, **self._kw,
                                         n_planes=n_planes)
        if mode == "staged":
            blocks, _ = self._dwt_tile(plane)
            return self._staged_encode_chunked(blocks, lut, n_planes)
        return self._encode_mono(plane, lut, n_planes)

    def planes_host(self, pixels) -> int:
        """Static bitplane count computed entirely on the CPU backend.

        Replicates prep + DWT + |coefficient| max on the host so that the
        encode needs no device read before the coder runs. Exact for
        lossless (integer lifting is deterministic); lossy adds one plane
        of float-rounding margin. Whether this replica pays for itself on
        the GPU is open (its share of encode time is in PERF.md)."""
        return host_plane_bound(self.cfg, pixels, self.aw, self.ah)

    def _untile_idwt_impl(self, blocks):
        cfg = self.cfg
        mallat = codeblocks_to_plane(blocks, self.ah, self.aw)
        return dwt_reverse(mallat, cfg.wavelet_levels, cfg.is_lossy, cfg.qs)

    def _decode_plane(self, streams, sizes, lut, n_planes):
        mode = _decoder_mode()
        if mode == "staged":
            blocks = self._staged_decode_chunked(streams, sizes, lut,
                                                 n_planes)
            return self._untile_idwt(blocks)
        return self._decode_mono(streams, sizes, lut, n_planes)

    def _finish_gray_impl(self, plane):
        """Undo DC shift and clamp (removeOffsetAndApplyMaxMin,
        DecodingEngine.cu:706-729)."""
        mn, mx = _sample_range(self.cfg)
        out_dtype = _jnp_sample_dtype(self.cfg)
        if self.cfg.is_lossy:
            vals = jnp.rint(plane + np.float32(self._offset) + np.float32(0.01))
            return jnp.clip(vals, mn, mx).astype(out_dtype)
        return jnp.clip(plane + self._offset, mn, mx).astype(out_dtype)

    def _finish_rgb_impl(self, c0, c1, c2):
        """Inverse color transform + clamp (DecodingEngine.cu:599-650)."""
        off = self._offset
        if self.cfg.is_lossy:
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
        mn, mx = _sample_range(self.cfg)
        out_dtype = _jnp_sample_dtype(self.cfg)
        return tuple(jnp.clip(c + off, mn, mx).astype(out_dtype)
                     for c in (r, g, b))

    # -- host-facing API ---------------------------------------------------

    def encode(self, pixels) -> list[np.ndarray]:
        """uint8 plane (gray) or [R, G, B] planes -> component codestreams.

        The static bitplane count comes from a host-side bound
        (planes_host); if the device data ever exceeds it (possible only
        through the lossy float-rounding margin) the guarded pack raises
        PlaneOverflowError and the frame is re-encoded with the corrected
        bound instead of shipping a corrupt stream."""
        n_planes = self.planes_host(pixels)
        while True:
            try:
                return self._encode_attempt(pixels, n_planes)
            except bpc_jax.PlaneOverflowError as e:
                n_planes = e.needed

    def _encode_attempt(self, pixels, n_planes: int) -> list[np.ndarray]:
        cfg = self.cfg
        header = pack_header(cfg)
        if cfg.is_rgb:
            planes = [jnp.asarray(mirror_pad(
                np.asarray(p).astype(self.dtype, copy=False),
                self.aw, self.ah)) for p in pixels]
            comps = self._prep_rgb(*planes)
        else:
            plane = jnp.asarray(mirror_pad(
                np.asarray(pixels).astype(self.dtype, copy=False),
                self.aw, self.ah))
            comps = [self._prep_gray(plane)]
        # enqueue every component's device work before the first download
        device_out = []
        for i, comp in enumerate(comps):
            lut = self.luts[min(i, len(self.luts) - 1)]
            with stage("encode/dwt+bpc"):
                device_out.append(self._encode_plane(comp, lut, n_planes))
        out = []
        for i, (streams, sizes) in enumerate(device_out):
            streams, sizes = np.asarray(streams), np.asarray(sizes)
            # loud guard: if the host-derived bound undercut the true MSB,
            # high bitplanes were silently skipped — corrupt stream
            bpc_jax.check_planes_bound(streams[:, 0], sizes, n_planes)
            with stage("encode/pack"):
                out.append(pack_streams(streams, sizes,
                                        header if i == 0 else None))
        return out

    def decode(self, component_streams: list[np.ndarray]):
        """Component codestreams -> uint8 plane(s) cropped to (h, w)."""
        cfg = self.cfg
        planes = []
        for i, shorts in enumerate(component_streams):
            with stage("decode/unpack"):
                streams, sizes = unpack_streams(shorts, self.ncb)
            lut = self.luts[min(i, len(self.luts) - 1)]
            n_planes = bpc_jax.planes_for_streams(streams[:, 0], sizes)
            with stage("decode/bpc+idwt"):
                planes.append(self._decode_plane(jnp.asarray(streams),
                                                 jnp.asarray(sizes, jnp.int32),
                                                 lut, n_planes))
        if cfg.is_rgb:
            rgb = self._finish_rgb(*planes)
            return [np.asarray(p)[:cfg.height, :cfg.width] for p in rgb]
        plane = self._finish_gray(planes[0])
        return np.asarray(plane)[:cfg.height, :cfg.width]


def host_plane_bound(cfg: CodecConfig, pixels, aw: int, ah: int,
                     extra_margin: int = 0) -> int:
    """Static bitplane bound from a CPU-backend replica of prep + DWT.

    Runs on the CPU backend, so the process needs the CPU platform beside
    the accelerator: do not restrict JAX_PLATFORMS to the GPU alone.
    `extra_margin` shifts the magnitude bound left by that many planes —
    used by the video path, which derives one bound from the first frame
    for the whole sequence and relies on check_planes_bound for
    pathological content."""
    offset = 0 if cfg.is_signed else (1 << (cfg.bit_depth - 1))
    dtype = sample_dtype(cfg.bps, cfg.endianess, cfg.is_signed).newbyteorder("=")
    # local_devices, not devices: under a multi-process jax.distributed
    # runtime, jax.devices() lists GLOBAL devices and index 0 may belong
    # to another process — computing there makes the result unfetchable
    cpu = jax.local_devices(backend="cpu")[0]
    with stage("encode/planes_host"), jax.default_device(cpu):
        if cfg.is_rgb:
            planes = [jnp.asarray(mirror_pad(np.asarray(p).astype(dtype),
                                             aw, ah).astype(np.int32)
                                  - offset) for p in pixels]
            if cfg.is_lossy:
                rf, gf, bf = (p.astype(jnp.float32) for p in planes)
                m = spec.ICT_FORWARD
                comps = [m[i, 0] * rf + m[i, 1] * gf + m[i, 2] * bf
                         for i in range(3)]
            else:
                ri, gi, bi = planes
                comps = [(ri + 2 * gi + bi) >> 2, bi - gi, ri - gi]
        else:
            arr = jnp.asarray(mirror_pad(np.asarray(pixels).astype(dtype),
                                         aw, ah).astype(np.int32) - offset)
            comps = [arr.astype(jnp.float32) if cfg.is_lossy else arr]
        max_mag = 0
        for comp in comps:
            coeffs = dwt_forward(comp, cfg.wavelet_levels, cfg.is_lossy,
                                 cfg.qs)
            max_mag = max(max_mag,
                          int(jnp.max(jnp.abs(coeffs.astype(jnp.int32)))))
    if cfg.is_lossy:
        max_mag *= 2  # one extra plane of float-rounding margin
    return bpc_jax.planes_for_magnitude(max_mag << extra_margin)


# --------------------------------------------------------------------------
# One-shot helpers
# --------------------------------------------------------------------------

def encode_image(pixels, cfg: CodecConfig, luts, params: LUTParams):
    return TPUCodec(cfg, luts, params).encode(pixels)


def decode_image(component_streams, cfg: CodecConfig, luts, params: LUTParams):
    return TPUCodec(cfg, luts, params).decode(component_streams)
