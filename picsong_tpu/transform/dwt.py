"""JAX DWT: full-plane CDF 5/3 and 9/7 lifting, jit-compiled by XLA.

The reference's overlapped 64x18 register blocks with warp-shuffle
exchanges (DWT/DWTGenerator.cu) are a register-file artifact; the
mathematically identical formulation is a full-plane lifting transform
with symmetric boundary extension, which XLA compiles into a handful of
large fused elementwise passes (see reference/dwt.py for the
equivalence argument and the arithmetic contract). Levels are unrolled at
trace time; every shape is static, so XLA fuses each lifting step chain
into a few kernels.

Bit-exactness: 5/3 runs in int32 with arithmetic right shifts, matching
the reference's `>>` rounding exactly (DWTGenerator.cu:70-85) — the
lossless path is bit-identical to the NumPy oracle (gated in
tests/test_jax_dwt.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import spec


def _split(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Even/odd rows via reshape (sublane-friendly, no strided gather)."""
    h = x.shape[0]
    pairs = x.reshape(h // 2, 2, *x.shape[1:])
    return pairs[:, 0], pairs[:, 1]


def _merge(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    out = jnp.stack([even, odd], axis=1)
    return out.reshape(even.shape[0] * 2, *even.shape[1:])


def _nxt(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([a[1:], a[-1:]], axis=0)


def _prv(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([a[:1], a[:-1]], axis=0)


def _fwd53(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    even, odd = _split(x)
    d = odd - ((even + _nxt(even)) >> 1)
    s = even + ((_prv(d) + d + 2) >> 2)
    return s, d


def _inv53(s: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    even = s - ((_prv(d) + d + 2) >> 2)
    odd = d + ((even + _nxt(even)) >> 1)
    return _merge(even, odd)


def _fwd97(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    even, odd = _split(x)
    odd = odd + (even + _nxt(even)) * spec.I97_ALPHA
    even = even + (_prv(odd) + odd) * spec.I97_BETA
    odd = odd + (even + _nxt(even)) * spec.I97_GAMMA
    even = (even + (_prv(odd) + odd) * spec.I97_DELTA) * spec.I97_K2
    odd = odd * spec.I97_K1
    return even, odd


def _inv97(s: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    odd = d / spec.I97_K1
    even = s / spec.I97_K2 - (_prv(odd) + odd) * spec.I97_DELTA
    odd = odd - (even + _nxt(even)) * spec.I97_GAMMA
    even = even - (_prv(odd) + odd) * spec.I97_BETA
    odd = odd - (even + _nxt(even)) * spec.I97_ALPHA
    return _merge(even, odd)


# Horizontal pass, transpose-free: even/odd columns come from a lane-axis
# deinterleave (reshape (H, W/2, 2)) and neighbor exchange is a lane shift.
# Same arithmetic per element as the transposed formulation (bit-identical
# output) without the 4 transposes per level. Chosen on an earlier
# accelerator; unmeasured against the transposed form on the GPU.

def _split_l(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    h, w = x.shape
    pairs = x.reshape(h, w // 2, 2)
    return pairs[..., 0], pairs[..., 1]


def _merge_l(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    out = jnp.stack([even, odd], axis=2)
    return out.reshape(even.shape[0], even.shape[1] * 2)


def _nxt_l(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)


def _prv_l(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)


def _fwd53_h(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    even, odd = _split_l(x)
    d = odd - ((even + _nxt_l(even)) >> 1)
    s = even + ((_prv_l(d) + d + 2) >> 2)
    return s, d


def _inv53_h(s: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    even = s - ((_prv_l(d) + d + 2) >> 2)
    odd = d + ((even + _nxt_l(even)) >> 1)
    return _merge_l(even, odd)


def _fwd97_h(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    even, odd = _split_l(x)
    odd = odd + (even + _nxt_l(even)) * spec.I97_ALPHA
    even = even + (_prv_l(odd) + odd) * spec.I97_BETA
    odd = odd + (even + _nxt_l(even)) * spec.I97_GAMMA
    even = (even + (_prv_l(odd) + odd) * spec.I97_DELTA) * spec.I97_K2
    odd = odd * spec.I97_K1
    return even, odd


def _inv97_h(s: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    odd = d / spec.I97_K1
    even = s / spec.I97_K2 - (_prv_l(odd) + odd) * spec.I97_DELTA
    odd = odd - (even + _nxt_l(even)) * spec.I97_GAMMA
    even = even - (_prv_l(odd) + odd) * spec.I97_BETA
    odd = odd - (even + _nxt_l(even)) * spec.I97_ALPHA
    return _merge_l(even, odd)


def _fwd_level(plane: jnp.ndarray, lossy: bool):
    fwd_v = _fwd97 if lossy else _fwd53
    fwd_h = _fwd97_h if lossy else _fwd53_h
    lo_v, hi_v = fwd_v(plane)                     # vertical first
    ll, hl = fwd_h(lo_v)                          # then horizontal (lanes)
    lh, hh = fwd_h(hi_v)
    return ll, hl, lh, hh


def _inv_level(ll, hl, lh, hh, lossy: bool):
    inv_v = _inv97 if lossy else _inv53
    inv_h = _inv97_h if lossy else _inv53_h
    lo_v = inv_h(ll, hl)                          # horizontal inverse first
    hi_v = inv_h(lh, hh)
    return inv_v(lo_v, hi_v)


@partial(jax.jit, static_argnames=("levels", "lossy", "qs"))
def dwt_forward(plane: jnp.ndarray, levels: int, lossy: bool,
                qs: float = 1.0) -> jnp.ndarray:
    """Forward multi-level DWT into the Mallat mosaic.

    Lossless: int32 -> int32. Lossy: float32 -> float32 with per-subband
    quantization gain * qs folded into the write (writeSubbands,
    DWTGenerator.cu:403-433); truncate to int32 before entropy coding.
    """
    qs32 = np.float32(qs)
    cur = plane
    quads = []
    for level in range(levels):
        ll, hl, lh, hh = _fwd_level(cur, lossy)
        if lossy:
            g = spec.WAVELET_QSTEPS[level]
            hl = hl * (g[spec.QS_HL] * qs32)
            lh = lh * (g[spec.QS_LH] * qs32)
            hh = hh * (g[spec.QS_HH] * qs32)
            if level == levels - 1:
                ll = ll * (g[spec.QS_LL] * qs32)
        quads.append((hl, lh, hh))
        cur = ll
    out = cur
    for level in range(levels - 1, -1, -1):
        hl, lh, hh = quads[level]
        out = jnp.block([[out, hl], [lh, hh]])
    return out


@partial(jax.jit, static_argnames=("levels", "lossy", "qs"))
def dwt_reverse(mallat: jnp.ndarray, levels: int, lossy: bool,
                qs: float = 1.0) -> jnp.ndarray:
    """Inverse multi-level DWT from an int32 Mallat mosaic.

    Lossy input is midpoint-dequantized per subband:
    (|q| + 0.5) * sign / gain / qs for q != 0 (readSubbandsLossy,
    DWTGenerator.cu:513-542); output is float32. Lossless output is int32.
    """
    h, w = mallat.shape
    qs32 = np.float32(qs)

    def dq(q, gain):
        q = q.astype(jnp.int32)
        mag = jnp.abs(q).astype(jnp.float32) + spec.RECONSTRUCTION_FACTOR
        val = jnp.where(q < 0, -mag, mag) / gain / qs32
        return jnp.where(q == 0, np.float32(0), val)

    ll = None
    for level in range(levels - 1, -1, -1):
        hh_, wh_ = h >> (level + 1), w >> (level + 1)
        hl = mallat[:hh_, wh_:2 * wh_]
        lh = mallat[hh_:2 * hh_, :wh_]
        hh = mallat[hh_:2 * hh_, wh_:2 * wh_]
        if lossy:
            g = spec.WAVELET_QSTEPS[level]
            hl = dq(hl, g[spec.QS_HL])
            lh = dq(lh, g[spec.QS_LH])
            hh = dq(hh, g[spec.QS_HH])
            if level == levels - 1:
                ll = dq(mallat[:hh_, :wh_], g[spec.QS_LL])
        elif ll is None:
            ll = mallat[:hh_, :wh_]
        ll = _inv_level(ll, hl, lh, hh, lossy)
    return ll
