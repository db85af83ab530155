"""NumPy oracle DWT: full-plane CDF 5/3 and 9/7 lifting, Mallat layout.

The reference computes the transform with overlapped 64x18 warp blocks held
in registers (DWT/DWTGenerator.cu:137-339,698-744); interior blocks discard
overlap/2 samples per side, which makes the result *identical* to a
full-plane lifting transform with symmetric boundary extension (the lifting
dependency depth is 2 for 5/3 and 4 for 9/7, exactly the discarded margin).
We therefore implement the mathematically-equal full-plane form — the
natural shape for whole-array vector code — and keep the reference's exact
arithmetic:

- 5/3 integer lifting with arithmetic-shift rounding
  (liftingStep*53*, DWTGenerator.cu:70-85):
    d_i = x_{2i+1} - ((x_{2i} + x_{2i+2}) >> 1)
    s_i = x_{2i}   + ((d_{i-1} + d_i + 2) >> 2)
  with boundary mirror c := a (x_{N} := x_{N-2}, d_{-1} := d_0).
- 9/7 float lifting with K1/K2 normalization (DWTGenerator.cu:89-122).
- Forward: vertical pass then horizontal; reverse: horizontal then vertical
  (DWTGenerator.cu:802-806,1112-1117).
- Lossy quantization folded into the subband write: coefficient * gain * qs
  (writeSubbands, DWTGenerator.cu:403-433); dequantization on read:
  (|q| + 0.5) * sign / gain / qs for q != 0 (readSubbandsLossy, :513-542).
  Intermediate LL planes stay unquantized.
- Output is the standard Mallat mosaic over the adapted plane: each level's
  HL/LH/HH live at their pyramid position; only the final LL is written to
  the top-left corner (initializeCoordinates + host loop,
  DWTGenerator.cu:698-725,1267-1342).
"""

from __future__ import annotations

import numpy as np

from ..core import spec


# --------------------------------------------------------------------------
# One-level 1-D lifting along axis 0 (rows). Arrays must have even length.
# --------------------------------------------------------------------------

def _fwd53_axis0(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    even = x[0::2].astype(np.int64)
    odd = x[1::2].astype(np.int64)
    even_next = np.concatenate([even[1:], even[-1:]], axis=0)
    d = odd - ((even + even_next) >> 1)
    d_prev = np.concatenate([d[:1], d[:-1]], axis=0)
    s = even + ((d_prev + d + 2) >> 2)
    return s.astype(np.int32), d.astype(np.int32)


def _inv53_axis0(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    s = s.astype(np.int64)
    d = d.astype(np.int64)
    d_prev = np.concatenate([d[:1], d[:-1]], axis=0)
    even = s - ((d_prev + d + 2) >> 2)
    even_next = np.concatenate([even[1:], even[-1:]], axis=0)
    odd = d + ((even + even_next) >> 1)
    out = np.empty((s.shape[0] * 2,) + s.shape[1:], dtype=np.int32)
    out[0::2] = even
    out[1::2] = odd
    return out


def _fwd97_axis0(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    even = x[0::2].astype(np.float32).copy()
    odd = x[1::2].astype(np.float32).copy()

    def nxt(a):
        return np.concatenate([a[1:], a[-1:]], axis=0)

    def prv(a):
        return np.concatenate([a[:1], a[:-1]], axis=0)

    odd += (even + nxt(even)) * spec.I97_ALPHA
    even += (prv(odd) + odd) * spec.I97_BETA
    odd += (even + nxt(even)) * spec.I97_GAMMA
    even = (even + (prv(odd) + odd) * spec.I97_DELTA) * spec.I97_K2
    odd *= spec.I97_K1
    return even, odd


def _inv97_axis0(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    even = np.asarray(s, dtype=np.float32).copy()
    odd = np.asarray(d, dtype=np.float32).copy()

    def nxt(a):
        return np.concatenate([a[1:], a[-1:]], axis=0)

    def prv(a):
        return np.concatenate([a[:1], a[:-1]], axis=0)

    odd = odd / spec.I97_K1
    even = even / spec.I97_K2 - (prv(odd) + odd) * spec.I97_DELTA
    odd -= (even + nxt(even)) * spec.I97_GAMMA
    even -= (prv(odd) + odd) * spec.I97_BETA
    odd -= (even + nxt(even)) * spec.I97_ALPHA
    out = np.empty((even.shape[0] * 2,) + even.shape[1:], dtype=np.float32)
    out[0::2] = even
    out[1::2] = odd
    return out


def _fwd_level(plane: np.ndarray, lossy: bool):
    """One 2-D level: vertical then horizontal. Returns (LL, HL, LH, HH)."""
    fwd = _fwd97_axis0 if lossy else _fwd53_axis0
    lo_v, hi_v = fwd(plane)                        # vertical (rows)
    ll, hl = (a.T for a in fwd(lo_v.T))            # horizontal on low rows
    lh, hh = (a.T for a in fwd(hi_v.T))            # horizontal on high rows
    return ll, hl, lh, hh


def _inv_level(ll, hl, lh, hh, lossy: bool) -> np.ndarray:
    inv = _inv97_axis0 if lossy else _inv53_axis0
    lo_v = inv(ll.T, hl.T).T                       # horizontal inverse
    hi_v = inv(lh.T, hh.T).T
    return inv(lo_v, hi_v)                         # vertical inverse


# --------------------------------------------------------------------------
# Multi-level Mallat transform with quantization
# --------------------------------------------------------------------------

def dwt_forward(plane: np.ndarray, levels: int, lossy: bool, qs: float) -> np.ndarray:
    """Forward DWT of a DC-shifted plane into the Mallat mosaic.

    Lossless: int32 in, int32 out. Lossy: float32 math; each subband is
    scaled by WAVELET_QSTEPS[level][band] * qs on write (final LL included,
    intermediate LL not), and the float mosaic is returned — the entropy
    stage truncates toward zero like the reference's (int) cast
    (BPCEngine.cu:49).
    """
    h, w = plane.shape
    out = np.zeros((h, w), dtype=np.float32 if lossy else np.int32)
    cur = plane.astype(np.float32 if lossy else np.int32)
    qs32 = np.float32(qs)
    for level in range(levels):
        ll, hl, lh, hh = _fwd_level(cur, lossy)
        hh_, wh_ = cur.shape[0] // 2, cur.shape[1] // 2
        if lossy:
            g = spec.WAVELET_QSTEPS[level]
            out[:hh_, wh_:2 * wh_] = hl * g[spec.QS_HL] * qs32
            out[hh_:2 * hh_, :wh_] = lh * g[spec.QS_LH] * qs32
            out[hh_:2 * hh_, wh_:2 * wh_] = hh * g[spec.QS_HH] * qs32
            if level == levels - 1:
                out[:hh_, :wh_] = ll * g[spec.QS_LL] * qs32
        else:
            out[:hh_, wh_:2 * wh_] = hl
            out[hh_:2 * hh_, :wh_] = lh
            out[hh_:2 * hh_, wh_:2 * wh_] = hh
            if level == levels - 1:
                out[:hh_, :wh_] = ll
        cur = ll
    return out


def _dequant(q: np.ndarray, gain: np.float32, qs: np.float32) -> np.ndarray:
    """Midpoint dequantization (readSubbandsLossy, DWTGenerator.cu:513-542)."""
    q = q.astype(np.int32)
    mag = np.abs(q).astype(np.float32) + spec.RECONSTRUCTION_FACTOR
    sign = np.where(q < 0, np.float32(-1.0), np.float32(1.0))
    val = mag * sign / gain / qs
    return np.where(q == 0, np.float32(0.0), val).astype(np.float32)


def dwt_reverse(mallat: np.ndarray, levels: int, lossy: bool, qs: float) -> np.ndarray:
    """Inverse DWT from the (integer) Mallat mosaic back to the plane."""
    h, w = mallat.shape
    qs32 = np.float32(qs)
    ll = None
    for level in range(levels - 1, -1, -1):
        hh_, wh_ = h >> (level + 1), w >> (level + 1)
        hl = mallat[:hh_, wh_:2 * wh_]
        lh = mallat[hh_:2 * hh_, :wh_]
        hh = mallat[hh_:2 * hh_, wh_:2 * wh_]
        if lossy:
            g = spec.WAVELET_QSTEPS[level]
            hl = _dequant(hl, g[spec.QS_HL], qs32)
            lh = _dequant(lh, g[spec.QS_LH], qs32)
            hh = _dequant(hh, g[spec.QS_HH], qs32)
            if level == levels - 1:
                ll = _dequant(mallat[:hh_, :wh_], g[spec.QS_LL], qs32)
        elif ll is None:
            ll = mallat[:hh_, :wh_].astype(np.int32)
        ll = _inv_level(ll, hl, lh, hh, lossy)
    return ll
