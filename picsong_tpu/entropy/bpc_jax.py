"""Vectorized JAX BPC-PaCo: all codeblocks of a frame coded in one program.

Whole-array reformulation of the reference's warp-per-codeblock kernels
(BPC/BPCEngine.cu:1929-2299). The CUDA design binds one 32-lane warp to
one codeblock and serializes a 64-row x 2-phase scan inside each warp;
here the same scan becomes a `lax.fori_loop` whose body operates on
(32, N) vectors -- 32 warp lanes on the leading axis, N codeblocks on the
minor axis -- so grid-level parallelism is carried by vector width
instead of thread blocks. Every CUDA construct has an algebraic
equivalent:

  divergent branch            -> lane mask + jnp.where
  __shfl_up/down neighbor read-> even/odd column-grid slices
  __activemask + __popc ballot-> masked cumulative sum over the lane axis
  per-warp shared counter     -> (N,) counter vector
  codeword store/load         -> batched scatter/gather on (N, 4096)

Two layout rules shape this file. They were set for an earlier
accelerator and are unmeasured on the GPU:
  1. No array constants (iota/arange/full) inside loop bodies; all index
     grids are computed once before the loops.
  2. Minor dimensions are either N (codeblocks) or a multiple of 128.

The coded streams are bit-identical to the NumPy oracle
(reference/bpc.py), which is itself an exact model of the reference coder;
tests/test_jax_bpc.py gates this.

State layout: the 64x64 coefficient grid is held as two (66, 33, N)
arrays -- even columns and odd columns, each with a one-cell zero border --
so each scan step reads its 8-neighborhood and writes its 32 cells with
static middle-dimension slices and a single dynamic row index.

Coefficient word layout and pass semantics are documented in
reference/bpc.py; this file mirrors it construct-for-construct.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import spec
from ..core.lut import LUTParams, group_base

_LANES = spec.LANES
_ROWS = spec.CBLOCK_LENGTH
_U = jnp.uint32
# NumPy scalars, NOT jnp scalars: a module-level jnp.uint32(...) is a
# concrete device array captured as a constant by every program, while
# NumPy scalars fold into the HLO like literals.
_SIG_BIT = np.uint32(1 << 31)
_CP_BIT = np.uint32(1 << 30)
_REF_BIT = np.uint32(1 << 29)


# --------------------------------------------------------------------------
# Host-side per-codeblock metadata (static per image geometry)
# --------------------------------------------------------------------------

def block_metadata(levels: np.ndarray, subbands: np.ndarray,
                   params: LUTParams, wavelet_levels: int, coding_passes: int,
                   k_factor: float):
    """Per-codeblock LUT group bases and CS coefficients (NumPy, host)."""
    off = params.section_offsets(wavelet_levels, coding_passes)
    n = len(levels)
    meta = {}
    for name, nctx in (("ref", params.ctx_refinement),
                       ("sig", params.ctx_significance),
                       ("sign", params.ctx_sign)):
        base = np.array([off[name] + group_base(params, wavelet_levels,
                                                int(levels[i]), int(subbands[i]), nctx)
                         for i in range(n)], dtype=np.int32)
        meta[name] = base
    if coding_passes == 3:
        aux = (params.section_size(params.ctx_significance, wavelet_levels)
               + params.section_size(params.ctx_sign, wavelet_levels))
        meta["cp_sig"] = meta["sig"] + aux
        meta["cp_sign"] = meta["sign"] + aux
    # k / L2Norm per codeblock (BPCEngine.cu:1684-1692)
    k_over_l2 = np.zeros(n, dtype=np.float32)
    if k_factor > 0:
        for i in range(n):
            row, col = spec.l2norm_column(int(levels[i]), int(subbands[i]),
                                          wavelet_levels)
            k_over_l2[i] = np.float32(k_factor) / spec.WAVELET_QSTEPS[row][col]
    meta["k_over_l2"] = k_over_l2
    meta["stride"] = params.stride_per_group(wavelet_levels)
    return meta


# --------------------------------------------------------------------------
# Column-grid packing: (N, 64, 64) <-> even/odd (66, 33, N) with borders
# --------------------------------------------------------------------------

def _to_grids(words: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    n = words.shape[0]
    te = jnp.zeros((_ROWS + 2, _LANES + 1, n), dtype=_U)
    to = jnp.zeros((_ROWS + 2, _LANES + 1, n), dtype=_U)
    pairs = words.astype(_U).reshape(n, _ROWS, _LANES, 2).transpose(1, 2, 3, 0)
    te = te.at[1:-1, :_LANES, :].set(pairs[:, :, 0, :])
    to = to.at[1:-1, 1:, :].set(pairs[:, :, 1, :])
    return te, to


def _from_grids(te: jnp.ndarray, to: jnp.ndarray) -> jnp.ndarray:
    n = te.shape[-1]
    pairs = jnp.stack([te[1:-1, :_LANES, :], to[1:-1, 1:, :]], axis=2)
    return pairs.transpose(3, 0, 1, 2).reshape(n, _ROWS, _ROWS)


def _or_reduce_rows(x: jnp.ndarray) -> jnp.ndarray:
    """OR-reduce each row of a 2-D array (log-depth fold)."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        rest = x[:, 2 * half:]
        x = x[:, :half] | x[:, half:2 * half]
        if rest.shape[1]:
            x = x.at[:, :rest.shape[1]].set(x[:, :rest.shape[1]] | rest)
    return x[:, 0]


def _neighbors(te3, to3, phase: int):
    """8-neighborhood + current (32, N) cells for one phase (static slices)."""
    if phase == 0:
        cur = te3[1, :_LANES, :]
        nb = dict(ul=to3[0, :_LANES, :], up=te3[0, :_LANES, :], ur=to3[0, 1:, :],
                  lf=to3[1, :_LANES, :], rt=to3[1, 1:, :],
                  bl=to3[2, :_LANES, :], bt=te3[2, :_LANES, :], br=to3[2, 1:, :])
    else:
        cur = to3[1, 1:, :]
        nb = dict(ul=te3[0, :_LANES, :], up=to3[0, 1:, :], ur=te3[0, 1:, :],
                  lf=te3[1, :_LANES, :], rt=te3[1, 1:, :],
                  bl=te3[2, :_LANES, :], bt=to3[2, 1:, :], br=te3[2, 1:, :])
    return cur, nb


def _write_cells(grid, vals, row, phase: int):
    col0 = 0 if phase == 0 else 1
    return jax.lax.dynamic_update_slice(grid, vals[None, :, :],
                                        (row + 1, col0, 0))


# --------------------------------------------------------------------------
# Context formation (exact reference formulas; see reference/bpc.py)
# --------------------------------------------------------------------------

def _sig_ctx(nb):
    return sum((v >> 31).astype(jnp.int32) for v in nb.values())


def _sig_ctx_bulk(nb, plane):
    p = plane.astype(jnp.uint32)
    return sum((((v >> 24) & 31) >= p).astype(jnp.int32) for v in nb.values())


def _sign_ctx_table(h, v):
    out = jnp.zeros_like(h)
    out = jnp.where((h == 0) & (v > 0), 2, out)
    out = jnp.where((h == 0) & (v < 0), 3, out)
    out = jnp.where((h > 0) & (v == 0), 4, out)
    out = jnp.where((h > 0) & (v > 0), 6, out)
    out = jnp.where((h < 0) & (v == 0), 5, out)
    out = jnp.where((h < 0) & (v > 0), 1, out)
    out = jnp.where((h < 0) & (v < 0), 7, out)
    return out


def _sign_ctx(up, lf, rt, bt):
    def c(v):
        sig = (v >> 31) != 0
        return jnp.where(sig, jnp.where((v & 1) == 1, -1, 1), 0).astype(jnp.int32)

    return _sign_ctx_table(c(lf) + c(rt), c(up) + c(bt))


def _sign_ctx_bulk(up, lf, rt, bt, plane):
    p = plane.astype(jnp.uint32)

    def c(v):
        sig = ((v >> 31) != 0) & (((v >> 24) & 31) >= p)
        return jnp.where(sig, jnp.where((v & 1) == 1, -1, 1), 0).astype(jnp.int32)

    return _sign_ctx_table(c(lf) + c(rt), c(up) + c(bt))


def _select_prob(table, idx):
    """table (width, N) probabilities selected per lane by idx (32, N)."""
    return jnp.take_along_axis(table, idx, axis=0)


# --------------------------------------------------------------------------
# The 32-lane arithmetic coder over (32, N) state
# --------------------------------------------------------------------------

def _row_scatter(out, slot, vals):
    """out[n, slot[l, n]] = vals[l, n] with OOB slots dropped."""
    return jax.vmap(lambda row, s, v: row.at[s].set(v, mode="drop"),
                    in_axes=(0, 1, 1))(out, slot, vals)


def _row_gather(out, slot):
    """(32, N) gather: out[n, slot[l, n]]."""
    return jax.vmap(lambda row, s: row[s], in_axes=(0, 1), out_axes=1)(out, slot)


def _ac_encode(state, active, bits, probs, prec: int):
    low, size, resv, counter, out = state
    need = active & (size == 0)
    rank = jnp.cumsum(need, axis=0) - need
    nslot = jnp.minimum(rank + counter[None, :], spec.MAX_RESERVED_SLOT) + 1
    resv = jnp.where(need, nslot, resv)
    counter = jnp.minimum(counter + need.sum(axis=0), spec.MAX_SLOT_COUNT)
    low = jnp.where(need, 0, low)
    size = jnp.where(need, spec.AC_INTERVAL_INIT, size)

    aux = ((size * probs) >> prec) + bits
    one = active & (bits == 1)
    zero = active & (bits == 0)
    size = jnp.where(zero, aux, jnp.where(one, size - aux, size))
    low = jnp.where(one, low + aux, low)

    flush = active & (size == 0)
    slot = jnp.where(flush, resv, out.shape[1])  # OOB -> dropped
    out = _row_scatter(out, slot, low)
    return low, size, resv, counter, out


def _ac_decode(state, streams, active, probs, prec: int):
    """streams is the read-only codestream buffer: it is deliberately NOT
    part of `state` — a never-written array is closed over as a
    loop-invariant instead of being carried through the fori_loop."""
    low, size, cw, counter = state
    need = active & (size == 0)
    rank = jnp.cumsum(need, axis=0) - need
    nslot = jnp.minimum(rank + counter[None, :], spec.MAX_RESERVED_SLOT) + 1
    fetched = _row_gather(streams, nslot)
    cw = jnp.where(need, fetched, cw)
    counter = jnp.minimum(counter + need.sum(axis=0), spec.MAX_SLOT_COUNT)
    low = jnp.where(need, 0, low)
    size = jnp.where(need, spec.AC_INTERVAL_INIT, size)

    aux = ((size * probs) >> prec) + 1
    aux2 = low + aux
    # codewords compare as unsigned (unwritten slots hold -1 == 0xFFFFFFFF,
    # BPCEngine.cu:404-442)
    one = active & (cw.astype(_U) >= aux2.astype(_U))
    zero = active & ~one
    size = jnp.where(one, size - aux, jnp.where(zero, aux - 1, size))
    low = jnp.where(one, aux2, low)
    sym = jnp.where(one, 1, 0)
    return (low, size, cw, counter), sym


def _plane_mask(plane):
    """Decoder approximation mask at a plane: 0x3 << p, or 0x2 at p == 0.

    Closed form of the reference's mask recurrence (Decode,
    BPCEngine.cu:1791-1829)."""
    return jnp.where(plane >= 1, np.uint32(3) << plane.astype(jnp.uint32),
                     np.uint32(2))


def _plane_mask_static(plane: int) -> np.uint32:
    """_plane_mask for a trace-time plane index."""
    return np.uint32(3 << plane if plane >= 1 else 2)


# --------------------------------------------------------------------------
# Coding passes: each is a fori_loop over 64 rows with both phases unrolled
# --------------------------------------------------------------------------

def _plane_consts(plane, extra_flag=0):
    """(shift, pmask, flag) for a static int or traced scalar plane."""
    if isinstance(plane, (int, np.integer)):
        return (np.uint32(plane + 1), _plane_mask_static(plane),
                np.uint32((1 << 31) | extra_flag | (plane << 24)))
    pu = plane.astype(_U)
    return (pu + 1, _plane_mask(plane),
            np.uint32((1 << 31) | extra_flag) | (pu << 24))


def _shift_left(x, plane):
    if isinstance(plane, (int, np.integer)):
        return x << np.uint32(plane)
    return x << plane.astype(_U)


def _split_ac(ac, encode: bool):
    """Loop-carried AC state vs closed-over read-only codestream.

    The encoder mutates its output buffer (scatter), so it must be part of
    the carry; the decoder only gathers from it, and carrying it would
    force a full-buffer rebuild per iteration (see _ac_decode)."""
    if encode:
        return ac, None
    return ac[:4], ac[4]


def _spp_row_body(plane, cb_active, sig9, sign4, prec, encode: bool,
                  three_cp: bool, streams):
    """Row-scan step of the significance-propagation pass, as a closure
    usable either as a fori_loop body directly (_spp_pass) or as one arm
    of the paired SPP+MRP program (_spp_mrp_pass)."""
    shift, pmask, flag = _plane_consts(plane)

    def row_body(r, st):
        te, to, ac = st
        n = te.shape[-1]
        for phase in (0, 1):
            te3 = jax.lax.dynamic_slice(te, (r, 0, 0), (3, _LANES + 1, n))
            to3 = jax.lax.dynamic_slice(to, (r, 0, 0), (3, _LANES + 1, n))
            cur, nb = _neighbors(te3, to3, phase)
            insig = (cur >> 31) == 0
            if three_cp:
                has_nb = sum((v >> 31) for v in nb.values()) > 0
                active = insig & has_nb & cb_active[None, :]
                candidate = insig & ~has_nb & cb_active[None, :]
            else:
                active = insig & cb_active[None, :]
                candidate = None
            ctx = _sig_ctx(nb)
            probs = _select_prob(sig9, ctx)
            if encode:
                bits = ((cur >> shift) & 1).astype(jnp.int32)
                ac = _ac_encode(ac, active, bits, probs, prec)
                newly = active & (bits == 1)
            else:
                ac, bits = _ac_decode(ac, streams, active, probs, prec)
                newly = active & (bits == 1)
            sctx = _sign_ctx(nb["up"], nb["lf"], nb["rt"], nb["bt"])
            sprobs = _select_prob(sign4, sctx >> 1)
            if encode:
                ssym = jnp.where((cur & 1).astype(jnp.int32) == (sctx & 1), 0, 1)
                ac = _ac_encode(ac, newly, ssym, sprobs, prec)
                upd = jnp.where(newly, cur | flag, cur)
            else:
                ac, ssym = _ac_decode(ac, streams, newly, sprobs, prec)
                sbit = jnp.where((ssym & 1) == (sctx & 1), np.uint32(0),
                                 np.uint32(1))
                upd = jnp.where(newly, cur | pmask | flag | sbit, cur)
            if three_cp:
                upd = jnp.where(candidate, upd | _CP_BIT, upd)
            if phase == 0:
                te = _write_cells(te, upd, r, 0)
            else:
                to = _write_cells(to, upd, r, 1)
        return te, to, ac

    return row_body


def _spp_pass(carry, plane, cb_active, sig9, sign4, prec, encode: bool,
              three_cp: bool):
    te, to, ac = carry
    ac, streams = _split_ac(ac, encode)
    row_body = _spp_row_body(plane, cb_active, sig9, sign4, prec, encode,
                             three_cp, streams)
    te, to, ac = jax.lax.fori_loop(0, _ROWS, row_body, (te, to, ac))
    if not encode:
        ac = ac + (streams,)
    return te, to, ac


def _mrp_row_body(plane, cb_active, ref1, prec, encode: bool, streams):
    """Row-scan step of the refinement pass (closure; see _spp_row_body)."""
    shift, pmask, _ = _plane_consts(plane)
    probs = jnp.broadcast_to(ref1[None, :], (_LANES, ref1.shape[0]))

    def row_body(r, st):
        te, to, ac = st
        n = te.shape[-1]
        for phase in (0, 1):
            # slice with the same (3, 33, N) window the other passes use,
            # so chained loops agree on one grid layout
            grid = te if phase == 0 else to
            g3 = jax.lax.dynamic_slice(grid, (r, 0, 0), (3, _LANES + 1, n))
            cur = g3[1, :_LANES, :] if phase == 0 else g3[1, 1:, :]
            refine = ((cur >> 29) & 1) == 1
            active = refine & cb_active[None, :]
            eligible = ~refine & ((cur >> 31) == 1) & cb_active[None, :]
            if encode:
                bits = ((cur >> shift) & 1).astype(jnp.int32)
                ac = _ac_encode(ac, active, bits, probs, prec)
                upd = cur
            else:
                ac, sym = _ac_decode(ac, streams, active, probs, prec)
                patt = _shift_left((sym.astype(_U) << 1) + 1, plane)
                upd = jnp.where(active, (cur & ~pmask) | (pmask & patt), cur)
            upd = jnp.where(eligible, upd | _REF_BIT, upd)
            if phase == 0:
                te = _write_cells(te, upd, r, 0)
            else:
                to = _write_cells(to, upd, r, 1)
        return te, to, ac

    return row_body


def _mrp_pass(carry, plane, cb_active, ref1, prec, encode: bool):
    te, to, ac = carry
    ac, streams = _split_ac(ac, encode)
    row_body = _mrp_row_body(plane, cb_active, ref1, prec, encode, streams)
    te, to, ac = jax.lax.fori_loop(0, _ROWS, row_body, (te, to, ac))
    if not encode:
        ac = ac + (streams,)
    return te, to, ac


def _spp_mrp_pass(carry, plane, cb_active, sig9, sign4, ref1, prec,
                  encode: bool):
    """SPP then MRP for one bitplane as a SINGLE fori_loop program.

    The staged schedule pays one program dispatch per pass (~2*n_planes+4
    calls per direction). This pass halves the count while keeping one
    big-carry loop per program: iterations
    0..63 run the SPP row body, 64..127 the MRP row body, selected with
    lax.cond so each iteration executes only one branch. Stream order is
    unchanged (all SPP rows emit before any MRP row), so output bytes are
    identical to the split passes. cp == 2 only (the cp == 3 cleanup pass
    keeps the split schedule)."""
    te, to, ac = carry
    ac, streams = _split_ac(ac, encode)
    spp_row = _spp_row_body(plane, cb_active, sig9, sign4, prec, encode,
                            False, streams)
    mrp_row = _mrp_row_body(plane, cb_active, ref1, prec, encode, streams)

    def body(i, st):
        r = jnp.where(i < _ROWS, i, i - _ROWS)
        return jax.lax.cond(i < _ROWS,
                            lambda s: spp_row(r, s),
                            lambda s: mrp_row(r, s), st)

    te, to, ac = jax.lax.fori_loop(0, 2 * _ROWS, body, (te, to, ac))
    if not encode:
        ac = ac + (streams,)
    return te, to, ac


def _cp_row_body(plane, cb_active, sig9, sign4, prec, encode: bool, streams):
    """Row-scan step of the cleanup pass (closure; see _spp_row_body)."""
    shift, pmask, flag = _plane_consts(plane, extra_flag=1 << 29)

    def row_body(r, st):
        te, to, ac = st
        n = te.shape[-1]
        for phase in (0, 1):
            te3 = jax.lax.dynamic_slice(te, (r, 0, 0), (3, _LANES + 1, n))
            to3 = jax.lax.dynamic_slice(to, (r, 0, 0), (3, _LANES + 1, n))
            cur, nb = _neighbors(te3, to3, phase)
            active = (((cur >> 30) & 1) == 1) & cb_active[None, :]
            ctx = _sig_ctx(nb)
            probs = _select_prob(sig9, ctx)
            if encode:
                bits = ((cur >> shift) & 1).astype(jnp.int32)
                ac = _ac_encode(ac, active, bits, probs, prec)
            else:
                ac, bits = _ac_decode(ac, streams, active, probs, prec)
            upd = jnp.where(active, cur & ~_CP_BIT, cur)
            newly = active & (bits == 1)
            sctx = _sign_ctx(nb["up"], nb["lf"], nb["rt"], nb["bt"])
            sprobs = _select_prob(sign4, sctx >> 1)
            if encode:
                ssym = jnp.where((cur & 1).astype(jnp.int32) == (sctx & 1), 0, 1)
                ac = _ac_encode(ac, newly, ssym, sprobs, prec)
                upd = jnp.where(newly, upd | flag, upd)
            else:
                ac, ssym = _ac_decode(ac, streams, newly, sprobs, prec)
                sbit = jnp.where((ssym & 1) == (sctx & 1), np.uint32(0),
                                 np.uint32(1))
                upd = jnp.where(newly, upd | pmask | flag | sbit, upd)
            if phase == 0:
                te = _write_cells(te, upd, r, 0)
            else:
                to = _write_cells(to, upd, r, 1)
        return te, to, ac

    return row_body


def _cp_pass(carry, plane, cb_active, sig9, sign4, prec, encode: bool):
    """Cleanup pass (coding_passes == 3)."""
    te, to, ac = carry
    ac, streams = _split_ac(ac, encode)
    row_body = _cp_row_body(plane, cb_active, sig9, sign4, prec, encode,
                            streams)
    te, to, ac = jax.lax.fori_loop(0, _ROWS, row_body, (te, to, ac))
    if not encode:
        ac = ac + (streams,)
    return te, to, ac


def _spp_mrp_cp_pass(carry, plane, spp_act, cp_act, sig9, sign4, ref1,
                     cpsig9, cpsign4, prec, encode: bool):
    """CP-schedule triple: SPP, MRP, then CP for one bitplane as a SINGLE
    fori_loop program (coding_passes == 3).

    The cp=3 split schedule pays 3 program dispatches per plane
    (Encode3CP, BPCEngine.cu:1727-1770); this runs iterations 0..63 as
    SPP rows, 64..127 as MRP rows and 128..191 as CP rows, selected with
    lax.switch so each iteration executes one branch — the cp=3 analogue
    of _spp_mrp_pass. Stream order is unchanged
    (all SPP rows before any MRP row before any CP row), so output bytes
    are identical to the split passes (gated in tests/test_engine.py)."""
    te, to, ac = carry
    ac, streams = _split_ac(ac, encode)
    spp_row = _spp_row_body(plane, spp_act, sig9, sign4, prec, encode,
                            True, streams)
    mrp_row = _mrp_row_body(plane, spp_act, ref1, prec, encode, streams)
    cp_row = _cp_row_body(plane, cp_act, cpsig9, cpsign4, prec, encode,
                          streams)

    def body(i, st):
        which = i // _ROWS
        r = i - which * _ROWS
        return jax.lax.switch(which,
                              (lambda s: spp_row(r, s),
                               lambda s: mrp_row(r, s),
                               lambda s: cp_row(r, s)), st)

    te, to, ac = jax.lax.fori_loop(0, 3 * _ROWS, body, (te, to, ac))
    if not encode:
        ac = ac + (streams,)
    return te, to, ac


def _bulk_pass(carry, entry, cb_active, bases, lut, prec, n_planes: int,
               encode: bool):
    """Fused multi-bitplane pass (complexity scalability, k > 0).

    entry: (N,) per-codeblock entry plane; cells scan row-major and an inner
    loop codes planes entry..0 per cell (encodeBulkMode,
    BPCEngine.cu:1285-1662). bases = (ref_b (N,), sig_grid0 (9, N),
    sign_grid0 (4, N)) -- index grids precomputed outside all loops.

    All per-plane-offset values (activity, plane, LUT rows) are prefetched
    into (n_planes, ...) arrays BEFORE the row loop and dynamic_sliced per
    inner iteration, so no LUT gather is rebuilt inside the loop body."""
    te, to, ac = carry
    ac, streams = _split_ac(ac, encode)
    ref_b, sig_grid0, sign_grid0 = bases
    n = te.shape[-1]
    entry_u = entry.astype(_U)
    top = lut.shape[0] - 1

    # prefetch: index i of each table corresponds to plane = entry - i
    # (per codeblock -- entry varies across the batch, so these stay
    # gathers, but they run ONCE per program instead of 128*n_planes times)
    iP = jnp.arange(n_planes, dtype=jnp.int32)[:, None]       # (P, 1)
    plane_all = entry[None, :] - iP                            # (P, N)
    act_all = cb_active[None, :] & (plane_all >= 0)            # (P, N)
    pu_all = jnp.maximum(plane_all, 0)                         # (P, N)
    ref_all = lut[jnp.clip(ref_b[None, :] + plane_all, 0, top)]
    sig_all = lut[jnp.clip(sig_grid0[None, :, :]
                           + plane_all[:, None, :] * 9, 0, top)]   # (P, 9, N)
    sign_all = lut[jnp.clip(sign_grid0[None, :, :]
                            + plane_all[:, None, :] * 4, 0, top)]  # (P, 4, N)

    def row_body(r, st):
        te, to, ac = st
        for phase in (0, 1):
            te3 = jax.lax.dynamic_slice(te, (r, 0, 0), (3, _LANES + 1, n))
            to3 = jax.lax.dynamic_slice(to, (r, 0, 0), (3, _LANES + 1, n))
            cur, nb = _neighbors(te3, to3, phase)
            ctx_b = _sig_ctx_bulk(nb, entry_u[None, :])
            ctx_n = _sig_ctx(nb)
            ctx = jnp.where((entry != 0)[None, :], ctx_b, ctx_n)

            def plane_body(i, inner):
                work, ac = inner
                act = jax.lax.dynamic_slice(act_all, (i, 0), (1, n))[0]
                pu = jax.lax.dynamic_slice(pu_all, (i, 0), (1, n))[0]
                shift = pu.astype(_U)[None, :] + 1
                pmask = _plane_mask(pu)[None, :]
                ref_p = jax.lax.dynamic_slice(ref_all, (i, 0), (1, n))[0]
                sig9 = jax.lax.dynamic_slice(sig_all, (i, 0, 0), (1, 9, n))[0]
                sign4 = jax.lax.dynamic_slice(sign_all, (i, 0, 0),
                                              (1, 4, n))[0]

                sig_lane = (work >> 31) == 1
                a_ref = sig_lane & act[None, :]
                probs = jnp.broadcast_to(ref_p[None, :], (_LANES, n))
                if encode:
                    bits = ((work >> shift) & 1).astype(jnp.int32)
                    ac = _ac_encode(ac, a_ref, bits, probs, prec)
                else:
                    ac, sym = _ac_decode(ac, streams, a_ref, probs, prec)
                    patt = (((sym.astype(_U) << 1) + 1)
                            << pu.astype(_U)[None, :])
                    work = jnp.where(a_ref, (work & ~pmask) | (pmask & patt),
                                     work)
                insig = ((work >> 31) == 0) & act[None, :]
                sprob = _select_prob(sig9, ctx)
                if encode:
                    bits = ((work >> shift) & 1).astype(jnp.int32)
                    ac = _ac_encode(ac, insig, bits, sprob, prec)
                    newly = insig & (bits == 1)
                else:
                    ac, bits = _ac_decode(ac, streams, insig, sprob, prec)
                    newly = insig & (bits == 1)
                flag = _SIG_BIT | (pu.astype(_U)[None, :] << 24)
                sctx = _sign_ctx_bulk(nb["up"], nb["lf"], nb["rt"], nb["bt"],
                                      pu[None, :])
                sgp = _select_prob(sign4, sctx >> 1)
                if encode:
                    ssym = jnp.where((work & 1).astype(jnp.int32) == (sctx & 1),
                                     0, 1)
                    ac = _ac_encode(ac, newly, ssym, sgp, prec)
                    work = jnp.where(newly, work | flag, work)
                else:
                    ac, ssym = _ac_decode(ac, streams, newly, sgp, prec)
                    sbit = jnp.where((ssym & 1) == (sctx & 1), np.uint32(0),
                                     np.uint32(1))
                    work = jnp.where(newly, work | pmask | flag | sbit, work)
                return work, ac

            cur, ac = jax.lax.fori_loop(0, n_planes, plane_body, (cur, ac))
            if phase == 0:
                te = _write_cells(te, cur, r, 0)
            else:
                to = _write_cells(to, cur, r, 1)
        return te, to, ac

    te, to, ac = jax.lax.fori_loop(0, _ROWS, row_body, (te, to, ac))
    if not encode:
        ac = ac + (streams,)
    return te, to, ac


# --------------------------------------------------------------------------
# Raw-copy fallback layout (expansionFix, BPCEngine.cu:1905-1922)
# --------------------------------------------------------------------------

def _raw_layout(T_words: jnp.ndarray) -> jnp.ndarray:
    """(N, 64, 64) coefficient words -> (N, 4096) lane-major low-16 copy."""
    n = T_words.shape[0]
    v = (T_words & 0xFFFF).astype(jnp.int32)
    # out[lane*128 + row*2 + parity] = T[row, lane*2 + parity]
    return v.reshape(n, _ROWS, _LANES, 2).transpose(0, 2, 1, 3).reshape(n, -1)


def _raw_unlayout(cs: jnp.ndarray) -> jnp.ndarray:
    n = cs.shape[0]
    v = (cs.astype(jnp.int32) & 0xFFFF).astype(_U)
    return v.reshape(n, _LANES, _ROWS, 2).transpose(0, 2, 1, 3).reshape(
        n, _ROWS, _ROWS)


# --------------------------------------------------------------------------
# Top-level encode / decode
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params", "wavelet_levels", "coding_passes",
                                   "has_k", "n_planes"))
def encode_blocks(blocks: jnp.ndarray, lut: jnp.ndarray,
                  ref_base: jnp.ndarray, sig_base: jnp.ndarray,
                  sign_base: jnp.ndarray, cp_sig_base: jnp.ndarray,
                  cp_sign_base: jnp.ndarray, k_over_l2: jnp.ndarray,
                  *, params: LUTParams, wavelet_levels: int,
                  coding_passes: int, has_k: bool, n_planes: int):
    """Encode (N, 64, 64) int32 codeblocks -> (streams (N, 4096), sizes).

    n_planes is a static upper bound on max(MSB)+1 over the batch (use
    planes_for_magnitude on the host). The bitplane loop is unrolled at
    trace time rather than run as a traced-bound outer loop around the
    row-scan fori, so each loop keeps in-place buffer aliasing."""
    n = blocks.shape[0]
    prec = params.mult_precision
    stride = params.stride_per_group(wavelet_levels)

    mag = jnp.abs(blocks).astype(_U)
    sign = (blocks < 0).astype(_U)
    words = (mag << 1) | sign
    if coding_passes == 3:
        words = words | _CP_BIT

    # findMSB / findMSB3CP
    msb_or = _or_reduce_rows((words >> 1).reshape(n, -1))
    if coding_passes == 3:
        msb_or = msb_or & ~_REF_BIT
    msb = 31 - jax.lax.clz(msb_or).astype(jnp.int32)   # -1 for empty blocks
    empty = msb_or == 0

    if has_k and coding_passes == 2:
        consec = jnp.maximum(jnp.floor(msb.astype(jnp.float32) * k_over_l2), 0
                             ).astype(jnp.int32)
        s_group = jnp.minimum(consec, jnp.maximum(msb, 0))
        s_off = s_group * stride
    else:
        consec = jnp.zeros(n, jnp.int32)
        s_off = jnp.zeros(n, jnp.int32)

    ref_b = ref_base + s_off
    sig_b = sig_base + s_off
    sign_b = sign_base + s_off

    # index grids computed once, outside every loop body
    i9 = jnp.arange(9, dtype=jnp.int32)[:, None]
    i4 = jnp.arange(4, dtype=jnp.int32)[:, None]
    sig_grid0 = sig_b[None, :] + i9
    sign_grid0 = sign_b[None, :] + i4
    cp_sig_grid0 = cp_sig_base[None, :] + i9
    cp_sign_grid0 = cp_sign_base[None, :] + i4

    te, to = _to_grids(words)
    out = jnp.full((n, spec.CBLOCK_SIZE), -1, jnp.int32)
    ac = (jnp.zeros((_LANES, n), jnp.int32), jnp.zeros((_LANES, n), jnp.int32),
          jnp.zeros((_LANES, n), jnp.int32), jnp.zeros(n, jnp.int32), out)

    def prefetch(grid0, nctx, plane):
        return lut[jnp.clip(grid0 + plane * nctx, 0, lut.shape[0] - 1)]

    for plane in range(n_planes - 1, -1, -1):
        in_range = plane <= msb
        sig9 = prefetch(sig_grid0, 9, plane)
        sign4 = prefetch(sign_grid0, 4, plane)
        ref1 = lut[jnp.clip(ref_b + plane, 0, lut.shape[0] - 1)]
        if coding_passes == 2:
            act = in_range & (plane >= consec)
            te, to, ac = _spp_pass((te, to, ac), plane, act, sig9, sign4, prec,
                                   True, False)
            te, to, ac = _mrp_pass((te, to, ac), plane, act, ref1, prec, True)
        else:
            cpsig9 = prefetch(cp_sig_grid0, 9, plane)
            cpsign4 = prefetch(cp_sign_grid0, 4, plane)
            spp_act = in_range & (plane < msb)
            te, to, ac = _spp_pass((te, to, ac), plane, spp_act, sig9, sign4,
                                   prec, True, True)
            te, to, ac = _mrp_pass((te, to, ac), plane, spp_act, ref1, prec,
                                   True)
            te, to, ac = _cp_pass((te, to, ac), plane, in_range, cpsig9,
                                  cpsign4, prec, True)

    if has_k and coding_passes == 2:
        entry = jnp.minimum(consec, jnp.maximum(msb, 0)) - 1
        entry = jnp.where(consec > msb, msb, entry)
        bulk_act = (entry >= 0) & ~empty
        te, to, ac = _bulk_pass((te, to, ac), jnp.maximum(entry, 0), bulk_act,
                                (ref_b, sig_grid0, sign_grid0), lut, prec,
                                n_planes, True)

    low, size, resv, counter, out = ac
    # final flush: every lane stores its last codeword (BPCEngine.cu:1719)
    out = _row_scatter(out, resv, low)

    out = out.at[:, 0].set(jnp.where(empty, 32, msb))
    sizes = jnp.where(empty, 1, counter + 1)

    raw = _raw_layout(_from_grids(te, to))
    expand = (sizes == spec.CBLOCK_SIZE)[:, None]
    out = jnp.where(expand, raw, out)
    return out, sizes


@partial(jax.jit, static_argnames=("params", "wavelet_levels", "coding_passes",
                                   "has_k", "n_planes"))
def decode_blocks(streams: jnp.ndarray, sizes: jnp.ndarray, lut: jnp.ndarray,
                  ref_base: jnp.ndarray, sig_base: jnp.ndarray,
                  sign_base: jnp.ndarray, cp_sig_base: jnp.ndarray,
                  cp_sign_base: jnp.ndarray, k_over_l2: jnp.ndarray,
                  *, params: LUTParams, wavelet_levels: int,
                  coding_passes: int, has_k: bool, n_planes: int) -> jnp.ndarray:
    """Decode (N, 4096) streams -> (N, 64, 64) int32 coefficients.

    n_planes: static bound on max(MSB)+1 (use planes_for_streams)."""
    n = streams.shape[0]
    prec = params.mult_precision
    stride = params.stride_per_group(wavelet_levels)

    msb_word = streams[:, 0]
    is_raw = sizes == spec.CBLOCK_SIZE
    skip = (msb_word == 32) | is_raw
    msb = jnp.where(skip, -1, msb_word)

    if has_k and coding_passes == 2:
        consec = jnp.maximum(jnp.floor(msb.astype(jnp.float32) * k_over_l2), 0
                             ).astype(jnp.int32)
        s_group = jnp.minimum(consec, jnp.maximum(msb, 0))
        s_off = s_group * stride
    else:
        consec = jnp.zeros(n, jnp.int32)
        s_off = jnp.zeros(n, jnp.int32)

    ref_b = ref_base + s_off
    sig_b = sig_base + s_off
    sign_b = sign_base + s_off

    i9 = jnp.arange(9, dtype=jnp.int32)[:, None]
    i4 = jnp.arange(4, dtype=jnp.int32)[:, None]
    sig_grid0 = sig_b[None, :] + i9
    sign_grid0 = sign_b[None, :] + i4
    cp_sig_grid0 = cp_sig_base[None, :] + i9
    cp_sign_grid0 = cp_sign_base[None, :] + i4

    init = jnp.zeros((n, _ROWS, _ROWS), _U)
    if coding_passes == 3:
        init = init | _CP_BIT   # initializeCoefficients3CP (BPCEngine.cu:124)
    te, to = _to_grids(init)

    ac = (jnp.zeros((_LANES, n), jnp.int32), jnp.zeros((_LANES, n), jnp.int32),
          jnp.zeros((_LANES, n), jnp.int32), jnp.zeros(n, jnp.int32), streams)

    def prefetch(grid0, nctx, plane):
        return lut[jnp.clip(grid0 + plane * nctx, 0, lut.shape[0] - 1)]

    for plane in range(n_planes - 1, -1, -1):
        in_range = plane <= msb
        sig9 = prefetch(sig_grid0, 9, plane)
        sign4 = prefetch(sign_grid0, 4, plane)
        ref1 = lut[jnp.clip(ref_b + plane, 0, lut.shape[0] - 1)]
        if coding_passes == 2:
            act = in_range & (plane >= consec)
            te, to, ac = _spp_pass((te, to, ac), plane, act, sig9, sign4, prec,
                                   False, False)
            te, to, ac = _mrp_pass((te, to, ac), plane, act, ref1, prec, False)
        else:
            cpsig9 = prefetch(cp_sig_grid0, 9, plane)
            cpsign4 = prefetch(cp_sign_grid0, 4, plane)
            spp_act = in_range & (plane < msb)
            te, to, ac = _spp_pass((te, to, ac), plane, spp_act, sig9, sign4,
                                   prec, False, True)
            te, to, ac = _mrp_pass((te, to, ac), plane, spp_act, ref1, prec,
                                   False)
            te, to, ac = _cp_pass((te, to, ac), plane, in_range, cpsig9,
                                  cpsign4, prec, False)

    if has_k and coding_passes == 2:
        entry = jnp.minimum(consec, jnp.maximum(msb, 0)) - 1
        entry = jnp.where(consec > msb, msb, entry)
        bulk_act = entry >= 0
        te, to, ac = _bulk_pass((te, to, ac), jnp.maximum(entry, 0), bulk_act,
                                (ref_b, sig_grid0, sign_grid0), lut, prec,
                                n_planes, False)

    words = _from_grids(te, to)
    words = jnp.where(is_raw[:, None, None], _raw_unlayout(streams), words)

    out = ((words & spec.MAGNITUDE_MASK) >> 1).astype(jnp.int32)
    return jnp.where((words & 1) == 1, -out, out)


# --------------------------------------------------------------------------
# Fused single-dispatch engine: init + ONE flattened loop + finish
# --------------------------------------------------------------------------
#
# The staged engine (below) issues 2 x n_planes program calls per encode;
# this engine runs the whole coder in ONE program per direction
# (PICSONG_VIDEO_BPC=fused selects it for batched video).
#
# Rule 3 (one big-carry loop per jitted program) forbids chaining the
# per-pass row loops, so the fused engine flattens (plane, pass, row) into
# a SINGLE fori_loop of 2 * n_planes * 64 iterations whose body is the
# union of the SPP and MRP row steps: the inactive pass's lane masks are
# zero, making its AC transitions no-ops (`where`-masked, never branched).
# All per-plane LUT tables are prefetched into (n_planes, ctx, N) arrays
# before the loop (one gather each) and dynamic_sliced per iteration.
# Covers cp == 2, k == 0 (the video configuration); others use staged/mono.

class FusedBPC:
    """One-program BPC engine for cp=2, k=0."""

    def __init__(self, params: LUTParams, wavelet_levels: int):
        self.params = params
        self.wavelet_levels = wavelet_levels
        self._encode = jax.jit(self._encode_impl, static_argnums=(3,))
        self._decode = jax.jit(self._decode_impl, static_argnums=(4,))

    def _tables(self, lut, meta, n_planes: int):
        """Prefetch per-plane LUT tables: one gather per section."""
        ref_base, sig_base, sign_base = meta[0], meta[1], meta[2]
        planes = jnp.arange(n_planes, dtype=jnp.int32)[:, None, None]
        i9 = jnp.arange(9, dtype=jnp.int32)[None, :, None]
        i4 = jnp.arange(4, dtype=jnp.int32)[None, :, None]
        top = lut.shape[0] - 1
        sig_all = lut[jnp.clip(sig_base[None, None, :] + planes * 9 + i9,
                               0, top)]
        sign_all = lut[jnp.clip(sign_base[None, None, :] + planes * 4 + i4,
                                0, top)]
        ref_all = lut[jnp.clip(ref_base[None, None, :] + planes, 0, top)]
        return sig_all, sign_all, ref_all        # (P,9,N) (P,4,N) (P,1,N)

    def _loop(self, te, to, ac, msb, tables, n_planes: int, encode: bool,
              streams=None):
        prec = self.params.mult_precision
        sig_all, sign_all, ref_all = tables
        n = te.shape[-1]

        def body(i, st):
            te, to, ac = st
            plane = n_planes - 1 - i // (2 * _ROWS)
            within = i % (2 * _ROWS)
            is_spp = within < _ROWS
            r = within % _ROWS
            shift, pmask, flag = _plane_consts(plane)
            sig9 = jax.lax.dynamic_slice(sig_all, (plane, 0, 0),
                                         (1, 9, n))[0]
            sign4 = jax.lax.dynamic_slice(sign_all, (plane, 0, 0),
                                          (1, 4, n))[0]
            ref1 = jax.lax.dynamic_slice(ref_all, (plane, 0, 0), (1, 1, n))[0]
            probs_r = jnp.broadcast_to(ref1, (_LANES, n))
            act_cb = plane <= msb
            for phase in (0, 1):
                te3 = jax.lax.dynamic_slice(te, (r, 0, 0), (3, _LANES + 1, n))
                to3 = jax.lax.dynamic_slice(to, (r, 0, 0), (3, _LANES + 1, n))
                cur, nb = _neighbors(te3, to3, phase)
                # SPP side (masked off when is_spp is False)
                insig = (cur >> 31) == 0
                a_sig = insig & act_cb[None, :] & is_spp
                ctx = _sig_ctx(nb)
                probs = _select_prob(sig9, ctx)
                sctx = _sign_ctx(nb["up"], nb["lf"], nb["rt"], nb["bt"])
                sprobs = _select_prob(sign4, sctx >> 1)
                # MRP side (masked off when is_spp is True)
                refine = ((cur >> 29) & 1) == 1
                a_ref = refine & act_cb[None, :] & ~is_spp
                eligible = ~refine & ((cur >> 31) == 1) & act_cb[None, :] \
                    & ~is_spp
                if encode:
                    bits = ((cur >> shift) & 1).astype(jnp.int32)
                    ac = _ac_encode(ac, a_sig, bits, probs, prec)
                    newly = a_sig & (bits == 1)
                    ssym = jnp.where((cur & 1).astype(jnp.int32) == (sctx & 1),
                                     0, 1)
                    ac = _ac_encode(ac, newly, ssym, sprobs, prec)
                    upd = jnp.where(newly, cur | flag, cur)
                    ac = _ac_encode(ac, a_ref, bits, probs_r, prec)
                else:
                    ac, bits = _ac_decode(ac, streams, a_sig, probs, prec)
                    newly = a_sig & (bits == 1)
                    ac, ssym = _ac_decode(ac, streams, newly, sprobs, prec)
                    sbit = jnp.where((ssym & 1) == (sctx & 1), np.uint32(0),
                                     np.uint32(1))
                    upd = jnp.where(newly, cur | pmask | flag | sbit, cur)
                    ac, sym = _ac_decode(ac, streams, a_ref, probs_r, prec)
                    patt = _shift_left((sym.astype(_U) << 1) + 1, plane)
                    upd = jnp.where(a_ref, (upd & ~pmask) | (pmask & patt),
                                    upd)
                upd = jnp.where(eligible, upd | _REF_BIT, upd)
                if phase == 0:
                    te = _write_cells(te, upd, r, 0)
                else:
                    to = _write_cells(to, upd, r, 1)
            return te, to, ac

        return jax.lax.fori_loop(0, 2 * n_planes * _ROWS, body, (te, to, ac))

    def _encode_impl(self, blocks, lut, meta, n_planes: int):
        n = blocks.shape[0]
        mag = jnp.abs(blocks).astype(_U)
        sign = (blocks < 0).astype(_U)
        words = (mag << 1) | sign
        msb_or = _or_reduce_rows((words >> 1).reshape(n, -1))
        msb = 31 - jax.lax.clz(msb_or).astype(jnp.int32)
        empty = msb_or == 0
        te, to = _to_grids(words)
        out = jnp.full((n, spec.CBLOCK_SIZE), -1, jnp.int32)
        z = jnp.zeros((_LANES, n), jnp.int32)
        ac = (z, z, z, jnp.zeros(n, jnp.int32), out)
        tables = self._tables(lut, meta, n_planes)
        te, to, ac = self._loop(te, to, ac, msb, tables, n_planes, True)
        low, size, resv, counter, out = ac
        out = _row_scatter(out, resv, low)
        out = out.at[:, 0].set(jnp.where(empty, 32, msb))
        sizes = jnp.where(empty, 1, counter + 1)
        raw = _raw_layout(_from_grids(te, to))
        expand = (sizes == spec.CBLOCK_SIZE)[:, None]
        out = jnp.where(expand, raw, out)
        return out, sizes

    def _decode_impl(self, streams, sizes, lut, meta, n_planes: int):
        n = streams.shape[0]
        msb_word = streams[:, 0]
        is_raw = sizes == spec.CBLOCK_SIZE
        skip = (msb_word == 32) | is_raw
        msb = jnp.where(skip, -1, msb_word)
        init = jnp.zeros((n, _ROWS, _ROWS), _U)
        te, to = _to_grids(init)
        z = jnp.zeros((_LANES, n), jnp.int32)
        ac = (z, z, z, jnp.zeros(n, jnp.int32))
        tables = self._tables(lut, meta, n_planes)
        te, to, _ = self._loop(te, to, ac, msb, tables, n_planes, False,
                               streams=streams)
        words = _from_grids(te, to)
        words = jnp.where(is_raw[:, None, None], _raw_unlayout(streams), words)
        out = ((words & spec.MAGNITUDE_MASK) >> 1).astype(jnp.int32)
        return jnp.where((words & 1) == 1, -out, out)

    # -- public API (mirrors StagedBPC) -------------------------------------

    def encode(self, blocks, lut, meta, n_planes: int):
        return self._encode(blocks, lut, meta[:3], n_planes)

    def decode(self, streams, sizes, lut, meta, n_planes: int):
        return self._decode(streams, sizes, lut, meta[:3], n_planes)


_fused_cache: dict = {}


def get_fused(params: LUTParams, wavelet_levels: int) -> FusedBPC:
    key = (params, wavelet_levels)
    if key not in _fused_cache:
        _fused_cache[key] = FusedBPC(params, wavelet_levels)
    return _fused_cache[key]


# --------------------------------------------------------------------------
# Convenience wrappers: metadata preparation + jitted call
# --------------------------------------------------------------------------

def planes_for_magnitude(max_magnitude: int, quantum: int = 4) -> int:
    """Static bitplane count covering a maximum |coefficient|.

    Rounded up to a multiple of `quantum` to bound the number of distinct
    compiled executables (extra planes are fully masked and cheap)."""
    msb = int(max_magnitude).bit_length() - 1 if max_magnitude > 0 else -1
    need = msb + 1
    return max(-(-need // quantum) * quantum, quantum) if need > 0 else quantum


class PlaneOverflowError(OverflowError):
    """The static bitplane bound was lower than a codeblock's true MSB.

    Raised by check_planes_bound when an encode ran with n_planes <= MSB:
    the planes above the bound were never coded, so the stream would decode
    to corrupt data (the reference cannot hit this — its per-block MSB is
    read on device, BPCEngine.cu:1998 — but our host-derived bound can be
    undercut by lossy float-rounding margins). `needed` is a valid n_planes
    to retry with."""

    def __init__(self, msb: int, n_planes: int, quantum: int = 4):
        self.msb = msb
        self.needed = max(-(-(msb + 1) // quantum) * quantum, quantum)
        super().__init__(
            f"codeblock MSB {msb} exceeds the static bitplane bound "
            f"n_planes={n_planes}; high bitplanes were not coded. "
            f"Retry with n_planes >= {self.needed}.")


def check_planes_bound(msb_words, sizes, n_planes: int) -> None:
    """Fail loudly if any encoded block's true MSB exceeded the bound.

    The encoder writes each block's true MSB (computed on device from the
    coefficients, independent of n_planes) as stream word 0, so this check
    costs nothing extra: it runs on the already-downloaded streams. Raw
    fallback blocks (sizes == 4096) carry verbatim data and are exempt."""
    msb_words = np.asarray(msb_words)
    sizes = np.asarray(sizes)
    real = (msb_words != 32) & (sizes != spec.CBLOCK_SIZE)
    if real.any():
        msb = int(msb_words[real].max())
        if msb + 1 > n_planes:
            raise PlaneOverflowError(msb, n_planes)


def planes_for_streams(msb_words, sizes, quantum: int = 4) -> int:
    """Static bitplane count for decoding a batch of codeblock streams."""
    msb_words = np.asarray(msb_words)
    sizes = np.asarray(sizes)
    real = (msb_words != 32) & (sizes != spec.CBLOCK_SIZE)
    msb = int(msb_words[real].max()) if real.any() else -1
    need = msb + 1
    return max(-(-need // quantum) * quantum, quantum) if need > 0 else quantum


def _meta_args(levels, subbands, params, wavelet_levels, coding_passes,
               k_factor):
    meta = block_metadata(np.asarray(levels), np.asarray(subbands), params,
                          wavelet_levels, coding_passes, k_factor)
    zeros = np.zeros(len(levels), dtype=np.int32)
    return (meta["ref"], meta["sig"], meta["sign"],
            meta.get("cp_sig", zeros), meta.get("cp_sign", zeros),
            meta["k_over_l2"])


_staged_cache: dict = {}


def get_staged(params: LUTParams, wavelet_levels: int, coding_passes: int,
               has_k: bool) -> StagedBPC:
    key = (params, wavelet_levels, coding_passes, has_k)
    if key not in _staged_cache:
        _staged_cache[key] = StagedBPC(params, wavelet_levels, coding_passes,
                                       has_k)
    return _staged_cache[key]


def encode(blocks, levels, subbands, lut, params: LUTParams,
           wavelet_levels: int, coding_passes: int = 2, k_factor: float = 0.0):
    """NumPy-friendly entry: encode codeblocks on the default device.

    Uses the staged (one-loop-per-program) path for every configuration,
    including k > 0 (the bulk multi-bitplane pass runs as its own staged
    program)."""
    args = _meta_args(levels, subbands, params, wavelet_levels, coding_passes,
                      k_factor)
    n_planes = planes_for_magnitude(int(np.max(np.abs(blocks))))
    staged = get_staged(params, wavelet_levels, coding_passes, k_factor > 0)
    meta = tuple(jnp.asarray(a) for a in args)
    out, sizes = staged.encode(jnp.asarray(blocks, jnp.int32),
                               jnp.asarray(lut, jnp.int32), meta, n_planes)
    return np.asarray(out), np.asarray(sizes)


def decode(streams, sizes, levels, subbands, lut, params: LUTParams,
           wavelet_levels: int, coding_passes: int = 2, k_factor: float = 0.0):
    """NumPy-friendly entry: decode codeblock streams."""
    args = _meta_args(levels, subbands, params, wavelet_levels, coding_passes,
                      k_factor)
    n_planes = planes_for_streams(np.asarray(streams)[:, 0], sizes)
    staged = get_staged(params, wavelet_levels, coding_passes, k_factor > 0)
    meta = tuple(jnp.asarray(a) for a in args)
    out = staged.decode(jnp.asarray(streams, jnp.int32),
                        jnp.asarray(sizes, jnp.int32),
                        jnp.asarray(lut, jnp.int32), meta, n_planes)
    return np.asarray(out)


# --------------------------------------------------------------------------
# Staged execution: one single-loop program per coding pass
# --------------------------------------------------------------------------
#
# The staged path keeps ONE fori_loop over the big carries per program
# (rule 3: programs chaining two or more such loops lost buffer aliasing
# on the accelerator this schedule was first built for; unmeasured on the
# GPU) and runs the bitplane loop on the HOST: each coding pass is its own
# jitted program with the plane index as a traced scalar argument (one
# compilation per pass type, reused for every plane and frame) and the
# coder state donated from call to call.

def _auto_chunk(n_blocks: int) -> int:
    """Codeblock-batch chunk size (0 = no chunking).

    Batches over 2048 codeblocks run as 1024-block chunks. The threshold
    was set on an earlier accelerator and is unmeasured on the GPU.
    Codeblocks are independent, so chunking changes peak live-buffer
    footprint and program shape, never bytes. PICSONG_CHUNK_BLOCKS
    overrides (0 disables)."""
    env = os.environ.get("PICSONG_CHUNK_BLOCKS", "")
    if env:
        try:
            return max(int(env), 0)
        except ValueError:
            return 0
    return 1024 if n_blocks > 2048 else 0


def _group_size(n_blocks: int | None = None,
                n_planes: int | None = None) -> int:
    """PICSONG_STAGED_GROUP=G (G > 1) codes G bitplanes per program.

    Each program is one nested fori_loop: outer over the G planes (the
    plane index, LUT slices and activity mask become traced per-iteration
    values), inner the paired SPP+MRP row scan. Cuts the per-plane
    dispatch count by G without chaining big-carry loops at the top level
    (rule 3: ONE outer loop owns the carry). Bytes identical to the split
    and paired schedules (gated in tests/test_engine.py); planes below 0
    in the final partial group are inactive no-ops.

    Default is ADAPTIVE (thresholds set on an earlier accelerator,
    unmeasured on the GPU):
      - large batches (>= 768 codeblocks, i.e. 2048^2+ and the 8K
        chunks): G=8.
      - small/medium batches: G = n_planes capped at 16, so ALL planes
        ride ONE grouped program per direction (fewest dispatches).
        n_planes is quantized to multiples of 4 (planes_for_magnitude),
        so this adds at most a handful of executables."""
    env = os.environ.get("PICSONG_STAGED_GROUP", "")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            return 1
    # >= 768 rather than 1024: the video engine's chunked batches end in
    # a near-1024 tail chunk (e.g. 1008 blocks at 1080p batch 8), which
    # belongs with the large regime — and must not mint its own
    # G=n_planes executable
    if (n_blocks or 0) >= 768:
        return 8
    if n_planes:
        return min(n_planes, 16)
    return 4


def _fused_dir_enabled() -> bool:
    """PICSONG_STAGED_FUSED=1 fuses init + all-plane loop + finish into
    ONE program per direction when a single grouped program covers every
    plane (StagedBPC._fused_dir_ok). Bytes identical (gated in
    tests/test_engine.py). Default on; the choice was made on an
    earlier accelerator and is unmeasured on the GPU. The fused program
    keeps the (66,33,N) carry inside one program across
    init -> plane loop -> finish instead of passing it between programs
    at each boundary. The multi-level DWT stays in its own programs.
    Set =0 for the split endpoints."""
    return os.environ.get("PICSONG_STAGED_FUSED", "1") == "1"


def _pair_enabled() -> bool:
    """PICSONG_STAGED_PAIR=1 (default) runs SPP+MRP as one program per
    plane.

    Byte-identical to the split schedule (gated in tests/test_engine.py);
    halves dispatches. Default on; unmeasured on the GPU. Set =0 to fall
    back to the split schedule."""
    return os.environ.get("PICSONG_STAGED_PAIR", "1") == "1"


class StagedBPC:
    """Host-sequenced per-pass BPC engine for one configuration."""

    def __init__(self, params: LUTParams, wavelet_levels: int,
                 coding_passes: int = 2, has_k: bool = False):
        self.params = params
        self.wavelet_levels = wavelet_levels
        self.coding_passes = coding_passes
        self.has_k = has_k
        prec = params.mult_precision
        donate = tuple(range(7))

        def spp(encode, three_cp):
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     sig_grid0, sign_grid0, lut, plane):
                in_range = plane <= msb
                if three_cp:
                    act = in_range & (plane < msb)
                else:
                    act = in_range & (plane >= consec)
                sig9 = lut[jnp.clip(sig_grid0 + plane * 9, 0, lut.shape[0] - 1)]
                sign4 = lut[jnp.clip(sign_grid0 + plane * 4, 0, lut.shape[0] - 1)]
                ac = (low, size, resv, counter, out)
                te2, to2, ac = _spp_pass((te, to, ac), plane, act, sig9, sign4,
                                         prec, encode, three_cp)
                return (te2, to2) + ac
            return jax.jit(impl, donate_argnums=donate)

        def mrp(encode, three_cp):
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     ref_b, lut, plane):
                in_range = plane <= msb
                if three_cp:
                    act = in_range & (plane < msb)
                else:
                    act = in_range & (plane >= consec)
                ref1 = lut[jnp.clip(ref_b + plane, 0, lut.shape[0] - 1)]
                ac = (low, size, resv, counter, out)
                te2, to2, ac = _mrp_pass((te, to, ac), plane, act, ref1, prec,
                                         encode)
                return (te2, to2) + ac
            return jax.jit(impl, donate_argnums=donate)

        def pair(encode):
            """SPP+MRP for one plane in ONE program (cp == 2, k == 0).

            Halves the per-plane dispatch count in the small-image
            (dispatch-bound) regime; bytes identical to the split
            schedule. Selected via PICSONG_STAGED_PAIR (see encode())."""
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     sig_grid0, sign_grid0, ref_b, lut, plane):
                act = (plane <= msb) & (plane >= consec)
                sig9 = lut[jnp.clip(sig_grid0 + plane * 9, 0, lut.shape[0] - 1)]
                sign4 = lut[jnp.clip(sign_grid0 + plane * 4, 0, lut.shape[0] - 1)]
                ref1 = lut[jnp.clip(ref_b + plane, 0, lut.shape[0] - 1)]
                ac = (low, size, resv, counter, out)
                te2, to2, ac = _spp_mrp_pass((te, to, ac), plane, act, sig9,
                                             sign4, ref1, prec, encode)
                return (te2, to2) + ac
            return jax.jit(impl, donate_argnums=donate)

        def cp3(encode):
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     cp_sig_grid0, cp_sign_grid0, lut, plane):
                act = plane <= msb
                sig9 = lut[jnp.clip(cp_sig_grid0 + plane * 9, 0,
                                    lut.shape[0] - 1)]
                sign4 = lut[jnp.clip(cp_sign_grid0 + plane * 4, 0,
                                     lut.shape[0] - 1)]
                ac = (low, size, resv, counter, out)
                te2, to2, ac = _cp_pass((te, to, ac), plane, act, sig9, sign4,
                                        prec, encode)
                return (te2, to2) + ac
            return jax.jit(impl, donate_argnums=donate)

        def pair_group(encode, G):
            """G bitplanes (SPP+MRP each) in ONE program (cp == 2).

            Outer fori_loop over the group's planes; the plane index is a
            traced scalar, so one executable serves every plane group.
            See _group_size()."""
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     sig_grid0, sign_grid0, ref_b, lut, plane0):

                lutmax = lut.shape[0] - 1

                def body(gi, st):
                    plane = plane0 - gi
                    act = ((plane <= msb) & (plane >= consec)
                           & (plane >= 0))
                    sig9 = lut[jnp.clip(sig_grid0 + plane * 9, 0, lutmax)]
                    sign4 = lut[jnp.clip(sign_grid0 + plane * 4, 0, lutmax)]
                    ref1 = lut[jnp.clip(ref_b + plane, 0, lutmax)]
                    te_, to_, ac_ = st
                    te_, to_, ac_ = _spp_mrp_pass((te_, to_, ac_), plane,
                                                  act, sig9, sign4, ref1,
                                                  prec, encode)
                    return te_, to_, ac_

                ac = (low, size, resv, counter, out)
                te2, to2, ac = jax.lax.fori_loop(0, G, body, (te, to, ac))
                return (te2, to2) + ac
            return jax.jit(impl, donate_argnums=donate)

        def cp3_group(encode, G):
            """G bitplanes (SPP+MRP+CP each) in ONE program (cp == 3).

            The cp=3 analogue of pair_group: outer fori_loop over the
            group's planes, inner the fused 3-pass row scan
            (_spp_mrp_cp_pass). Cuts the split schedule's 3 dispatches
            per plane to 1/G program call per plane."""
            def impl(te, to, low, size, resv, counter, out, msb,
                     sig_grid0, sign_grid0, ref_b, cp_sig_grid0,
                     cp_sign_grid0, lut, plane0):

                lutmax = lut.shape[0] - 1

                def body(gi, st):
                    plane = plane0 - gi
                    spp_act = (plane < msb) & (plane >= 0)
                    cp_act = (plane <= msb) & (plane >= 0)
                    sig9 = lut[jnp.clip(sig_grid0 + plane * 9, 0, lutmax)]
                    sign4 = lut[jnp.clip(sign_grid0 + plane * 4, 0, lutmax)]
                    ref1 = lut[jnp.clip(ref_b + plane, 0, lutmax)]
                    cpsig9 = lut[jnp.clip(cp_sig_grid0 + plane * 9, 0,
                                          lutmax)]
                    cpsign4 = lut[jnp.clip(cp_sign_grid0 + plane * 4, 0,
                                           lutmax)]
                    te_, to_, ac_ = st
                    return _spp_mrp_cp_pass((te_, to_, ac_), plane, spp_act,
                                            cp_act, sig9, sign4, ref1,
                                            cpsig9, cpsign4, prec, encode)

                ac = (low, size, resv, counter, out)
                te2, to2, ac = jax.lax.fori_loop(0, G, body, (te, to, ac))
                return (te2, to2) + ac
            return jax.jit(impl, donate_argnums=donate)

        self._pair_group = pair_group
        self._cp3_group = cp3_group
        self._group_progs: dict = {}
        self._cp3_progs: dict = {}
        self._bulk_progs: dict = {}
        self._fused_dir_progs: dict = {}

        three = coding_passes == 3
        self._spp_enc = spp(True, three)
        self._spp_dec = spp(False, three)
        self._mrp_enc = mrp(True, three)
        self._mrp_dec = mrp(False, three)
        if three:
            self._cp_enc = cp3(True)
            self._cp_dec = cp3(False)
        else:
            self._pair_enc = pair(True)
            self._pair_dec = pair(False)

        self._init_enc = jax.jit(self._init_enc_impl)
        # chunked-path inits: the chunk slice happens INSIDE the init
        # program (dynamic_slice, static chunk size) instead of as a
        # separate host-dispatched slice per chunk per call — one less
        # dispatch and one less full-chunk buffer copy per chunk (the
        # decoder previously paid slice + init passthrough = 2x its
        # 16.8 MB chunk)
        self._init_enc_at = jax.jit(
            lambda blocks, start, size, *meta: self._init_enc_impl(
                jax.lax.dynamic_slice_in_dim(blocks, start, size, 0),
                *meta),
            static_argnums=(2,))
        self._init_dec_at = jax.jit(
            lambda streams, sizes, start, size, *meta: self._init_dec_impl(
                jax.lax.dynamic_slice_in_dim(streams, start, size, 0),
                jax.lax.dynamic_slice_in_dim(sizes, start, size, 0),
                *meta),
            static_argnums=(3,))
        # Donate ONLY what can actually alias an output (counter -> sizes,
        # out -> out). Donating the whole carry here raised "donated
        # buffers were not usable" for te/to/low/resv on every run — noise,
        # not a forced copy (an unusable donation allocates the output
        # fresh exactly like no donation). Keeping the donate list exact makes any REAL
        # aliasing failure in the hot per-pass programs visible again.
        self._finish_enc = jax.jit(self._finish_enc_impl,
                                   donate_argnums=(5, 6))
        self._finish_enc_packed = jax.jit(self._finish_enc_packed_impl,
                                          static_argnums=(9,))
        self._init_dec = jax.jit(self._init_dec_impl)
        # no finish-decode output matches te/to in shape+dtype; nothing
        # can alias, so donation would only warn
        self._finish_dec = jax.jit(self._finish_dec_impl)
        self.unpack_dense = jax.jit(self._unpack_dense_impl)
        self._pack_dense = jax.jit(self._pack_dense_impl,
                                   static_argnums=(2,))

    # -- loopless endpoint programs ---------------------------------------

    def _init_enc_impl(self, blocks, ref_base, sig_base, sign_base,
                       cp_sig_base, cp_sign_base, k_over_l2):
        n = blocks.shape[0]
        stride = self.params.stride_per_group(self.wavelet_levels)
        mag = jnp.abs(blocks).astype(_U)
        sign = (blocks < 0).astype(_U)
        words = (mag << 1) | sign
        if self.coding_passes == 3:
            words = words | _CP_BIT
        msb_or = _or_reduce_rows((words >> 1).reshape(n, -1))
        if self.coding_passes == 3:
            msb_or = msb_or & ~_REF_BIT
        msb = 31 - jax.lax.clz(msb_or).astype(jnp.int32)
        empty = msb_or == 0
        if self.has_k and self.coding_passes == 2:
            consec = jnp.maximum(
                jnp.floor(msb.astype(jnp.float32) * k_over_l2), 0
            ).astype(jnp.int32)
            s_off = jnp.minimum(consec, jnp.maximum(msb, 0)) * stride
        else:
            consec = jnp.zeros(n, jnp.int32)
            s_off = jnp.zeros(n, jnp.int32)
        i9 = jnp.arange(9, dtype=jnp.int32)[:, None]
        i4 = jnp.arange(4, dtype=jnp.int32)[:, None]
        grids = dict(
            ref_b=ref_base + s_off,
            sig_grid0=(sig_base + s_off)[None, :] + i9,
            sign_grid0=(sign_base + s_off)[None, :] + i4,
            cp_sig_grid0=cp_sig_base[None, :] + i9,
            cp_sign_grid0=cp_sign_base[None, :] + i4,
        )
        te, to = _to_grids(words)
        out = jnp.full((n, spec.CBLOCK_SIZE), -1, jnp.int32)
        z = jnp.zeros((_LANES, n), jnp.int32)
        state = (te, to, z, z, z, jnp.zeros(n, jnp.int32), out)
        return state, msb, consec, empty, grids

    def _finish_enc_impl(self, te, to, low, size, resv, counter, out,
                         msb, empty):
        out = _row_scatter(out, resv, low)
        out = out.at[:, 0].set(jnp.where(empty, 32, msb))
        sizes = jnp.where(empty, 1, counter + 1)
        raw = _raw_layout(_from_grids(te, to))
        expand = (sizes == spec.CBLOCK_SIZE)[:, None]
        out = jnp.where(expand, raw, out)
        return out, sizes

    def _finish_enc_packed_impl(self, te, to, low, size, resv, counter, out,
                                msb, empty, bucket: int):
        """Finish + device-side dense pack (BitStreamBuilder on device).

        The reference packs with CUB prefix sum + binary-search kernels
        (BitStreamBuilder.cu:106-137,290-323); here the same relocation is
        one cumsum + one flat gather. Packing BEFORE download shrinks the
        device-to-host copy: the dense payload is ~the compressed size, vs
        the (N, 4096) buffer's fixed 8 KB/codeblock — a 3-10x smaller D2H
        transfer. `bucket` is a static payload capacity; overflow (total
        payload > bucket) is detected host-side from `sizes` and falls back
        to downloading the full streams buffer, which is also returned.
        """
        out, sizes = self._finish_enc_impl(te, to, low, size, resv, counter,
                                           out, msb, empty)
        n = out.shape[0]
        counts = sizes - 1
        offs = jnp.cumsum(counts) - counts
        src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), counts,
                         total_repeat_length=bucket)
        within = jnp.arange(bucket, dtype=jnp.int32) - offs[src] + 1
        flat = out.reshape(-1)
        idx = jnp.clip(src * spec.CBLOCK_SIZE + within, 0, flat.shape[0] - 1)
        dense = flat[idx].astype(jnp.uint16)
        # the full (N, 4096) buffer is NOT returned: freeing it right after
        # the program keeps the defer window's HBM footprint at ~the
        # compressed size; a bucket overflow re-encodes with a larger bucket
        return sizes, out[:, 0], dense

    def _enc_plane_calls(self, state, msb, consec, g, lut, p, paired: bool):
        if self.coding_passes == 3:
            state = self._spp_enc(*state, msb, consec, g["sig_grid0"],
                                  g["sign_grid0"], lut, p)
            state = self._mrp_enc(*state, msb, consec, g["ref_b"], lut, p)
            state = self._cp_enc(*state, msb, consec, g["cp_sig_grid0"],
                                 g["cp_sign_grid0"], lut, p)
        elif paired:
            state = self._pair_enc(*state, msb, consec, g["sig_grid0"],
                                   g["sign_grid0"], g["ref_b"], lut, p)
        else:
            state = self._spp_enc(*state, msb, consec, g["sig_grid0"],
                                  g["sign_grid0"], lut, p)
            state = self._mrp_enc(*state, msb, consec, g["ref_b"], lut, p)
        return state

    def _grouped_prog(self, encode: bool, G: int):
        key = (encode, G)
        if key not in self._group_progs:
            self._group_progs[key] = self._pair_group(encode, G)
        return self._group_progs[key]

    # -- fused whole-direction programs ------------------------------------

    def _fused_dir_prog(self, encode: bool, G: int, at: bool):
        """init + all-planes grouped loop + finish as ONE program.

        Applicable when one grouped program covers every plane
        (G = n_planes, cp=2 or cp=3, k=0): fusing the loopless endpoints into it
        keeps exactly ONE big-carry fori_loop per program (rule 3) while
        cutting a direction from 3 programs to 1. The multi-level DWT and
        tiling programs stay separate. `at` variants take
        (full_array, start) and slice inside (the chunked path).
        Selected via PICSONG_STAGED_FUSED (see _fused_dir_enabled)."""
        key = (encode, G, at)
        if key in self._fused_dir_progs:
            return self._fused_dir_progs[key]
        prec = self.params.mult_precision

        three = self.coding_passes == 3

        def loop(state, msb, consec, g, lut, plane0):
            te, to = state[0], state[1]
            ac = state[2:]
            lutmax = lut.shape[0] - 1
            sig_grid0, sign_grid0, ref_b = (g["sig_grid0"],
                                            g["sign_grid0"], g["ref_b"])

            def body(gi, st):
                plane = plane0 - gi
                sig9 = lut[jnp.clip(sig_grid0 + plane * 9, 0, lutmax)]
                sign4 = lut[jnp.clip(sign_grid0 + plane * 4, 0, lutmax)]
                ref1 = lut[jnp.clip(ref_b + plane, 0, lutmax)]
                te_, to_, ac_ = st
                if three:
                    spp_act = (plane < msb) & (plane >= 0)
                    cp_act = (plane <= msb) & (plane >= 0)
                    cpsig9 = lut[jnp.clip(g["cp_sig_grid0"] + plane * 9,
                                          0, lutmax)]
                    cpsign4 = lut[jnp.clip(g["cp_sign_grid0"] + plane * 4,
                                           0, lutmax)]
                    return _spp_mrp_cp_pass((te_, to_, ac_), plane, spp_act,
                                            cp_act, sig9, sign4, ref1,
                                            cpsig9, cpsign4, prec, encode)
                act = ((plane <= msb) & (plane >= consec) & (plane >= 0))
                return _spp_mrp_pass((te_, to_, ac_), plane, act, sig9,
                                     sign4, ref1, prec, encode)

            te2, to2, ac2 = jax.lax.fori_loop(0, G, body, (te, to, ac))
            return te2, to2, ac2

        bulk_k = self.has_k and self.coding_passes == 2

        def bulk(te, to, ac, msb, consec, empty, g, lut):
            """The -k bulk pass, fused after the plane loop (PICSONG_FUSED_K).

            A SECOND top-level loop in the same program — the one deliberate
            exception to rule 3 (the rule's evidence came from the mono
            coder's many-loop chains)."""
            entry = jnp.minimum(consec, jnp.maximum(msb, 0)) - 1
            entry = jnp.where(consec > msb, msb, entry)
            act = entry >= 0
            if empty is not None:
                act = act & ~empty
            return _bulk_pass((te, to, ac), jnp.maximum(entry, 0), act,
                              (g["ref_b"], g["sig_grid0"], g["sign_grid0"]),
                              lut, prec, G, encode)

        if encode:
            def core(blocks, meta, lut, plane0):
                state, msb, consec, empty, g = self._init_enc_impl(
                    blocks, *meta)
                te2, to2, ac2 = loop(state, msb, consec, g, lut, plane0)
                if bulk_k:
                    te2, to2, ac2 = bulk(te2, to2, ac2, msb, consec, empty,
                                         g, lut)
                return self._finish_enc_impl(te2, to2, *ac2, msb, empty)

            if at:
                def impl(blocks, start, size, ref_base, sig_base,
                         sign_base, cp_sig_base, cp_sign_base, k_over_l2,
                         lut, plane0):
                    chunk = jax.lax.dynamic_slice_in_dim(blocks, start,
                                                         size, 0)
                    return core(chunk, (ref_base, sig_base, sign_base,
                                        cp_sig_base, cp_sign_base,
                                        k_over_l2), lut, plane0)
                prog = jax.jit(impl, static_argnums=(2,))
            else:
                def impl(blocks, ref_base, sig_base, sign_base,
                         cp_sig_base, cp_sign_base, k_over_l2, lut,
                         plane0):
                    return core(blocks, (ref_base, sig_base, sign_base,
                                         cp_sig_base, cp_sign_base,
                                         k_over_l2), lut, plane0)
                prog = jax.jit(impl)
        else:
            def core(streams, sizes, meta, lut, plane0):
                state, msb, consec, is_raw, g = self._init_dec_impl(
                    streams, sizes, *meta)
                te2, to2, ac2 = loop(state, msb, consec, g, lut, plane0)
                if bulk_k:
                    te2, to2, ac2 = bulk(te2, to2, ac2, msb, consec, None,
                                         g, lut)
                return self._finish_dec_impl(te2, to2, ac2[4], is_raw)

            if at:
                def impl(streams, sizes, start, size, ref_base, sig_base,
                         sign_base, cp_sig_base, cp_sign_base, k_over_l2,
                         lut, plane0):
                    s = jax.lax.dynamic_slice_in_dim(streams, start,
                                                     size, 0)
                    z = jax.lax.dynamic_slice_in_dim(sizes, start, size, 0)
                    return core(s, z, (ref_base, sig_base, sign_base,
                                       cp_sig_base, cp_sign_base,
                                       k_over_l2), lut, plane0)
                prog = jax.jit(impl, static_argnums=(3,))
            else:
                def impl(streams, sizes, ref_base, sig_base, sign_base,
                         cp_sig_base, cp_sign_base, k_over_l2, lut,
                         plane0):
                    return core(streams, sizes,
                                (ref_base, sig_base, sign_base,
                                 cp_sig_base, cp_sign_base, k_over_l2),
                                lut, plane0)
                prog = jax.jit(impl)
        self._fused_dir_progs[key] = prog
        return prog

    def _fused_dir_ok(self, n_blocks: int, n_planes: int) -> bool:
        """Whole-direction fusion applies when one program can cover every
        plane (cp=2 or cp=3, k=0, paired schedule): the fused program loops
        all n_planes, so the adaptive split-schedule G (which balanced
        per-program carry streaming against dispatch count) is irrelevant
        here — there is exactly ONE program per direction either way.
        Capped at PICSONG_FUSED_MAXPLANES (default 16, the same quantized
        cap as _group_size) so pathological plane counts (deep lossy
        16-bit content) keep the split schedule; 9..16-plane large
        batches — i.e. the 16-plane lossy 2048^2/8K-chunk regime — fuse
        too."""
        if not _fused_dir_enabled():
            return False
        if not _pair_enabled():
            return False
        if self.has_k and not (self.coding_passes == 2
                               and os.environ.get("PICSONG_FUSED_K",
                                                  "1") == "1"):
            # k > 0 fusion appends the bulk pass as a SECOND top-level
            # loop in the fused program — the one exception to rule 3.
            # PICSONG_FUSED_K=0 restores the split bulk schedule.
            return False
        env = os.environ.get("PICSONG_FUSED_MAXPLANES", "")
        try:
            cap = int(env) if env else 16
        except ValueError:
            cap = 16
        return n_planes <= cap

    def _cp3_grouped_prog(self, encode: bool, G: int):
        key = (encode, G)
        if key not in self._cp3_progs:
            self._cp3_progs[key] = self._cp3_group(encode, G)
        return self._cp3_progs[key]

    def _bulk_prog(self, encode: bool, n_planes: int):
        """Staged bulk multi-bitplane program (complexity scalability).

        ONE jitted program (the only big-carry loop it contains) running
        the fused low-plane pass for every codeblock after the normal
        per-plane passes — the staged equivalent of encodeBulkMode /
        decodeBulkMode (BPCEngine.cu:1285-1662), in place of the
        monolithic coder's k > 0 path. Entry planes and activity derive on device from
        msb/consec exactly as in encode_blocks/decode_blocks, so bytes
        stay oracle-exact (gated in tests/test_jax_bpc.py)."""
        key = (encode, n_planes)
        if key in self._bulk_progs:
            return self._bulk_progs[key]
        prec = self.params.mult_precision
        donate = tuple(range(7))
        if encode:
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     empty, ref_b, sig_grid0, sign_grid0, lut):
                entry = jnp.minimum(consec, jnp.maximum(msb, 0)) - 1
                entry = jnp.where(consec > msb, msb, entry)
                act = (entry >= 0) & ~empty
                ac = (low, size, resv, counter, out)
                te2, to2, ac = _bulk_pass(
                    (te, to, ac), jnp.maximum(entry, 0), act,
                    (ref_b, sig_grid0, sign_grid0), lut, prec, n_planes,
                    True)
                return (te2, to2) + ac
        else:
            def impl(te, to, low, size, resv, counter, out, msb, consec,
                     ref_b, sig_grid0, sign_grid0, lut):
                entry = jnp.minimum(consec, jnp.maximum(msb, 0)) - 1
                entry = jnp.where(consec > msb, msb, entry)
                act = entry >= 0
                ac = (low, size, resv, counter, out)
                te2, to2, ac = _bulk_pass(
                    (te, to, ac), jnp.maximum(entry, 0), act,
                    (ref_b, sig_grid0, sign_grid0), lut, prec, n_planes,
                    False)
                return (te2, to2) + ac
        prog = jax.jit(impl, donate_argnums=donate)
        self._bulk_progs[key] = prog
        return prog

    def _run_planes(self, state, msb, consec, g, lut, n_planes: int,
                    encode: bool):
        """Dispatch all bitplane passes (split / paired / plane-grouped)."""
        paired = _pair_enabled()
        if self.coding_passes == 3 and paired:
            # same adaptive policy as cp=2: the grouped cp=3
            # program has the identical shape economics — G=8 for large
            # batches, one program per direction for small ones
            G = _group_size(state[0].shape[-1], n_planes)
            prog = self._cp3_grouped_prog(encode, G)
            for p0 in range(n_planes - 1, -1, -G):
                state = prog(*state, msb, g["sig_grid0"], g["sign_grid0"],
                             g["ref_b"], g["cp_sig_grid0"],
                             g["cp_sign_grid0"], lut, p0)
            return state
        paired = paired and self.coding_passes == 2
        G = _group_size(state[0].shape[-1], n_planes) if paired else 1
        if G > 1:
            prog = self._grouped_prog(encode, G)
            for p0 in range(n_planes - 1, -1, -G):
                state = prog(*state, msb, consec, g["sig_grid0"],
                             g["sign_grid0"], g["ref_b"], lut, p0)
            return state
        calls = self._enc_plane_calls if encode else self._dec_plane_calls
        for p in range(n_planes - 1, -1, -1):
            state = calls(state, msb, consec, g, lut, p, paired)
        return state

    def encode_packed(self, blocks, lut, meta, n_planes: int, bucket: int,
                      chunk: int | None = None, meta_chunks=None):
        """Encode + device pack: (sizes, msb_words, dense_payload)."""
        spans = self._spans(blocks.shape[0], chunk)
        if spans:
            # chunked loop programs + one full-batch pack gather (the pack
            # is a single flat gather, not a loop program; see _auto_chunk)
            streams, sizes = self.encode(blocks, lut, meta, n_planes,
                                         chunk=chunk,
                                         meta_chunks=meta_chunks)
            return self._pack_dense(streams, sizes, bucket)
        state, msb, consec, empty, g = self._init_enc(blocks, *meta)
        state = self._run_planes(state, msb, consec, g, lut, n_planes, True)
        if self.has_k and self.coding_passes == 2:
            state = self._bulk_prog(True, n_planes)(
                *state, msb, consec, empty, g["ref_b"], g["sig_grid0"],
                g["sign_grid0"], lut)
        return self._finish_enc_packed(*state, msb, empty, bucket)

    @staticmethod
    @jax.jit
    def fuse_packed(sizes, msb_words, dense):
        """Fuse a packed encode's three outputs into ONE uint16 buffer.

        Layout: [sizes (N)] [msb words (N)] [dense payload (bucket)].
        Both sizes (<= 4096) and MSB words (<= 32) fit uint16. One fused
        buffer means ONE device->host read per component per batch instead
        of three."""
        return jnp.concatenate([sizes.astype(jnp.uint16),
                                msb_words.astype(jnp.uint16),
                                dense])

    @staticmethod
    def split_packed(fused: np.ndarray, n: int):
        """Host-side inverse of fuse_packed: (sizes, msb_words, dense)."""
        z = fused[:n].astype(np.int64)
        m = fused[n:2 * n].astype(np.int32)
        return z, m, fused[2 * n:]

    def _pack_dense_impl(self, streams, sizes, bucket: int):
        """Dense pack of already-finished (N, 4096) streams (the tail of
        _finish_enc_packed_impl, for the chunked-encode path)."""
        n = streams.shape[0]
        counts = sizes - 1
        offs = jnp.cumsum(counts) - counts
        src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), counts,
                         total_repeat_length=bucket)
        within = jnp.arange(bucket, dtype=jnp.int32) - offs[src] + 1
        flat = streams.reshape(-1)
        idx = jnp.clip(src * spec.CBLOCK_SIZE + within, 0, flat.shape[0] - 1)
        dense = flat[idx].astype(jnp.uint16)
        return sizes, streams[:, 0], dense

    def _unpack_dense_impl(self, dense, sizes, msb_words):
        """Device-side inverse of the dense pack: the decode half of the
        reference's BitStreamBuilder (buildCodeStreamLUTBS scatter,
        BitStreamBuilder.cu:142-171) as one gather. dense (bucket,) uint16
        payload + per-block sizes + MSB words -> (N, 4096) int32 streams
        with -1 fill, bit-identical to the host unpack_streams layout."""
        counts = sizes - 1
        offs = jnp.cumsum(counts) - counts
        j = jnp.arange(spec.CBLOCK_SIZE - 1, dtype=jnp.int32)[None, :]
        idx = jnp.clip(offs[:, None] + j, 0, dense.shape[0] - 1)
        body = jnp.where(j < counts[:, None], dense[idx].astype(jnp.int32),
                         np.int32(-1))
        return jnp.concatenate(
            [msb_words[:, None].astype(jnp.int32), body], axis=1)

    def _init_dec_impl(self, streams, sizes, ref_base, sig_base, sign_base,
                       cp_sig_base, cp_sign_base, k_over_l2):
        n = streams.shape[0]
        stride = self.params.stride_per_group(self.wavelet_levels)
        msb_word = streams[:, 0]
        is_raw = sizes == spec.CBLOCK_SIZE
        skip = (msb_word == 32) | is_raw
        msb = jnp.where(skip, -1, msb_word)
        if self.has_k and self.coding_passes == 2:
            consec = jnp.maximum(
                jnp.floor(msb.astype(jnp.float32) * k_over_l2), 0
            ).astype(jnp.int32)
            s_off = jnp.minimum(consec, jnp.maximum(msb, 0)) * stride
        else:
            consec = jnp.zeros(n, jnp.int32)
            s_off = jnp.zeros(n, jnp.int32)
        i9 = jnp.arange(9, dtype=jnp.int32)[:, None]
        i4 = jnp.arange(4, dtype=jnp.int32)[:, None]
        grids = dict(
            ref_b=ref_base + s_off,
            sig_grid0=(sig_base + s_off)[None, :] + i9,
            sign_grid0=(sign_base + s_off)[None, :] + i4,
            cp_sig_grid0=cp_sig_base[None, :] + i9,
            cp_sign_grid0=cp_sign_base[None, :] + i4,
        )
        init = jnp.zeros((n, _ROWS, _ROWS), _U)
        if self.coding_passes == 3:
            init = init | _CP_BIT
        te, to = _to_grids(init)
        z = jnp.zeros((_LANES, n), jnp.int32)
        state = (te, to, z, z, z, jnp.zeros(n, jnp.int32), streams)
        return state, msb, consec, is_raw, grids

    def _finish_dec_impl(self, te, to, streams, is_raw):
        words = _from_grids(te, to)
        words = jnp.where(is_raw[:, None, None], _raw_unlayout(streams), words)
        out = ((words & spec.MAGNITUDE_MASK) >> 1).astype(jnp.int32)
        return jnp.where((words & 1) == 1, -out, out)

    # -- host-sequenced drivers -------------------------------------------

    def _dec_plane_calls(self, state, msb, consec, g, lut, p, paired: bool):
        if self.coding_passes == 3:
            state = self._spp_dec(*state, msb, consec, g["sig_grid0"],
                                  g["sign_grid0"], lut, p)
            state = self._mrp_dec(*state, msb, consec, g["ref_b"], lut, p)
            state = self._cp_dec(*state, msb, consec, g["cp_sig_grid0"],
                                 g["cp_sign_grid0"], lut, p)
        elif paired:
            state = self._pair_dec(*state, msb, consec, g["sig_grid0"],
                                   g["sign_grid0"], g["ref_b"], lut, p)
        else:
            state = self._spp_dec(*state, msb, consec, g["sig_grid0"],
                                  g["sign_grid0"], lut, p)
            state = self._mrp_dec(*state, msb, consec, g["ref_b"], lut, p)
        return state

    @staticmethod
    def _spans(n: int, chunk: int | None):
        c = _auto_chunk(n) if chunk is None else chunk
        if not c or n <= c:
            return None
        return [(s, min(s + c, n)) for s in range(0, n, c)]

    def _encode_tail(self, init_out, lut, n_planes: int):
        """Shared pass-schedule + finish after either init variant."""
        state, msb, consec, empty, g = init_out
        state = self._run_planes(state, msb, consec, g, lut, n_planes, True)
        if self.has_k and self.coding_passes == 2:
            state = self._bulk_prog(True, n_planes)(
                *state, msb, consec, empty, g["ref_b"], g["sig_grid0"],
                g["sign_grid0"], lut)
        return self._finish_enc(*state, msb, empty)

    def encode(self, blocks, lut, meta, n_planes: int,
               chunk: int | None = None, meta_chunks=None):
        """blocks (N, 64, 64) int32 (device or host) -> (streams, sizes).

        chunk=None auto-splits very large codeblock batches (_auto_chunk);
        pass an int to force a chunk size (0 disables). meta_chunks: an
        optional pre-split list of per-chunk meta tuples (one per span) —
        callers with long-lived geometry (TPUCodec) pass it so the six
        metadata slices are not re-dispatched per chunk per call
        (~6 x n_chunks dispatches saved)."""
        spans = self._spans(blocks.shape[0], chunk)
        if spans:
            blocks = jnp.asarray(blocks, jnp.int32)
            chunk_meta = (meta_chunks if meta_chunks is not None
                          else [tuple(m[s:e] for m in meta)
                                for s, e in spans])
            if self._fused_dir_ok(spans[0][1] - spans[0][0], n_planes):
                prog = self._fused_dir_prog(True, n_planes, True)
                outs = [prog(blocks, s, e - s, *chunk_meta[i], lut,
                             n_planes - 1)
                        for i, (s, e) in enumerate(spans)]
            else:
                outs = [self._encode_tail(
                            self._init_enc_at(blocks, s, e - s,
                                              *chunk_meta[i]),
                            lut, n_planes)
                        for i, (s, e) in enumerate(spans)]
            return (jnp.concatenate([o[0] for o in outs]),
                    jnp.concatenate([o[1] for o in outs]))
        if self._fused_dir_ok(blocks.shape[0], n_planes):
            return self._fused_dir_prog(True, n_planes, False)(
                jnp.asarray(blocks, jnp.int32), *meta, lut, n_planes - 1)
        return self._encode_tail(self._init_enc(blocks, *meta), lut,
                                 n_planes)

    def _decode_tail(self, init_out, lut, n_planes: int):
        """Pass schedule + finish; the codestream words come from the
        carry's threaded streams buffer (state[6], returned unchanged by
        every pass program), so no caller-side slice has to stay alive."""
        state, msb, consec, is_raw, g = init_out
        state = self._run_planes(state, msb, consec, g, lut, n_planes,
                                 False)
        if self.has_k and self.coding_passes == 2:
            state = self._bulk_prog(False, n_planes)(
                *state, msb, consec, g["ref_b"], g["sig_grid0"],
                g["sign_grid0"], lut)
        return self._finish_dec(state[0], state[1], state[6], is_raw)

    def decode(self, streams, sizes, lut, meta, n_planes: int,
               chunk: int | None = None, meta_chunks=None):
        spans = self._spans(streams.shape[0], chunk)
        if spans:
            streams = jnp.asarray(streams, jnp.int32)
            sizes = jnp.asarray(sizes, jnp.int32)
            chunk_meta = (meta_chunks if meta_chunks is not None
                          else [tuple(m[s:e] for m in meta)
                                for s, e in spans])
            if self._fused_dir_ok(spans[0][1] - spans[0][0], n_planes):
                prog = self._fused_dir_prog(False, n_planes, True)
                return jnp.concatenate(
                    [prog(streams, sizes, s, e - s, *chunk_meta[i], lut,
                          n_planes - 1)
                     for i, (s, e) in enumerate(spans)])
            return jnp.concatenate(
                [self._decode_tail(
                     self._init_dec_at(streams, sizes, s, e - s,
                                       *chunk_meta[i]),
                     lut, n_planes)
                 for i, (s, e) in enumerate(spans)])
        if self._fused_dir_ok(streams.shape[0], n_planes):
            return self._fused_dir_prog(False, n_planes, False)(
                jnp.asarray(streams, jnp.int32),
                jnp.asarray(sizes, jnp.int32), *meta, lut, n_planes - 1)
        return self._decode_tail(
            self._init_dec(jnp.asarray(streams, jnp.int32),
                           jnp.asarray(sizes, jnp.int32), *meta),
            lut, n_planes)
