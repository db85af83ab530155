"""Stationary context-probability LUTs for BPC-PaCo.

The entropy coder is driven by per-(wavelet level, subband, bitplane,
context) probabilities with 7-bit precision, loaded from a LUT folder of
text files. This module parses the reference's on-disk LUT format
(IO/IOManager.ipp:363-386,404-612; Engines/Engine.cu:8-210) into dense
int32 arrays with the exact flat layout the coder kernels index
(BPC/BPCEngine.cu:329-358):

  per bitplane-group s:  [ ref | sig | sign (| cp_sig | cp_sign) ]
  each section:          [level][subband][bitplane][ctx]  (level-major)
                         + one trailing [bitplane][ctx] block for the
                           residual LL band (level == wavelet_levels)

Folder format:
  header.txt             KEY;VALUE lines (LUT_N_BITPLANES, LUT_N_SUBBANDS,
                         N_CONTEXT_REFINEMENT, N_CONTEXT_SIGN,
                         N_CONTEXT_SIGNIFICANCE, MULT_PRECISION,
                         LUT_N_FILES, AMOUNT_OF_BITPLANE_FILES)
  {ref,sig,sign}[R|G|B].txt_<s>   records "wLevel subband bitplane : p ..."
  cp_{sig,sign}[R|G|B].txt_<s>    (coding passes == 3 only)

Bitplanes absent from a file default to the neutral probability 64
(= 0.5 at 7-bit precision, IOManager.ipp:457,482,517).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np

NEUTRAL_PROBABILITY = 64


@dataclass(frozen=True)
class LUTParams:
    """LUT dimensions from header.txt plus derived section geometry."""

    n_bitplanes: int = 15
    n_subbands: int = 3
    ctx_refinement: int = 1
    ctx_sign: int = 4
    ctx_significance: int = 9
    mult_precision: int = 7
    n_files: int = 3                 # 1 = shared, 3 = per-channel R/G/B
    n_bitplane_files: int = 15       # bitplane-group files for CS (-k)

    def section_size(self, n_ctx: int, wavelet_levels: int) -> int:
        """Ints in one section: all (level, subband) groups + the LL block."""
        return (self.n_subbands * self.n_bitplanes * n_ctx * wavelet_levels
                + self.n_bitplanes * n_ctx)

    def size_per_group(self, wavelet_levels: int, coding_passes: int) -> int:
        """Ints per bitplane-group (_LUTPointerSizePerS, BPCEngine.cu:1959).

        Note: the device pointer stride is always the 3-section size; for
        coding_passes == 3 the host buffer appends cp_sig/cp_sign sections
        beyond it (Engine.cu:65-67) and the cleanup pass indexes past the
        sign section (BPCEngine.cu:1744-1748).
        """
        base = (self.section_size(self.ctx_refinement, wavelet_levels)
                + self.section_size(self.ctx_significance, wavelet_levels)
                + self.section_size(self.ctx_sign, wavelet_levels))
        if coding_passes == 3:
            base += (self.section_size(self.ctx_significance, wavelet_levels)
                     + self.section_size(self.ctx_sign, wavelet_levels))
        return base

    def stride_per_group(self, wavelet_levels: int) -> int:
        """The s-group stride used by device addressing (3 sections only)."""
        return (self.section_size(self.ctx_refinement, wavelet_levels)
                + self.section_size(self.ctx_significance, wavelet_levels)
                + self.section_size(self.ctx_sign, wavelet_levels))

    def section_offsets(self, wavelet_levels: int, coding_passes: int):
        """Start offsets of (ref, sig, sign[, cp_sig, cp_sign]) sections."""
        ref = 0
        sig = ref + self.section_size(self.ctx_refinement, wavelet_levels)
        sign = sig + self.section_size(self.ctx_significance, wavelet_levels)
        out = {"ref": ref, "sig": sig, "sign": sign}
        if coding_passes == 3:
            out["cp_sig"] = sign + self.section_size(self.ctx_sign, wavelet_levels)
            out["cp_sign"] = out["cp_sig"] + self.section_size(
                self.ctx_significance, wavelet_levels)
        return out


_HEADER_KEYS = {
    "LUT_N_BITPLANES": "n_bitplanes",
    "LUT_N_SUBBANDS": "n_subbands",
    "N_CONTEXT_REFINEMENT": "ctx_refinement",
    "N_CONTEXT_SIGN": "ctx_sign",
    "N_CONTEXT_SIGNIFICANCE": "ctx_significance",
    "MULT_PRECISION": "mult_precision",
    "LUT_N_FILES": "n_files",
    "AMOUNT_OF_BITPLANE_FILES": "n_bitplane_files",
}


def parse_lut_header(path: str) -> LUTParams:
    """Parse header.txt KEY;VALUE lines (IOManager.ipp:363-386).

    The bitplane-file count is capped at 32 (Engine.cu:204-208).
    """
    values = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ";" not in line:
                continue
            key, _, val = line.partition(";")
            if key in _HEADER_KEYS:
                values[_HEADER_KEYS[key]] = int(val)
    if values.get("n_bitplane_files", 0) > 32:
        values["n_bitplane_files"] = 32
    return LUTParams(**values)


_RECORD_RE = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s*:\s*(.*)$")


def _parse_section_file(path: str, params: LUTParams, wavelet_levels: int,
                        n_ctx: int) -> np.ndarray:
    """Parse one ref/sig/sign file into its dense section array.

    Groups are (level, subband) pairs in file order, ending with the
    residual-LL group (wavelet_levels, 0); reading stops once a record
    beyond that group appears (IOManager.ipp:460-461). Unlisted bitplanes
    keep the neutral probability.
    """
    n_groups = wavelet_levels * params.n_subbands + 1
    out = np.full((n_groups, params.n_bitplanes, n_ctx),
                  NEUTRAL_PROBABILITY, dtype=np.int32)
    if not os.path.exists(path):
        return out.reshape(-1)
    with open(path, "r") as f:
        for line in f:
            m = _RECORD_RE.match(line)
            if not m:
                continue
            level, subband, bitplane = int(m.group(1)), int(m.group(2)), int(m.group(3))
            if (level + 1) > wavelet_levels and subband > 0:
                break
            if level == wavelet_levels and subband == 0:
                group = wavelet_levels * params.n_subbands
            elif level < wavelet_levels and subband < params.n_subbands:
                group = level * params.n_subbands + subband
            else:
                continue
            if bitplane >= params.n_bitplanes:
                continue
            vals = [int(v) for v in m.group(4).split()][:n_ctx]
            out[group, bitplane, :len(vals)] = vals
    return out.reshape(-1)


_CHANNEL_SUFFIX = {0: ".txt_", 1: "R.txt_", 2: "G.txt_", 3: "B.txt_"}


def load_lut_channel(folder: str, params: LUTParams, wavelet_levels: int,
                     coding_passes: int, channel: int, s_index: int) -> np.ndarray:
    """Load one channel's LUT for one bitplane-group file index.

    `channel` follows the reference convention (IOManager.ipp:433-444):
    0 = shared (suffix ".txt_"), 1/2/3 = R/G/B.
    """
    suffix = _CHANNEL_SUFFIX[channel] + str(s_index)

    def section(stem: str, n_ctx: int) -> np.ndarray:
        return _parse_section_file(os.path.join(folder, stem + suffix),
                                   params, wavelet_levels, n_ctx)

    parts = [
        section("ref", params.ctx_refinement),
        section("sig", params.ctx_significance),
        section("sign", params.ctx_sign),
    ]
    if coding_passes == 3:
        parts.append(section("cp_sig", params.ctx_significance))
        parts.append(section("cp_sign", params.ctx_sign))
    return np.concatenate(parts)


def load_luts(folder: str, wavelet_levels: int, coding_passes: int,
              k_factor: float) -> tuple[list[np.ndarray], LUTParams]:
    """Load the full LUT set for a run (Engine::initLUT, Engine.cu:8-185).

    Returns one flat int32 array per channel. With k > 0 all bitplane-group
    files are loaded and concatenated (group-major); with k == 0 only the
    _0 file is used. LUT_N_FILES == 1 yields a single shared channel array.
    """
    params = parse_lut_header(os.path.join(folder, "header.txt"))
    n_groups = params.n_bitplane_files if k_factor > 0 else 1
    channels = [0] if params.n_files == 1 else [1, 2, 3]
    luts = []
    for ch in channels:
        groups = [
            load_lut_channel(folder, params, wavelet_levels, coding_passes, ch, j)
            for j in range(n_groups)
        ]
        luts.append(np.concatenate(groups))
    return luts, params


def neutral_lut(params: LUTParams, wavelet_levels: int, coding_passes: int,
                n_groups: int = 1) -> np.ndarray:
    """All-neutral LUT (p = 0.5): valid for coding, zero context modeling."""
    size = params.size_per_group(wavelet_levels, coding_passes)
    return np.full(size * n_groups, NEUTRAL_PROBABILITY, dtype=np.int32)


def group_base(params: LUTParams, wavelet_levels: int, level: int,
               subband: int, n_ctx: int) -> int:
    """Offset of a (level, subband) group within a section.

    Mirrors initializeLUTPointers (BPCEngine.cu:329-350): the residual LL
    (level == wavelet_levels, subband 0) lands on the trailing block.
    """
    return (level * params.n_subbands * params.n_bitplanes * n_ctx
            + subband * params.n_bitplanes * n_ctx)
