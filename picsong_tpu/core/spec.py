"""Codec constants and the codestream specification.

Every constant here is part of the on-disk format or of the coding math and
mirrors the reference implementation (file:line cites refer to
/root/reference/CUDA_ImCod):

- Codeblock geometry: 64 wide x 64 tall, one "warp" of 32 lanes owning two
  columns each (BPC/BPCEngine.cuh:27-36).
- Lifting constants for CDF 5/3 and 9/7 (DWT/DWTGenerator.cuh:13-22).
- Per-(level, subband) quantization gains (DWT/DWTGenerator.cuh:168-179,
  duplicated as L2Norm in BPC/BPCEngine.cuh:158-169 — kept once here).
- Color transform definitions (Engines/CodingEngine.cu:357-403,
  Engines/DecodingEngine.cu:599-650).
- Coefficient flag-bit layout used by the bitplane coder
  (BPC/BPCEngine.cu:41-137).
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Codeblock geometry (BPCEngine.cuh:27-36). Fixed by the codestream format.
# --------------------------------------------------------------------------
CBLOCK_WIDTH = 64
CBLOCK_LENGTH = 64
CBLOCK_SIZE = CBLOCK_WIDTH * CBLOCK_LENGTH  # 4096 codeword slots per block
LANES = 32                  # parallel column-pair coders per codeblock
COLS_PER_LANE = 2

# Arithmetic coder (BPCEngine.cuh:24, BPCEngine.cu:371-442)
CODEWORD_SIZE = 16          # bits per codeword
AC_INTERVAL_INIT = (1 << CODEWORD_SIZE) - 1
MAX_RESERVED_SLOT = 4094    # per-codeblock slot clamp (BPCEngine.cu:382)
MAX_SLOT_COUNT = 4095       # per-codeblock counter clamp (BPCEngine.cu:383)

# Coefficient flag bits (BPCEngine.cu:41-137).  A coefficient is stored as
# (|v| << 1) | sign  in bits 0..23, plus state flags:
BIT_SIGNIFICANT = 31        # became significant
BIT_CP_CANDIDATE = 30       # 3-coding-passes cleanup candidate
BIT_REFINEMENT = 29         # refinement-eligible (significant in a previous plane)
BITPLANE_SHIFT = 24         # bits 24..28 store the plane where it became significant
MAGNITUDE_MASK = 0xFFFFFF   # low 24 bits: (|v| << 1) | sign

# DWT overlap depths (DWTGenerator.cuh:28-29) — here these are halo
# widths for sharded lifting, not per-warp overlaps.
OVERLAP_LOSSLESS = 4
OVERLAP_LOSSY = 8

# --------------------------------------------------------------------------
# Lifting constants (DWTGenerator.cuh:13-22)
# --------------------------------------------------------------------------
I97_ALPHA = np.float32(-1.586134342059924)
I97_BETA = np.float32(-0.052980118572961)
I97_GAMMA = np.float32(0.882911075530934)
I97_DELTA = np.float32(0.443506852043971)
I97_K1 = np.float32(1.230174104914001)   # high-pass normalization
I97_K2 = np.float32(0.812893066)         # low-pass normalization

# --------------------------------------------------------------------------
# Quantization gains, rows = decomposition level 0..9, cols = [LL, HL, LH, HH]
# (DWTGenerator.cuh:168-179). The encoder multiplies a 9/7 coefficient by
# gain * qs before integer truncation; the decoder divides the midpoint
# reconstruction (|q| + 0.5) by gain * qs (DWTGenerator.cu:403-433,513-542).
# --------------------------------------------------------------------------
WAVELET_QSTEPS = np.array(
    [
        [1.965908, 1.0112865, 1.0112865, 0.52021784],
        [4.1224113, 1.9968134, 1.9968134, 0.96721643],
        [8.416739, 4.1833673, 4.1833673, 2.0792568],
        [16.935543, 8.534108, 8.534108, 4.3004827],
        [33.924816, 17.166693, 17.166693, 8.686718],
        [67.87687, 34.385098, 34.385098, 17.41882],
        [135.76744, 68.7964, 68.7964, 34.860676],
        [271.5416, 137.60588, 137.60588, 69.73287],
        [543.0866, 275.21814, 275.21814, 139.47136],
        [1086.1624, 550.43286, 550.43286, 278.94202],
    ],
    dtype=np.float32,
)

RECONSTRUCTION_FACTOR = np.float32(0.5)  # DWTGenerator.cu:1052 (midpoint dequant)

# --------------------------------------------------------------------------
# Color transforms.
# Reversible (lossless, CodingEngine.cu:372-374 / DecodingEngine.cu:613-615):
#   Y = floor((R + 2G + B) / 4);  U = B - G;  V = R - G
#   G = Y - floor((U + V) / 4);   R = V + G;  B = U + G
# Irreversible (lossy): BT.601 ICT matrices (CodingEngine.cuh:25,
# DecodingEngine.cuh:41).
# --------------------------------------------------------------------------
ICT_FORWARD = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float32,
)
ICT_BACKWARD = np.array(
    [
        [1.0, 0.0, 1.402],
        [1.0, -0.344136, -0.714136],
        [1.0, 1.772, 0.0],
    ],
    dtype=np.float32,
)

# Subband codes used by the bitplane coder's LUT addressing
# (BPCEngine.cu:143-170: "CodeBlock Subband: LL = 0, HL = 0, LH = 1, HH = 2";
# a codeblock in the residual LL carries level == wavelet_levels, subband 0).
SUBBAND_HL = 0
SUBBAND_LH = 1
SUBBAND_HH = 2

# Column indices into WAVELET_QSTEPS
QS_LL, QS_HL, QS_LH, QS_HH = 0, 1, 2, 3


def adapted_size(width: int, height: int) -> tuple[int, int]:
    """Round (width, height) up to codeblock multiples.

    Mirrors SupportFunctions::fixImageProportions
    (SupportFunctions/AuxiliarFunctions.cpp:22-26).
    """
    aw = -(-width // CBLOCK_WIDTH) * CBLOCK_WIDTH
    ah = -(-height // CBLOCK_LENGTH) * CBLOCK_LENGTH
    return aw, ah


def num_codeblocks(adapted_width: int, adapted_height: int) -> int:
    """Number of 64x64 codeblocks in an adapted plane (BPCEngine.cu:2315)."""
    return -(-(adapted_width * adapted_height) // CBLOCK_SIZE)


def l2norm_column(level: int, subband: int, wavelet_levels: int) -> tuple[int, int]:
    """(row, col) into WAVELET_QSTEPS used by the complexity-scalability rule.

    Mirrors BPCEngine.cu:1685-1692: the residual LL (level == wavelet_levels)
    uses row max(level-1, 0) col 0; other subbands use row=level,
    col = 3 - subband (an idiosyncratic but format-relevant mapping).
    """
    if level == wavelet_levels:
        return max(level - 1, 0), 0
    return level, 3 - subband
