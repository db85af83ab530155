"""Codestream relocation: dense pack/unpack of per-codeblock streams.

Whole-array rework of BitStreamBuilder (BitStreamBuilder/BitStreamBuilder.cu):
the reference needs a CUB prefix sum, a 256-entry binary-search index LUT
and a relocation kernel because each GPU thread hunts for its source word.
The packed layout itself is a plain prefix-sum addressing scheme —
per-block payload regions are contiguous — so here it reduces to one
cumulative sum plus one flat gather (pack) or scatter (unpack); the
binary-search index LUT has no reason to exist off the GPU.

Wire layout (identical to the reference):
  shorts[0..8]    global header (real values on the first frame/component,
                  0xFFFF filler afterwards)
  shorts[9+2i]    codeblock i MSB          (buildBitStreamLUTBS:128)
  shorts[9+2i+1]  codeblock i size         (used words incl. the MSB word)
  payload         concatenated words 1..size-1 of every codeblock
  final short     0xFFFF filler (allocated, never written,
                  launchPrefixArrayGeneration:305)
"""

from __future__ import annotations

import numpy as np

from ..core import spec


def stream_length(sizes: np.ndarray) -> int:
    ncb = len(sizes)
    return int(np.sum(sizes)) + 9 + 2 * ncb - ncb + 1


def pack_streams(streams: np.ndarray, sizes: np.ndarray,
                 header: np.ndarray | None) -> np.ndarray:
    """(ncb, 4096) int32 + sizes -> dense uint16 codestream (vectorized)."""
    ncb = streams.shape[0]
    sizes = np.asarray(sizes, dtype=np.int64)
    counts = sizes - 1                      # payload words per block
    total_payload = int(counts.sum())
    length = stream_length(sizes)
    out = np.full(length, 0xFFFF, dtype=np.uint16)
    if header is not None:
        out[:9] = header
    out[9:9 + 2 * ncb:2] = (streams[:, 0] & 0xFFFF).astype(np.uint16)
    out[10:10 + 2 * ncb:2] = (sizes & 0xFFFF).astype(np.uint16)
    if total_payload:
        src_cb = np.repeat(np.arange(ncb, dtype=np.int64), counts)
        seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total_payload, dtype=np.int64) - seg_start[src_cb] + 1
        payload_base = 8 + 2 * ncb
        out[payload_base + 1: payload_base + 1 + total_payload] = (
            streams.reshape(-1)[src_cb * spec.CBLOCK_SIZE + within] & 0xFFFF
        ).astype(np.uint16)
    return out


def unpack_streams(stream: np.ndarray, ncb: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense codestream -> ((ncb, 4096) int32 with -1 fill, sizes)."""
    stream = np.asarray(stream, dtype=np.uint16)
    sizes = stream[10:10 + 2 * ncb:2].astype(np.int64)
    counts = sizes - 1
    total_payload = int(counts.sum())
    out = np.full((ncb, spec.CBLOCK_SIZE), -1, dtype=np.int32)
    out[:, 0] = stream[9:9 + 2 * ncb:2].astype(np.int32)
    if total_payload:
        src_cb = np.repeat(np.arange(ncb, dtype=np.int64), counts)
        seg_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total_payload, dtype=np.int64) - seg_start[src_cb] + 1
        payload_base = 8 + 2 * ncb
        out.reshape(-1)[src_cb * spec.CBLOCK_SIZE + within] = stream[
            payload_base + 1: payload_base + 1 + total_payload].astype(np.int32)
    return out, sizes
