"""PICSONG-TPU: a JPEG2000-style image/video codec framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the CUDA
reference codec PICSONG (`13Karl/CUDA-Image-and-Video-codec`): reversible
CDF 5/3 and irreversible CDF 9/7 lifting DWT, BPC-PaCo bitplane entropy
coding with stationary context-probability LUTs and a branchless 16-bit
arithmetic coder, codestream relocation/packing, and a pipelined video
engine — expressed as whole-array programs (full-plane vectorized lifting,
codeblock lane-machine vectorization, mesh-sharded multi-device scaling)
rather than as a translation of the reference's warp/stream machinery.

Layer map (mirrors SURVEY.md section 7):
  core/       codestream spec as pure functions (header, LUT, image IO)
  reference/  NumPy oracle implementation with exact reference semantics
  transform/  DWT 5/3 + 9/7 forward/reverse (JAX)
  entropy/    BPC-PaCo encoder/decoder (JAX)
  assembly/   codestream packing (prefix-sum + gather/scatter)
  engine/     single-device + pipelined image/video engines and CLI
  dist/       device-mesh sharded pipelines (halo exchange, frame DP)
  obs/        tracing, stage timers, metrics
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax


def _enable_persistent_compile_cache() -> None:
    """Keep compiled programs on disk across processes.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is left
    alone. Otherwise the cache lives at the fixed `<checkout>/.jax_cache`
    (a fixed path, because the path is part of the cache key)."""
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_persistent_compile_cache()
