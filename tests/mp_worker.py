"""Real multi-process distributed worker (spawned by test_multihost.py).

Each spawned process is one 'host': it joins the jax.distributed cluster
on the CPU backend, encodes its frame slab, hits the cross-process
barrier, rank 0 merges — i.e. the actual init_distributed +
sync_global_devices path that sequential single-process simulation
cannot exercise. Then the same for decode.

argv: process_id num_processes coordinator_port tmpdir
"""

import os
import sys

# running as `python tests/mp_worker.py` puts tests/ on sys.path, not the
# repo root, so insert the root explicitly
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax

    # force the CPU platform BEFORE any backend is touched, as conftest
    # does: two workers must never race for one accelerator
    jax.config.update("jax_platforms", "cpu")

    pid, n = int(sys.argv[1]), int(sys.argv[2])
    port, tmp = sys.argv[3], sys.argv[4]

    from picsong_tpu.core.header import CodecConfig
    from picsong_tpu.core.lut import LUTParams, neutral_lut
    from picsong_tpu.dist import multihost as mh

    got = mh.init_distributed(coordinator_address=f"127.0.0.1:{port}",
                              num_processes=n, process_id=pid)
    assert got == (pid, n), f"distributed init returned {got}"
    assert jax.process_count() == n

    params = LUTParams()
    cfg = CodecConfig(width=64, height=64, wavelet_levels=1, frames=5)
    lut = neutral_lut(params, 1, 2)
    mh.encode_video_multihost(f"{tmp}/v.raw", f"{tmp}/mp.enc", cfg, [lut],
                              params, frames=5, batch=2)
    mh.decode_video_multihost(f"{tmp}/mp.enc", f"{tmp}/mp_dec.raw", cfg,
                              [lut], params, batch=2)
    print(f"WORKER-OK {pid}")


if __name__ == "__main__":
    main()
