"""chip_smoke.py's phases at small sizes on the CPU, its refusal to run
without a GPU, and the trace reduction of tools/trace_roundtrip.py.

The phases are the same functions the GPU run calls at full size; here
they check the CLI path and every oracle comparison on tiny geometry."""

import pytest

import chip_smoke
from tools import trace_roundtrip

SMALL_PHASES = {
    "gray_lossless": dict(size=128, wl=3, n_blocks=4),
    "rgb_still": dict(width=128, height=96, wl=2),
    "coding_modes": dict(size=64, wl=2),
    "big_image": dict(size=192, wl=2),
    "video": dict(width=64, height=64, frames=4, streams=2, wl=2),
}


@pytest.mark.parametrize("name", sorted(SMALL_PHASES))
def test_phase_small(name, tmp_path):
    line = chip_smoke.PHASES[name](str(tmp_path), **SMALL_PHASES[name])
    assert "cold" in line and "warm" in line and "planes_host" in line


def test_phase_four_devices_matches_single(tmp_path):
    """-sharded 4 image and video bytes equal the single-device output,
    and each of the 4 devices holds a share of the blocks and frames."""
    out = chip_smoke.phase_four_gpus(str(tmp_path), image=(64, 256),
                                     width=64, height=64, frames=8,
                                     streams=4, n_dev=4, wl=2)
    for line in out.splitlines():
        if "per device" in line:
            assert line.count("=") == 4 and "=0" not in line


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_pick_codeblocks_covers_every_band():
    import numpy as np
    from picsong_tpu.core.geometry import codeblock_bands
    levels, subbands = codeblock_bands(2048, 2048, 5)
    picked, n_pairs = chip_smoke.pick_codeblocks(levels, subbands, 32)
    assert len(picked) >= 32 and len(set(picked)) == len(picked)
    got = set(zip(levels[picked].tolist(), subbands[picked].tolist()))
    assert len(got) == n_pairs == len(set(zip(levels.tolist(),
                                              subbands.tolist())))
    assert np.all(np.diff(picked) > 0)


def test_trace_summary_counts_and_idle_share():
    ops = [("fusion_1", 100, 200), ("MemcpyH2D", 150, 250),
           ("fusion_2", 400, 500), ("MemcpyD2H", 600, 610),
           ("fusion_3", 990, 1100), ("fusion_4", 1200, 1300)]
    host = [("cuGraphLaunch (CudaGraph:1)", 90, 95),
            ("cuGraphLaunch (CudaGraph:2)", 1500, 1505), ("other", 1, 2)]
    got = trace_roundtrip.summarize(ops, host, (0, 1000))
    assert got["launches"] == 5 and got["kernels"] == 3
    assert got["d2h_copies"] == 1 and got["graph_launches"] == 1
    # union [100,250) + [400,500) + [600,610) + [990,1000), clipped
    assert got["busy_ms"] == pytest.approx(270 / 1e6)
    assert got["idle_share"] == pytest.approx(1 - 270 / 1000)
    assert trace_roundtrip.union_ns([]) == 0
