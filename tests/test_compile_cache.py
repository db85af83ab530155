"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set and `<checkout>/.jax_cache` otherwise. The setting is read when
the package is imported, so each case runs in a fresh interpreter."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_seen(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax, picsong_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(env_dir, tmp_path):
    if env_dir is None:
        assert _cache_dir_seen(None) == os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        assert _cache_dir_seen(want) == want
