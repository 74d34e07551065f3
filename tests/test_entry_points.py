"""The GPU entry points off the GPU: compile-cache placement, and the
refusals of chip_smoke.py and bench.py where there is no GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import jax

from alphazeroforhnefatafl_tpu.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]

_COMPILE_ONE = """
import jax, jax.numpy as jnp
from alphazeroforhnefatafl_tpu.utils.compile_cache import enable_compile_cache
path = enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(5.0)).block_until_ready()
print(path)
"""


def _run(args, cwd, env=None, timeout=300):
    return subprocess.run(
        args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout
    )


def test_compile_cache_lands_in_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs are cached
    there and the repository's default directory gains nothing."""
    cache = tmp_path / "cache"
    before = sorted(os.listdir(REPO_CACHE_DIR)) if REPO_CACHE_DIR.exists() else []
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache), PYTHONPATH=str(ROOT))
    r = _run([sys.executable, "-c", _COMPILE_ONE], cwd=tmp_path, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and os.listdir(cache)
    after = sorted(os.listdir(REPO_CACHE_DIR)) if REPO_CACHE_DIR.exists() else []
    assert after == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(ROOT / ".jax_cache") == str(REPO_CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_chip_smoke_refuses_without_gpu():
    r = _run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_refuses_without_gpu():
    """Without a GPU and without an explicit CPU request, bench.py exits
    non-zero and prints no measurement."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = _run([sys.executable, "bench.py"], cwd=ROOT, env=env)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr and not r.stdout.strip()


def test_bench_peaks_refuse_unknown_device_kind():
    import bench

    assert bench.peaks_for("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks_for("Some Other Accelerator")
