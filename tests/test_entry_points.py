"""Entry-point plumbing that runs on the CPU: compile-cache placement and
the parts of bench.py / chip_smoke.py that decide before any device work."""
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and the
    code sets nothing itself."""
    from terra_tpu import compile_cache

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    """Without the variable the cache is the checkout's fixed .jax_cache."""
    from terra_tpu import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_bench_timing_summary():
    import bench

    t = bench.timing([0.4, 0.1, 0.2, 0.3, 0.5])
    assert t["median_s"] == 0.3 and t["min_s"] == 0.1 and t["max_s"] == 0.5
    assert t["reps"] == 5 and abs(t["spread"] - 0.4 / 0.3) < 1e-12


def test_bench_refuses_a_cpu_device():
    """A benchmark number never comes from the CPU."""
    import bench

    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench.device_info()


def test_chip_smoke_fails_without_a_gpu(capsys, restore_cache_dir):
    """On the CPU the smoke test exits non-zero without its final line."""
    import chip_smoke

    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok": true' not in out and '"phase": "device"' in out
