"""chip_smoke.py's refusal off the GPU, and the compile-cache placement it
shares with bench.py (profiling.enable_compile_cache)."""
import importlib.util
import os

import jax

from markovmodels_tpu import profiling

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                               "chip_smoke.py")
)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_chip_smoke_refuses_a_cpu_device(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "no GPU" in err


def test_compile_cache_in_the_checkout_when_unset(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = profiling.enable_compile_cache(str(tmp_path))
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the default root is the checkout that holds the package
        assert profiling._CHECKOUT == os.path.dirname(
            os.path.dirname(os.path.abspath(profiling.__file__)))
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_compile_cache() == str(tmp_path / "env")
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before
