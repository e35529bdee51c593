"""The measurement entry points (chip_smoke.py, bench.py) refuse to run
without a GPU instead of timing the CPU, and the persistent compile cache
lands where the environment says, else at a fixed path in the checkout."""

import importlib
import os

import jax
import pytest

from sphinxsys_jax.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,argv", [("chip_smoke", ([],)),
                                         ("bench", ())],
                         ids=["chip_smoke", "bench"])
def test_entry_point_refuses_cpu(script, argv, capsys):
    mod = importlib.import_module(script)
    with pytest.raises(SystemExit) as exc:
        mod.main(*argv)
    assert "needs a GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""      # no result line


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cc.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
