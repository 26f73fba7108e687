"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins, otherwise a
fixed directory inside the checkout."""

import pathlib

import jax
import pytest

from srslte_emane_tpu.utils import compile_cache

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_config():
    """Restore JAX's cache settings after the test."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_default_dir_is_fixed_in_checkout():
    assert compile_cache.DEFAULT_DIR == CHECKOUT / ".jax_cache"
    assert ".jax_cache/" in (CHECKOUT / ".gitignore").read_text().split()


def test_env_var_is_honoured_and_nothing_set(monkeypatch, cache_config,
                                             tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_without_env_var_uses_checkout_dir(monkeypatch, cache_config):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.enable() == str(CHECKOUT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(CHECKOUT / ".jax_cache")
