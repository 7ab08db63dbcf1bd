"""Backend-facing policy: where the compile cache lives, which backend
compacts `.vcfz` planes on device, and one card per process under
jax.distributed."""

import os
import subprocess
import sys

import jax
import pytest

import vcfc_tpu
from vcfc_tpu.ops.vcfz_device import device_compaction
from vcfc_tpu.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the process-wide cache settings the helper may change."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    vcfc_tpu._configure_compile_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")


def test_compile_cache_env_var_is_left_alone(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    vcfc_tpu._configure_compile_cache()
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cli_writes_cache_to_env_dir(tmp_path, data_dir):
    """A CLI run with JAX_COMPILATION_CACHE_DIR set caches there."""
    cache = tmp_path / "cache"
    env = {
        **os.environ,
        "JAX_COMPILATION_CACHE_DIR": str(cache),
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
        "VCFC_FORCE_DEVICE": "1",
    }
    r = subprocess.run(
        [sys.executable, "-m", "vcfc_tpu.cli", "compress",
         str(data_dir / "small.vcf"), str(tmp_path / "out.vcfc")],
        capture_output=True, env=env, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out.vcfc").read_bytes() == (data_dir / "small.vcfc").read_bytes()
    assert any(cache.iterdir())


@pytest.mark.parametrize("backend,want", [("cpu", False), ("gpu", True)])
def test_device_compaction_follows_backend(monkeypatch, backend, want):
    monkeypatch.delenv("VCFZ_COMPACT", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device_compaction() is want


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


@pytest.mark.parametrize(
    "cards,process_id,given,want",
    [(4, 6, None, [2]), (4, 1, [3], [3]), (0, 1, None, None)],
)
def test_initialize_opens_one_card_per_process(monkeypatch, cards, process_id, given, want):
    rec = _Recorder()
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    monkeypatch.setattr(distributed, "local_card_count", lambda: cards)
    distributed.initialize("localhost:1234", 4, process_id, local_device_ids=given)
    (args, kwargs), = rec.calls
    assert args == ("localhost:1234", 4, process_id)
    assert kwargs["local_device_ids"] == want


def test_initialize_unconfigured_is_a_no_op(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    distributed.initialize()
    assert rec.calls == []
