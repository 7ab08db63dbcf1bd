import os
import pathlib

import pytest

DATA_DIR = pathlib.Path(__file__).parent / "data"


def pytest_configure(config):
    """Tests run on a virtual 8-device CPU mesh, so the multi-device
    sharding logic runs without accelerator hardware.  The card-only
    suite (``pytest -m gpu``, run on the GPU by chip_smoke.py) keeps the
    default backend.  Runs before any test module imports JAX."""
    if config.getoption("markexpr") == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA_DIR


@pytest.fixture(scope="session")
def small_vcf() -> bytes:
    return (DATA_DIR / "small.vcf").read_bytes()


@pytest.fixture(scope="session")
def small_vcfc() -> bytes:
    return (DATA_DIR / "small.vcfc").read_bytes()


@pytest.fixture(scope="session")
def sv_vcf() -> bytes:
    return (DATA_DIR / "sv.vcf").read_bytes()


@pytest.fixture(scope="session")
def sv_vcfc() -> bytes:
    return (DATA_DIR / "sv.vcfc").read_bytes()
