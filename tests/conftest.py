"""Test config: pin JAX to the CPU backend with 8 virtual devices, so
multi-device sharding logic is exercised without accelerator hardware
(SURVEY.md §4 test strategy)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import importlib.util
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
sys.path.insert(0, str(REPO))

from mercat2_tpu.utils.runtime import enable_compilation_cache

enable_compilation_cache()


@pytest.fixture(scope="session")
def ref_data() -> Path:
    """Bundled reference test data (read-only)."""
    if not REFERENCE.exists():
        pytest.skip("reference data not available")
    return REFERENCE / "data"


@pytest.fixture(scope="session")
def ref_kmers_module():
    """Load the reference's kmer module as a black-box parity oracle.

    Imported from the read-only reference checkout purely to *check* our
    outputs in tests; no reference code ships in this repo.
    """
    path = REFERENCE / "lib" / "mercat2_kmers.py"
    if not path.exists():
        pytest.skip("reference not available")
    spec = importlib.util.spec_from_file_location("ref_mercat2_kmers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def golden_results() -> Path:
    p = REFERENCE / "results" / "2023-11-29"
    if not p.exists():
        pytest.skip("golden results not available")
    return p
