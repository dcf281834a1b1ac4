"""Test fixtures.

Tests run on the CPU backend with 8 virtual devices, so multi-device
sharding logic is exercised without accelerators. Tests that need an
NVIDIA GPU carry the `gpu` marker and skip here; run them on a card
with `python -m pytest -m gpu tests/`. The demo reference fasta is
extracted once into .testdata/.
"""

import os

os.environ.pop("XLA_FLAGS", None)
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import pathlib
import tarfile

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
# The demo dataset + expected results are vendored in-tree
# (tests/data/demo) so the acceptance suite is standalone; the
# read-only reference mount remains a fallback for historical runs
# (reference: src/demo/runMantaWorkflowDemo.py oracle layout).
_VENDORED = REPO / "tests" / "data" / "demo"
_REF_DEMO = pathlib.Path("/root/reference/src/demo/data")
DEMO = _VENDORED if _VENDORED.exists() else _REF_DEMO
TESTDATA = REPO / ".testdata"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")
    config.addinivalue_line(
        "markers", "slow: long-running; deselected by the tier-1 run")


@pytest.fixture(scope="session")
def demo_fasta() -> str:
    """Extract the demo reference fasta (tar.bz2) once; return its path."""
    TESTDATA.mkdir(exist_ok=True)
    fa = TESTDATA / "Homo_sapiens_assembly19.COST16011_region.fa"
    if not fa.exists():
        with tarfile.open(DEMO / (fa.name + ".tar.bz2")) as tf:
            tf.extractall(TESTDATA)
        # archive may nest the file; locate and move it up
        if not fa.exists():
            for p in TESTDATA.rglob(fa.name):
                p.rename(fa)
                break
    fai = TESTDATA / (fa.name + ".fai")
    if not fai.exists():
        src = DEMO / (fa.name + ".fai")
        fai.write_bytes(src.read_bytes())
    return str(fa)


@pytest.fixture(scope="session")
def tumor_bam() -> str:
    return str(DEMO / "G15512.HCC1954.1.COST16011_region.bam")


@pytest.fixture(scope="session")
def normal_bam() -> str:
    return str(DEMO / "HCC1954.NORMAL.30x.compare.COST16011_region.bam")
