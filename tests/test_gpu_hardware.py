"""On-card checks: the CUDA jump kernel and the demo oracle on a GPU.

The suite's own process stays on the CPU backend (conftest.py), so each
check runs in a fresh subprocess that opens the GPU. Without a GPU they
skip. On a card:

    python -m pytest -m gpu tests/test_gpu_hardware.py -v
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXPECTED = REPO / "tests" / "data" / "demo" / "expectedResults" / \
    "somaticSV.vcf.gz"

pytestmark = pytest.mark.gpu


def _run(code, *args, timeout=900):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(REPO))


@pytest.fixture(scope="module")
def gpu():
    proc = _run("import jax; print(jax.devices()[0].platform)",
                timeout=300)
    platform = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    if proc.returncode != 0 or platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {platform!r})")


_KERNEL = r"""
import json, sys
import numpy as np
from manta_tpu.align.aligners import AlignmentScores, jump_score_batch
from manta_tpu.align.device_jumpscore import make_bucketed_scorer
sc = AlignmentScores(1, -9, -19, -1, -1)
rng = np.random.default_rng(int(sys.argv[1]))
lq, lr = int(sys.argv[2]), int(sys.argv[3])
acgt = np.frombuffer(b"ACGT", np.uint8)
jobs = []
for b in range(12):
    r1 = acgt[rng.integers(0, 4, lr)].tobytes()
    r2 = acgt[rng.integers(0, 4, lr)].tobytes()
    n = int(rng.integers(1, lq + 1))
    a = min(n // 2, lr)
    q = r1[lr - a:] + r2[:n - a] if b % 2 else acgt[
        rng.integers(0, 4, n)].tobytes()
    jobs.append((q, r1, r2))
got = make_bucketed_scorer(sc, -100)(jobs)
want = jump_score_batch(jobs, sc, -100)
print(json.dumps({"equal": got.tolist() == want.tolist()}))
"""


@pytest.mark.parametrize("lq,lr", [(100, 300), (400, 800), (1500, 700)])
def test_cuda_jump_kernel_matches_native(gpu, lq, lr):
    """The production scorer on the card (CUDA kernel, one and several
    512-row bands) against the native host scorer."""
    proc = _run(_KERNEL, str(lq + lr), str(lq), str(lr))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1])["equal"]


_DEMO = r"""
import gzip, json, sys
from manta_tpu.workflow.run import run_workflow
from __graft_entry__ import demo_fasta_path
run_dir, expected = sys.argv[1:3]
demo = "tests/data/demo/"
run_workflow([demo + "HCC1954.NORMAL.30x.compare.COST16011_region.bam"],
             [demo + "G15512.HCC1954.1.COST16011_region.bam"],
             demo_fasta_path(), run_dir, is_exome=True, verbose=False,
             use_device_scoring="jump")


def body(p):
    with gzip.open(p, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


log = open(run_dir + "/workspace/workflow_log.txt").read()
print(json.dumps({
    "cuda": "jump kernel: cuda" in log,
    "equal": body(run_dir + "/results/variants/somaticSV.vcf.gz")
    == body(expected)}))
"""


def test_demo_oracle_on_gpu(gpu, tmp_path):
    proc = _run(_DEMO, str(tmp_path / "run"), str(EXPECTED))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res == {"cuda": True, "equal": True}
