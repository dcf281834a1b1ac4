"""Device routing: the platform router, the compile-cache placement, the
bucketed jump scorer's padding tiers, and the one-process rule (no
forked worker ever opens JAX)."""

import gzip
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import manta_tpu.device as device
from manta_tpu.align.aligners import AlignmentScores, jump_score_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
SCORES = AlignmentScores(2, -8, -12, -1, -1)


@pytest.mark.parametrize("platform,kernel", [
    ("gpu", "cuda"), ("cpu", "xla"), ("metal", None), ("rocm", None)])
def test_jump_kernel_per_platform(platform, kernel):
    if kernel is None:
        with pytest.raises(RuntimeError, match=platform):
            device.jump_kernel_for(platform)
    else:
        assert device.jump_kernel_for(platform) == kernel


@pytest.mark.parametrize("mode,platform,will_fork,want", [
    ("auto", "gpu", False, ("jump", "cuda")),
    ("auto", "cpu", False, (None, None)),
    ("auto", "gpu", True, (None, None)),
    ("jump", "gpu", True, ("jump", "cuda")),
    ("exact", "gpu", False, ("exact", "cuda")),
    ("mxu", "cpu", False, ("mxu", "xla")),
    ("jump", "cpu", True, ("jump", "xla")),
    (True, "cpu", False, ("exact", "xla")),
    ("off", "gpu", False, (None, None)),
])
def test_resolve_route(monkeypatch, mode, platform, will_fork, want):
    probed = []

    def fake_probe():
        probed.append(1)
        return platform, f"{platform}-kind", 1
    monkeypatch.setattr(device, "probe", fake_probe)
    route = device.resolve(mode, will_fork=will_fork)
    assert (route.mode, route.jump_kernel) == want
    # 'off' and 'auto' ahead of forked workers never open JAX
    assert bool(probed) == (mode != "off"
                            and not (mode == "auto" and will_fork))
    if probed:
        assert f"platform={platform}" in route.describe()


@pytest.mark.parametrize("mode", ["auto", "jump"])
def test_resolve_unknown_platform_is_an_error(monkeypatch, mode):
    monkeypatch.setattr(device, "probe", lambda: ("rocm", "MI300X", 1))
    with pytest.raises(RuntimeError, match="'rocm'"):
        device.resolve(mode)


_CACHE_PROBE = """
import jax
from manta_tpu.device import probe
probe()
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         cwd=str(tmp_path), capture_output=True,
                         text=True, check=True).stdout.split()[-1]
    want = str(tmp_path / env_dir) if env_dir else \
        str(REPO / ".jax_cache")
    assert out == want


def _seq(rng, n):
    return rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes()


@pytest.mark.parametrize("B,lq,l1,l2", [
    (8, 128, 128, 128), (9, 129, 128, 129), (16, 256, 257, 100),
    (17, 257, 512, 513), (3, 60, 1024, 1025)])
def test_bucketed_scorer_tiers_match_native(B, lq, l1, l2):
    """Jobs sized at and just past each padding tier (rows, query, both
    references) score exactly as the native host scorer, and the
    dispatch records the padded shape."""
    from manta_tpu.align.device_jumpscore import (
        DISPATCH_STATS, _bucket, make_bucketed_scorer)
    rng = np.random.default_rng(B * 1000 + lq)
    jobs = []
    for b in range(B):
        r1, r2 = _seq(rng, l1), _seq(rng, l2)
        n = lq if b == 0 else int(rng.integers(1, lq + 1))
        a = min(n // 2, l1)
        q = (r1[l1 - a:] + r2[:n - a]) if b % 2 else _seq(rng, n)
        jobs.append((q, r1, r2))
    scorer = make_bucketed_scorer(SCORES, -100)
    before = DISPATCH_STATS["shapes"].copy()
    got = scorer(jobs)
    assert got.tolist() == jump_score_batch(jobs, SCORES, -100).tolist()
    key = (_bucket(B, tiers=(8, 16, 32, 64, 128, 256)),
           _bucket(max(len(j[0]) for j in jobs)), _bucket(l1), _bucket(l2))
    assert DISPATCH_STATS["shapes"][key] == before[key] + 1


# Runs the demo at -j 2 with phase 2 forced onto the device route and
# records, in every forked child, whether JAX was already imported when
# it was forked or got imported later.
_FORK_DRIVER = r"""
import json, os, sys
marks = sys.argv[1]
parent = os.getpid()


class Watch:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" and os.getpid() != parent:
            open(os.path.join(marks, f"import.{os.getpid()}"), "w").close()
        return None


def child():
    with open(os.path.join(marks, f"fork.{os.getpid()}"), "w") as f:
        f.write(json.dumps("jax" in sys.modules))


sys.meta_path.insert(0, Watch())
os.register_at_fork(after_in_child=child)
from manta_tpu.workflow.run import run_workflow
normal, tumor, fasta, run_dir, mode = sys.argv[2:7]
run_workflow([normal], [tumor], fasta, run_dir, is_exome=True, n_jobs=2,
             verbose=False, use_device_scoring=mode, cmdline="fork-test")
"""


def _decompressed(run_dir):
    out = {}
    for p in sorted((pathlib.Path(run_dir) / "results" /
                     "variants").glob("*.vcf.gz")):
        with gzip.open(p, "rb") as f:
            out[p.name] = f.read()
    return out


def test_device_route_at_j2_keeps_jax_out_of_forks(
        tmp_path, demo_fasta, normal_bam, tumor_bam):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    runs = {}
    for mode in ("off", "jump"):
        marks = tmp_path / f"marks_{mode}"
        marks.mkdir()
        run_dir = tmp_path / f"run_{mode}"
        subprocess.run(
            [sys.executable, "-c", _FORK_DRIVER, str(marks), normal_bam,
             tumor_bam, demo_fasta, str(run_dir), mode],
            env=env, check=True, capture_output=True, cwd=str(tmp_path))
        forks = sorted(marks.glob("fork.*"))
        assert forks, "the -j 2 run forked no workers"
        assert not any(json.loads(p.read_text()) for p in forks), \
            "a worker was forked from a process that had imported jax"
        assert not list(marks.glob("import.*")), "a forked worker " \
            "imported jax"
        runs[mode] = run_dir
    log = (runs["jump"] / "workspace" / "workflow_log.txt").read_text()
    assert "device 'jump' (jump kernel: xla)" in log
    host, dev = _decompressed(runs["off"]), _decompressed(runs["jump"])
    assert host.keys() == dev.keys() and "somaticSV.vcf.gz" in host
    assert host == dev


_SMOKE = str(REPO / "chip_smoke.py")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    """On the CPU backend, or copied away from the repository, the smoke
    run exits non-zero and prints no ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text(pathlib.Path(_SMOKE).read_text())
    else:
        script = pathlib.Path(_SMOKE)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          cwd=str(script.parent), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
