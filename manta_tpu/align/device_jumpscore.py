"""Batched jump-SWG alignment scoring on device (JAX/XLA).

Device half of the SURVEY plan's "batched banded jump-SWG" target: the
two-reference jump DP (native mt_align_jump) evaluated score-only for a
whole batch of (contig, ref1, ref2) triples at once. The winning contig
per edge can then be backtraced once on the host native aligner, so
device routing cannot change results (identical integer recurrences;
the max score is tie-order independent).

Formulation: lax.scan over reference columns with rows as the vector
axis. The in-column INSERT dependency
(ci[q] = max(f[q], ci[q-1]) + extend) is a max-plus prefix evaluated
exactly with a cummax over (f[k] - k*extend):

    ci[q] = extend*(q+1) + cummax_{k<=q}(f[k] - extend*k)

Integer int32 DP -> bit-exact equality with the native aligner's
scores. Rows are padded to shape buckets; padded columns freeze the
carried state so they cannot perturb results.

Reference semantics (studied not copied):
alignment/GlobalJumpAlignerImpl.hpp.

This XLA form is the plain reference for the hand-written CUDA kernel
(cuda_jumpscore.py) that serves production batches on a GPU, and the
form that runs when device routing is forced on the CPU backend.
"""

from __future__ import annotations

from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BAD = -10000
NEG = -(1 << 28)


def _maxplus_prefix(f, extend, nq1):
    """ci[q] = max_{k<=q}(f[k] + (q-k+1)*extend), exact int32."""
    k = jnp.arange(nq1, dtype=jnp.int32)[None, :]
    g = jnp.where(f <= BAD, jnp.int32(NEG), f - extend * k)
    run = jax.lax.associative_scan(jnp.maximum, g, axis=1)
    out = run + extend * (k + 1)
    return jnp.maximum(out, jnp.int32(BAD))


def _make_col_ref1(query, query_len, scores, jump_score):
    match, mismatch, open_, extend = scores
    B, nq = query.shape
    nq1 = nq + 1
    qn = query_len[:, None]

    def update(carry, col):
        pm, pd, pi, pj, best = carry
        ref_c, active = col
        sub = jnp.where(query == ref_c[:, None], match, mismatch)
        diag = jnp.maximum(jnp.maximum(pm[:, :-1], pd[:, :-1]), pi[:, :-1])
        vm = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), diag + sub], axis=1)
        vd = jnp.concatenate(
            [jnp.full((B, 1), BAD, jnp.int32),
             jnp.maximum(jnp.maximum(pm[:, 1:] + open_, pd[:, 1:]),
                         pi[:, 1:]) + extend], axis=1)
        vd = vd.at[:, 1].set(BAD)
        # insert chain starts at row 2 (row 1 forced BAD, matching the
        # reference's q==0 cutoff)
        f = jnp.concatenate(
            [jnp.full((B, 2), BAD, jnp.int32), vm[:, 1:-1] + open_],
            axis=1)
        vi = _maxplus_prefix(f, extend, nq1)
        vi = vi.at[:, 0].set(BAD).at[:, 1].set(BAD)
        vj = jnp.maximum(jnp.maximum(vm + jump_score, vi + jump_score), pj)
        vj = vj.at[:, 0].set(BAD)

        act = active[:, None]
        vm = jnp.where(act, vm, pm)
        vd = jnp.where(act, vd, pd)
        vi = jnp.where(act, vi, pi)
        vj = jnp.where(act, vj, pj)
        end_val = jnp.take_along_axis(vm, qn, axis=1)[:, 0]
        best = jnp.where(active, jnp.maximum(best, end_val), best)
        return (vm, vd, vi, vj, best), None

    return update


def _make_col_ref2(query, query_len, scores):
    match, mismatch, open_, extend = scores
    B, nq = query.shape
    nq1 = nq + 1
    qn = query_len[:, None]

    def update(carry, col):
        pm, pd, pi, pj, best = carry
        ref_c, active = col
        sub = jnp.where(query == ref_c[:, None], match, mismatch)
        diag = jnp.maximum(
            jnp.maximum(jnp.maximum(pm[:, :-1], pd[:, :-1]), pi[:, :-1]),
            pj[:, :-1])
        vm = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), diag + sub], axis=1)
        vd = jnp.concatenate(
            [jnp.full((B, 1), BAD, jnp.int32),
             jnp.maximum(jnp.maximum(pm[:, 1:] + open_, pd[:, 1:]),
                         pi[:, 1:]) + extend], axis=1)
        # insert: f[q] = max(vm[q-1]+open, pj[q-1]); jump->ins skips open
        f_body = jnp.maximum(vm[:, :-1] + open_, pj[:, :-1])
        f = jnp.concatenate(
            [jnp.full((B, 1), BAD, jnp.int32), f_body], axis=1)
        vi = _maxplus_prefix(f, extend, nq1)
        vi = vi.at[:, 0].set(BAD)
        vj = pj  # carried unchanged across ref2

        act = active[:, None]
        vm = jnp.where(act, vm, pm)
        vd = jnp.where(act, vd, pd)
        vi = jnp.where(act, vi, pi)
        end_val = jnp.take_along_axis(vm, qn, axis=1)[:, 0]
        best = jnp.where(active, jnp.maximum(best, end_val), best)
        return (vm, vd, vi, vj, best), None

    return update


@partial(jax.jit, static_argnames=("nq_pad", "nr1_pad", "nr2_pad"))
def batched_jump_score(query, query_len, ref1, ref1_len, ref2, ref2_len,
                       match, mismatch, open_, extend, off_edge,
                       jump_score, nq_pad: int, nr1_pad: int, nr2_pad: int):
    """Max jump-alignment score per batch row (int32, exact)."""
    B = query.shape[0]
    nq1 = nq_pad + 1
    q_idx = jnp.arange(nq1, dtype=jnp.int32)[None, :]
    qn = query_len[:, None]
    scores = (jnp.int32(match), jnp.int32(mismatch), jnp.int32(open_),
              jnp.int32(extend))

    def fresh():
        cm = jnp.broadcast_to(q_idx * off_edge, (B, nq1)).astype(jnp.int32)
        bad = jnp.full((B, nq1), BAD, jnp.int32)
        return cm, bad, bad, bad

    def off_edge_best(cm, best):
        cand = cm + (qn - q_idx) * off_edge
        cand = jnp.where(q_idx < qn, cand, jnp.int32(NEG))
        return jnp.maximum(best, cand.max(axis=1))

    cm, cd, ci, cj = fresh()
    best = jnp.full((B,), NEG, jnp.int32)
    cols1 = (ref1.T, jnp.arange(nr1_pad)[:, None] < ref1_len[None, :])
    (cm, cd, ci, cj, best), _ = jax.lax.scan(
        _make_col_ref1(query, query_len, scores, jnp.int32(jump_score)),
        (cm, cd, ci, cj, best), cols1)
    best = off_edge_best(cm, best)

    cm2, cd2, ci2, _ = fresh()
    cols2 = (ref2.T, jnp.arange(nr2_pad)[:, None] < ref2_len[None, :])
    (cm, cd, ci, cj, best), _ = jax.lax.scan(
        _make_col_ref2(query, query_len, scores),
        (cm2, cd2, ci2, cj, best), cols2)
    best = off_edge_best(cm, best)
    return best


def jump_scores(queries, ref1s, ref2s, scores, jump_score):
    """Convenience host wrapper: list-of-bytes in, numpy scores out."""
    B = len(queries)
    nq = max(len(q) for q in queries)
    nr1 = max(len(r) for r in ref1s)
    nr2 = max(len(r) for r in ref2s)

    def pad_to(seqs, n, fill):
        out = np.full((B, n), fill, np.int32)
        lens = np.zeros(B, np.int32)
        for i, s in enumerate(seqs):
            arr = np.frombuffer(bytes(s), np.uint8).astype(np.int32)
            out[i, :len(arr)] = arr
            lens[i] = len(arr)
        return out, lens

    q, ql = pad_to(queries, nq, 1)     # sentinel 1 never matches bases
    r1, r1l = pad_to(ref1s, nr1, 2)
    r2, r2l = pad_to(ref2s, nr2, 2)
    out = batched_jump_score(
        q, ql, r1, r1l, r2, r2l,
        scores.match, scores.mismatch, scores.open, scores.extend,
        scores.off_edge, jump_score, nq, nr1, nr2)
    return np.asarray(out)


def _bucket(n: int, tiers=(128, 256, 512, 1024, 2048, 4096)) -> int:
    for t in tiers:
        if n <= t:
            return t
    return ((n + 4095) // 4096) * 4096


# device-dispatch accounting: every bucketed-scorer call records its
# wall time (host padding, transfers and the kernel; the first call
# also carries backend start-up and compilation) and its padded shape.
# Reported once per process at exit as a "[manta-tpu] device-dispatch
# ..." stderr line.
DISPATCH_STATS = {"calls": 0, "jobs": 0, "rows": 0, "wall": 0.0,
                  "first_wall": 0.0, "shapes": Counter()}
_REPORT_REGISTERED = False


def _register_dispatch_report():
    global _REPORT_REGISTERED
    if _REPORT_REGISTERED:
        return
    _REPORT_REGISTERED = True
    import atexit
    import os as _os
    import sys as _sys

    def report():
        s = DISPATCH_STATS
        if s["calls"]:
            print(f"[manta-tpu] device-dispatch pid={_os.getpid()}: "
                  f"{s['calls']} calls, {s['jobs']} jobs, "
                  f"{s['rows']} padded rows, {s['wall']:.2f}s total, "
                  f"first {s['first_wall']:.2f}s (init+compile)",
                  file=_sys.stderr, flush=True)
            s["calls"] = 0        # once per process
    atexit.register(report)


def make_bucketed_scorer(scores, jump_score: int):
    """Production device scorer: pads job batches to shape buckets so a
    handful of compiled programs serve every junction, and returns the
    exact int32 max jump-alignment scores (bit-identical to the host
    traceback aligner, so winner selection cannot change results). The
    kernel is the one device.jump_kernel_for names for the default JAX
    platform: the CUDA kernel on a GPU, this module's XLA form on the
    CPU backend."""
    from .. import device
    kernel = device.jump_kernel_for(jax.default_backend())
    if kernel == "cuda":
        from .cuda_jumpscore import cuda_jump_score as kernel_fn
    else:
        assert kernel == "xla", kernel
        kernel_fn = batched_jump_score

    _register_dispatch_report()

    def scorer(jobs):
        import time as _time
        B = len(jobs)
        if B == 0:
            return np.zeros(0, np.int32)
        _t0 = _time.perf_counter()
        nq = _bucket(max(len(j[0]) for j in jobs))
        nr1 = _bucket(max(len(j[1]) for j in jobs))
        nr2 = _bucket(max(len(j[2]) for j in jobs))
        Bp = _bucket(B, tiers=(8, 16, 32, 64, 128, 256))

        def pad_to(seqs, n, fill):
            out = np.full((Bp, n), fill, np.int32)
            lens = np.zeros(Bp, np.int32)
            for i, s in enumerate(seqs):
                arr = np.frombuffer(bytes(s), np.uint8).astype(np.int32)
                out[i, :len(arr)] = arr
                lens[i] = len(arr)
            return out, lens

        # pad rows keep length >= 1 so the kernel's guards stay trivial;
        # sentinel codes never equal real bases
        q, ql = pad_to([j[0] for j in jobs] + [b"\x01"] * (Bp - B), nq, 1)
        r1, r1l = pad_to([j[1] for j in jobs] + [b"\x02"] * (Bp - B), nr1, 2)
        r2, r2l = pad_to([j[2] for j in jobs] + [b"\x02"] * (Bp - B), nr2, 2)
        out = kernel_fn(
            q, ql, r1, r1l, r2, r2l,
            scores.match, scores.mismatch, scores.open, scores.extend,
            scores.off_edge, jump_score, nq, nr1, nr2)
        res = np.asarray(jax.device_get(out))[:B]
        dt = _time.perf_counter() - _t0
        s = DISPATCH_STATS
        if s["calls"] == 0:
            s["first_wall"] = dt
        s["calls"] += 1
        s["jobs"] += B
        s["rows"] += Bp
        s["wall"] += dt
        s["shapes"][(Bp, nq, nr1, nr2)] += 1
        return res

    return scorer
