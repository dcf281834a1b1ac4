"""Hand-written CUDA jump-SWG score kernel (native/jump_score.cu).

The GPU counterpart of device_jumpscore.batched_jump_score, with the
same signature and bit-exact int32 scores. The kernel walks reference
columns inside one warp per job with the query rows striped over the
lanes (see the .cu file), where the XLA form runs a lax.scan whose
every column is a round of separate device kernels over state held in
device memory.

The shared library is built from the committed source with nvcc at
first use (atomically, so concurrent first users cannot see a partial
file) into native/build/, and registered as an XLA FFI target.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_SRC = os.path.join(_NATIVE_DIR, "jump_score.cu")
_SO = os.path.join(_NATIVE_DIR, "build", "libmanta_jump_score.so")
_TARGET = "manta_jump_score"
_REGISTERED = False


def rows_per_lane(nq_pad: int) -> int:
    """Query rows each of the 32 lanes owns (the kernel's template
    parameter K): one band of 32*K rows covers every query up to 512
    rows; taller queries run as several bands of 512."""
    if nq_pad <= 128:
        return 4
    if nq_pad <= 256:
        return 8
    return 16


def scratch_shape(B: int, nq_pad: int, nr1_pad: int,
                  nr2_pad: int) -> tuple:
    """Band hand-off buffer: for every job, two ping-pong rows of
    (M, D, I, J) per reference column; a placeholder when one band
    covers the query."""
    if nq_pad <= 32 * rows_per_lane(nq_pad):
        return (1,)
    return (B, 2, nr1_pad + nr2_pad, 4)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library() -> str:
    """Compile native/jump_score.cu for sm_90a unless the library is
    newer than its source; returns the library path."""
    if os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


def _register():
    global _REGISTERED
    if _REGISTERED:
        return
    lib = ctypes.CDLL(build_library())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.MantaJumpScore), platform="CUDA")
    _REGISTERED = True


@partial(jax.jit, static_argnames=("match", "mismatch", "open_", "extend",
                                   "off_edge", "jump_score"))
def _call(query, query_len, ref1, ref1_len, ref2, ref2_len, *, match,
          mismatch, open_, extend, off_edge, jump_score):
    B, nq_pad = query.shape
    out_types = (
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct(
            scratch_shape(B, nq_pad, ref1.shape[1], ref2.shape[1]),
            jnp.int32))
    scores, _ = jax.ffi.ffi_call(_TARGET, out_types)(
        query, query_len, ref1, ref1_len, ref2, ref2_len,
        match=np.int32(match), mismatch=np.int32(mismatch),
        open=np.int32(open_), extend=np.int32(extend),
        off_edge=np.int32(off_edge), jump=np.int32(jump_score),
        rows_per_lane=np.int32(rows_per_lane(nq_pad)))
    return scores


def cuda_jump_score(query, query_len, ref1, ref1_len, ref2, ref2_len,
                    match, mismatch, open_, extend, off_edge, jump_score,
                    nq_pad: int, nr1_pad: int, nr2_pad: int):
    """Max jump-alignment score per batch row (int32, exact); same
    contract as device_jumpscore.batched_jump_score. The padded widths
    are the arrays' own and are accepted for signature parity."""
    assert query.shape[1] == nq_pad and ref1.shape[1] == nr1_pad \
        and ref2.shape[1] == nr2_pad
    _register()
    return _call(query, query_len, ref1, ref1_len, ref2, ref2_len,
                 match=int(match), mismatch=int(mismatch),
                 open_=int(open_), extend=int(extend),
                 off_edge=int(off_edge), jump_score=int(jump_score))
