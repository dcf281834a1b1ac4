"""Which accelerator is present, and what of phase 2 runs on it.

The one place that looks at the JAX platform. Contig jump scoring is
the only hot-path job the device takes (split-read scans stay on the
host unless asked for): on a GPU the hand-written CUDA jump kernel
serves it, on the CPU backend the plain XLA forms run when routing is
forced, and any other platform is an error.

Opening a JAX backend reserves the accelerator for this process, and a
process forked from one that holds a GPU client cannot use the device.
So nothing here is called before the last fork: the workflow resolves
the route at the start of phase 2, in the process that will own the
card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

ROUTED_MODES = ("jump", "exact", "mxu")

# <checkout>/.jax_cache: one fixed, git-ignored path, so later runs
# find what earlier ones compiled
_DEFAULT_CACHE = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", ".jax_cache"))


@dataclass(frozen=True)
class DeviceRoute:
    """mode None = host-native phase 2; otherwise 'jump' (contig jump
    scoring on the device), 'exact' or 'mxu' (split-read scans too)."""
    mode: str | None
    reason: str
    platform: str | None = None
    device_kind: str | None = None
    jump_kernel: str | None = None

    def describe(self) -> str:
        where = "host-native" if self.mode is None else \
            f"device '{self.mode}' (jump kernel: {self.jump_kernel})"
        dev = "" if self.platform is None else \
            f"; JAX device: platform={self.platform} kind={self.device_kind}"
        return f"phase-2 scoring route: {where} — {self.reason}{dev}"


def jump_kernel_for(platform: str) -> str:
    """The contig jump-score kernel that serves a JAX platform."""
    if platform == "gpu":
        return "cuda"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(
        f"unsupported JAX platform {platform!r}: device scoring runs on "
        "an NVIDIA GPU ('gpu') or, when forced, the CPU backend ('cpu')")


def configure_compile_cache():
    """Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX
    reads it itself), else <checkout>/.jax_cache. Every compiled
    program is kept, however fast it compiled."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


def probe() -> tuple[str, str, int]:
    """Open the default JAX backend: (platform, device_kind, count)."""
    configure_compile_cache()
    import jax
    devs = jax.devices()
    return devs[0].platform, devs[0].device_kind, len(devs)


def resolve(mode, will_fork: bool = False) -> DeviceRoute:
    """Resolve a --device-scoring request ('auto'|'jump'|'exact'|'mxu'|
    'off', True = 'exact') into a route.

    'auto' takes contig jump scoring to a GPU when there is one, and
    stays host-native on the CPU backend. It also stays host-native
    when phase 2 would fork workers (-j N), since forked workers cannot
    share the card; an explicit mode instead runs phase 2 in the one
    process that owns the device. Only 'off' and that 'auto' case
    leave JAX unopened."""
    if mode in (None, False, "off"):
        return DeviceRoute(None, "device scoring off")
    if mode is True:
        mode = "exact"
    if mode == "auto" and will_fork:
        return DeviceRoute(
            None, "'auto' keeps forked phase-2 workers (-j > 1) on the "
            "host; an explicit --device-scoring mode runs phase 2 in one "
            "process on the device")
    if mode != "auto" and mode not in ROUTED_MODES:
        raise ValueError(f"unknown device-scoring mode {mode!r}")
    platform, kind, _count = probe()
    kernel = jump_kernel_for(platform)
    if mode == "auto":
        if platform == "cpu":
            return DeviceRoute(None, "'auto' found no accelerator",
                               platform, kind)
        return DeviceRoute("jump", "'auto' found a GPU", platform, kind,
                           kernel)
    reason = "requested" if platform == "gpu" else \
        "requested; no accelerator, so the XLA forms run on the CPU backend"
    return DeviceRoute(mode, reason, platform, kind, kernel)
