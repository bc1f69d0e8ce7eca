"""Where the device modes run, and where their compiled programs go.

`check_platform` reports the platform a device mode landed on and
refuses the CPU unless it was asked for (JAX_PLATFORMS=cpu), so a run
that meant to use the accelerator never falls back silently.

`ensure_compile_cache` points JAX's persistent compilation cache at
$JAX_COMPILATION_CACHE_DIR, or at `.jax_cache` in the checkout when
that is unset: compiled executables are keyed by HLO and reused by
every later process, so a CLI run does not re-pay compiles an earlier
run already made.  The path is fixed because it is part of the key.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def ensure_compile_cache() -> str:
    """Set JAX's persistent compilation cache directory; returns it."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache every compile that takes noticeable time, not only the
    # >1 s default: small-shape CLI runs benefit too
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path


def check_platform(mode: str) -> Optional[str]:
    """Print the platform, device kind and device count `mode` runs on
    (one stderr line).  Returns an error message when it landed on the
    CPU without JAX_PLATFORMS=cpu, else None."""
    import jax
    devs = jax.devices()
    d = devs[0]
    print(f"# {mode}: platform={d.platform} device_kind={d.device_kind} "
          f"count={len(devs)}", file=sys.stderr)
    if d.platform == "cpu" and \
            os.environ.get("JAX_PLATFORMS", "").strip() != "cpu":
        return (f"{mode}: no accelerator found (JAX platform "
                f"{d.platform!r}); set JAX_PLATFORMS=cpu to run on the "
                f"CPU on purpose")
    return None
