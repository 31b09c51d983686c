"""The one query of which accelerator platform the solver runs on."""

from __future__ import annotations

import jax

SUPPORTED_PLATFORMS = ("cpu", "gpu")


def platform() -> str:
    """"cpu" or "gpu": the platform of JAX's default backend.

    Every hardware-dependent decision reads this one function: which
    precision "auto" resolves to, and whether timed backend probes are
    worth their compiles.  Both platforms have native f64.  Any other
    platform raises — the solver has no code path for it.
    """
    p = jax.default_backend()
    if p not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: the solver runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}")
    return p
