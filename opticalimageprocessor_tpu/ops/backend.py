"""Backend policy: the path each device stage takes on a platform.

One table, keyed by JAX's platform name.  ``cpu`` gets the plain path the
tests pin bit for bit; ``gpu`` gets the same plain XLA code with the fast
registration's kx contraction in bfloat16 (float32 accumulation), which
beat both float32 ``Precision.HIGHEST`` and a fused Pallas kernel (since
removed) end to end on the H100 (PERF.md).  Any other platform raises: nothing falls back
in silence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

STAGE_PATHS: dict[str, dict[str, str]] = {
    "cpu": {
        "rrc": "xla",
        "registration_fft": "jnp.fft",
        "band_contraction": "float32",
        "resample": "xla",
    },
    "gpu": {
        "rrc": "xla",
        "registration_fft": "jnp.fft",
        "band_contraction": "bfloat16",
        "resample": "xla",
    },
}


def platform_of(devices=None) -> str:
    """The one platform of ``devices`` (default: JAX's default backend)."""
    if devices is None:
        return jax.default_backend()
    platforms = {d.platform for d in devices}
    if len(platforms) != 1:
        raise ValueError(f"devices span several platforms: {sorted(platforms)}")
    return platforms.pop()


def stage_paths(platform: str | None = None) -> dict[str, str]:
    """Stage -> path on ``platform`` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    try:
        return dict(STAGE_PATHS[platform])
    except KeyError:
        raise RuntimeError(
            f"no device path for platform {platform!r}; "
            f"supported: {', '.join(sorted(STAGE_PATHS))}"
        ) from None


def band_dot_dtype(platform: str | None = None):
    """Operand dtype of the fast registration's kx contraction."""
    return jnp.dtype(stage_paths(platform)["band_contraction"])
