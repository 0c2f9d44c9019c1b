"""Device-side mod-2^32 checksum of an integer array.

Benchmarks and chip checks fold a decoded frame into one uint32 on the
device, which keeps the output live and verifies it without copying the
frame to the host.
"""

from __future__ import annotations

import jax.numpy as jnp


def device_checksum(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 wrap-around sum; equals
    ``int(np.asarray(x).astype(np.int64).sum() & 0xFFFFFFFF)``."""
    return x.astype(jnp.uint32).sum(dtype=jnp.uint32)
