"""Multi-frame / multi-chip decode: batching, vmap, and shard_map.

The decode workload is embarrassingly frame-parallel (the EOF index gives
O(1) random access to every frame, Decoder.cpp:237-264), so the natural
device mapping is frame data-parallelism: stack per-frame device inputs
along a batch axis, vmap the single-frame decode, and shard the batch axis
across a ``jax.sharding.Mesh`` — XLA then runs each frame's unpack on its
own device with zero cross-device communication until (optional)
gather-for-output. Every device reaches every other at the same rate, so the
mesh follows the frame axis alone.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .kernels import unpack as U


def stack_plans(plans: list):
    """Pad + stack per-frame plans into batch arrays.

    Payload lengths vary per frame; each plan's payload already sits on a
    rung of the geometry's bucket ladder (unpack.payload_bucket), and the
    batch pads to the largest rung present, so the batched program keys on
    a ladder rung too (the per-block offsets make the padding bytes
    unreachable). Block counts are identical for same-geometry frames.
    """
    if len({tuple(U.geometry_kwargs(p).items()) for p in plans}) != 1:
        raise ValueError("all frames in a batch must share geometry")

    max_len = max(len(p.payload) for p in plans)
    payloads = np.zeros((len(plans), max_len), dtype=np.uint8)
    for i, p in enumerate(plans):
        payloads[i, : len(p.payload)] = p.payload
    offsets = np.stack([p.offsets for p in plans])
    cls = np.stack([p.cls for p in plans])
    refs = np.stack([p.refs for p in plans])
    return payloads, offsets, cls, refs


# One jitted program per geometry: a fresh jit(vmap(...)) per call would
# retrace and recompile every batch.
@functools.lru_cache(maxsize=16)
def _batched(decode, geometry: tuple):
    return jax.jit(jax.vmap(functools.partial(decode, **dict(geometry))))


def batched_decoder(plan):
    """Jitted (F, ...) -> (F, H, W) decode function for the plan's codec
    and geometry."""
    return _batched(
        U.device_decoder(plan).__wrapped__,
        tuple(U.geometry_kwargs(plan).items()),
    )


def decode_frames_batched(plans: list, mesh: Mesh | None = None):
    """Decode a batch of same-geometry frames in one device program.

    With a mesh, inputs are frame-batch sharded over the first mesh axis
    (SPMD, no collectives — frames are independent).
    """
    payloads, offsets, cls, refs = stack_plans(plans)
    fn = batched_decoder(plans[0])

    if mesh is not None:
        axis = mesh.axis_names[0]
        n = mesh.devices.size
        if len(plans) % n != 0:
            raise ValueError(f"batch of {len(plans)} not divisible by {n} devices")
        sharding = NamedSharding(mesh, P(axis))
        args = [
            jax.device_put(a, sharding) for a in (payloads, offsets, cls, refs)
        ]
        return fn(*args)

    return fn(
        jnp.asarray(payloads), jnp.asarray(offsets), jnp.asarray(cls), jnp.asarray(refs)
    )


def default_mesh(axis: str = "frames") -> Mesh:
    devices = np.array(jax.devices())
    return Mesh(devices, (axis,))


def decode_clips(decoders: list, mesh: Mesh | None = None, frames_per_clip=None):
    """Concurrent multi-clip decode (BASELINE config 4): interleave frames
    from several same-geometry clips into one frame-sharded batch.

    Returns (imgs (C, F, H, W) device array, metas [C][F]). Clips must share
    frame geometry and codec; frames are round-robin interleaved so each
    chip gets a mix of clips (uniform load even if clips differ in content).
    """
    all_plans, all_metas, moderns = [], [], []
    for d in decoders:
        ts = d.frames if frames_per_clip is None else d.frames[:frames_per_clip]
        plans, metas = [], []
        for t in ts:
            plan, meta, modern = d._plan(t)
            plans.append(plan)
            metas.append(meta)
            moderns.append(modern)
        all_plans.append(plans)
        all_metas.append(metas)
    if len({len(p) for p in all_plans}) != 1:
        raise ValueError("clips must contribute equal frame counts")
    if len(set(moderns)) != 1:
        raise ValueError("mixed codecs across clips")

    c, f = len(all_plans), len(all_plans[0])
    # round-robin interleave: batch index = frame*C + clip
    flat = [all_plans[ci][fi] for fi in range(f) for ci in range(c)]
    imgs = decode_frames_batched(flat, mesh=mesh)
    h, w = imgs.shape[1], imgs.shape[2]
    imgs = imgs.reshape(f, c, h, w).transpose(1, 0, 2, 3)
    return imgs, all_metas
