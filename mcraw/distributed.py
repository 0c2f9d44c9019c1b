"""Multi-host clip decode over DCN via ``jax.distributed`` (SURVEY.md §5).

The reference is a single-threaded file decoder; its multi-host analogue is
clip sharding: every host opens the same container (the EOF index gives O(1)
random access, Decoder.cpp:237-264), decodes a disjoint contiguous frame
range, and writes its slice of the output sequence. Frames are independent,
so DCN carries no decode data — only ``jax.distributed`` control traffic and
whatever cross-host reductions the caller asks for (e.g. clip statistics).

Two tiers:

- :func:`export_clip_distributed` — per-host frame ranges, zero cross-host
  communication; the throughput-scaling path (hosts x chips x fps).
- :func:`decode_batch_global_mesh` — one jit program over the GLOBAL device
  mesh, inputs assembled with ``jax.make_array_from_process_local_data``;
  demonstrates the framework's decode composing with global-mesh consumers
  (e.g. a training input pipeline that immediately reduces over DCN).

Validated by tests/test_distributed.py: two real processes, a coordinator,
and a global 2x4-device CPU mesh (the standard JAX multi-process recipe —
the same code path drives multi-host GPU clusters).
"""

from __future__ import annotations

import numpy as np


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
) -> None:
    """Join the distributed runtime. Call before any other JAX use.

    Pass all three explicitly: nothing on a plain GPU or CPU cluster
    tells JAX the coordinator, so ``initialize()`` without them fails.
    """
    import jax

    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def frame_shard(
    frames: list[int],
    process_index: int | None = None,
    process_count: int | None = None,
) -> tuple[list[int], int]:
    """This host's contiguous slice of the clip: (timestamps, first_index).

    Contiguous (not round-robin) so each host streams a sequential byte
    range of the file — the kindest pattern for page cache and NFS.
    """
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    n = len(frames)
    lo = pi * n // pc
    hi = (pi + 1) * n // pc
    return frames[lo:hi], lo


def export_clip_distributed(
    decoder, output_dir: str, resume: bool = False, **kw
):
    """Whole-clip DNG export sharded across hosts (no cross-host comms).

    Every process must see the same container and a shared (or per-host)
    output_dir; file numbering is globally consistent via first_index.
    Returns this host's ExportStats.
    """
    from .clip import export_clip

    mine, first = frame_shard(decoder.frames)
    return export_clip(
        decoder,
        output_dir,
        timestamps=mine,
        resume=resume,
        first_index=first,
        **kw,
    )


def decode_batch_global_mesh(decoder, timestamps: list[int], mesh):
    """Decode frames into ONE globally-sharded (F, H, W) array.

    Each process prepares and contributes only the frames that live on its
    addressable devices (``make_array_from_process_local_data``); the jitted
    decode then runs SPMD over the global mesh. The result is a global jax
    Array — consumers may reduce over it (DCN collectives) or read local
    shards via ``addressable_shards``.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .parallel import batched_decoder, stack_plans

    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    f = len(timestamps)
    if f % mesh.devices.size != 0:
        raise ValueError(
            f"batch of {f} not divisible by {mesh.devices.size} devices"
        )
    # Each process contributes a CONTIGUOUS timestamp slice, which is only
    # correct if the mesh's device order is process-major (e.g.
    # Mesh(np.array(jax.devices()), ...)). Topology-reordered meshes
    # (mesh_utils.create_device_mesh) interleave processes and would
    # silently misplace frames — reject them.
    proc_order = [d.process_index for d in mesh.devices.flat]
    if proc_order != sorted(proc_order):
        raise ValueError(
            "mesh devices must be process-major (contiguous per process); "
            "build it from jax.devices() order"
        )

    # This process's frame rows (contiguous: mesh axis is process-major).
    pi, pc = jax.process_index(), jax.process_count()
    lo, hi = pi * f // pc, (pi + 1) * f // pc
    plans, metas, moderns = [], [], []
    for ts in timestamps[lo:hi]:
        plan, meta, modern = decoder._plan(ts)
        plans.append(plan)
        metas.append(meta)
        moderns.append(modern)
    if len(set(moderns)) != 1:
        raise ValueError("mixed codecs in one batch")
    payloads, offsets, cls, refs = stack_plans(plans)

    # Local payload widths can differ across processes; fix a global width.
    max_len_local = payloads.shape[1]
    from jax.experimental import multihost_utils

    max_len = int(
        multihost_utils.process_allgather(np.int64(max_len_local)).max()
    )
    if max_len != max_len_local:
        payloads = np.pad(payloads, ((0, 0), (0, max_len - max_len_local)))

    def globalize(a):
        return jax.make_array_from_process_local_data(sharding, a)

    args = tuple(map(globalize, (payloads, offsets, cls, refs)))
    fn = batched_decoder(plans[0])
    return fn(*args), metas
