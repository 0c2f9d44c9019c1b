"""Whole-clip export: streaming, overlapped, resumable (BASELINE configs 2/4).

The decode pipeline has three stages with different resources:
  1. host parse + metadata-stream scan (CPU; native C++ scanner),
  2. host-to-device transfer + device unpack,
  3. DNG serialization + file write (CPU).
Stage 2 is asynchronous under JAX's dispatch, so a simple software pipeline —
prepare frame i+k while the device decodes frame i and the writer drains
frame i-1 — overlaps all three without threads for the device part; host-side
prep and writes run in small thread pools.

Per-frame error isolation (SURVEY.md §5): one corrupt frame is reported and
skipped, not fatal to the batch. Resume: frames whose DNG already exists are
skipped (the EOF index makes random access O(1), Decoder.cpp:237-264).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .emit.dng import dng_bytes
from .errors import MotionCamException
from .observe import StageTimer, Throughput, log_event
from .pipeline import Decoder
from .util import outpath as _outpath


@dataclass
class ExportStats:
    frames_done: int = 0
    frames_skipped: int = 0
    frames_failed: int = 0
    errors: list = field(default_factory=list)
    wall_seconds: float = 0.0
    stage_timing: dict = field(default_factory=dict)
    throughput: dict = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames_done / self.wall_seconds if self.wall_seconds else 0.0


def export_clip(
    decoder: Decoder,
    output_dir: str,
    timestamps: list[int] | None = None,
    resume: bool = False,
    prefetch: int = 4,
    writers: int = 4,
    progress=None,
    first_index: int = 0,
) -> ExportStats:
    """Export frames to frame_NNNNNN.dng with a prepare/decode/write pipeline.

    first_index offsets the output numbering — multi-host clip sharding
    gives each process a contiguous timestamp range plus its global start
    index so shards assemble into one sequence (mcraw/distributed.py).
    """
    os.makedirs(output_dir, exist_ok=True)
    if timestamps is None:
        timestamps = decoder.frames
    container_meta = decoder.container_metadata

    stats = ExportStats()
    stats_lock = threading.Lock()  # write() runs on up to `writers` threads
    timer = StageTimer()
    thr = Throughput()
    if decoder.timer is None:
        decoder.timer = timer  # parse/unpack stages attribute here
    t0 = time.perf_counter()
    log_event(
        "export_clip_start",
        output_dir=output_dir,
        frames=len(timestamps),
        backend=decoder.backend,
    )

    todo: list[tuple[int, int, str]] = []
    for i, ts in enumerate(timestamps, start=first_index):
        path = _outpath(output_dir, f"frame_{i:06d}.dng")
        if resume and os.path.exists(path):
            stats.frames_skipped += 1
            continue
        todo.append((i, ts, path))

    def prepare(item):
        i, ts, path = item
        try:
            if decoder.backend == "jax":
                img, meta = decoder.load_frame_device(ts)
            else:
                img, meta = decoder.load_frame(ts)
            return (i, ts, path, img, meta, None)
        except MotionCamException as e:
            return (i, ts, path, None, None, e)

    def write(item):
        i, ts, path, img, meta, err = item
        if err is not None:
            with stats_lock:
                stats.frames_failed += 1
                stats.errors.append((ts, str(err)))
            return
        with timer.stage("emit"):
            arr = np.asarray(img)  # D2H sync happens here, off the main thread
            blob = dng_bytes(arr, meta, container_meta)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        with stats_lock:
            stats.frames_done += 1
            thr.add(frames=1, in_bytes=arr.nbytes, out_bytes=len(blob))
        if progress is not None:
            progress(i, path)

    try:
        with ThreadPoolExecutor(max_workers=max(1, prefetch)) as prep_pool, \
                ThreadPoolExecutor(max_workers=max(1, writers)) as write_pool:
            prepared = prep_pool.map(prepare, todo)
            list(write_pool.map(write, prepared))
    finally:
        if decoder.timer is timer:
            decoder.timer = None

    stats.wall_seconds = time.perf_counter() - t0
    stats.stage_timing = timer.summary()
    stats.throughput = thr.summary()
    timer.log()
    log_event(
        "export_clip_done",
        frames_done=stats.frames_done,
        frames_failed=stats.frames_failed,
        frames_skipped=stats.frames_skipped,
        wall_seconds=round(stats.wall_seconds, 3),
        **stats.throughput,
    )
    return stats


def export_wav(decoder: Decoder, output_dir: str) -> str:
    from .emit.wav import write_wav

    path = _outpath(output_dir, "audio.wav")
    write_wav(
        path,
        decoder.audio_sample_rate_hz(),
        decoder.num_audio_channels(),
        decoder.load_audio(),
    )
    return path
