#!/usr/bin/env python3
"""GPU bring-up check: the decoder's main path end to end on one card.

    python chip_smoke.py [--seed N] [--frames N]
    python chip_smoke.py --four-cards     # the frame-sharded mesh, 4 cards

One process drives the card. Phases, each timed and checked; any failed
comparison or exception ends the run with a nonzero exit code and no result
line:

  1. device check: JAX's first device must be a GPU, else exit 2.
  2. clips: seeded `mcraw.encode` containers with audio — 4096x3072 and
     1920x1080, modern (type 7) and legacy (type 6) codec, in three content
     mixes (12-bit scene, worst case, all 16-bit).
  3. CLI export: `mcraw <clip>` (per frame), `--pipeline` and `--batch` on
     the 12-bit clips; every DNG and the WAV byte-identical to
     `--backend numpy`. Then one warmed `--pipeline` export is the steady
     window: its compilations are counted and must be zero.
  4. library paths against the encoder's source planes, element-exact:
     load_frame_device, decode_batch, decode_batch_iter on a clip that
     switches codec and geometry, make_frame_decoder.
  5. preview: preview_frame_rgba on 4K frames, bilinear and Malvar, within
     1 LSB per channel of preview.develop_f64.
  6. card-only tests (`pytest -m gpu`).
  7. timing: each device kernel at 4K, host time around block_until_ready
     on a warmed program, beside a large copy measured in the same run.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K4 = (3072, 4096)
HD = (1080, 1920)
HBM_PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(Exception):
    """A comparison that did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# -- clips --------------------------------------------------------------------


class Clip:
    def __init__(self, name, kind, hw, codec, seeds, path):
        self.name, self.kind, self.hw, self.codec = name, kind, hw, codec
        self.seeds, self.path = seeds, path

    def source(self, i: int) -> np.ndarray:
        from mcraw.encode import synthetic_plane

        return synthetic_plane(self.kind, *self.hw, self.seeds[i])


def build_clips(workdir: Path, seed: int, frames: int,
                only: tuple[str, ...] | None = None) -> dict[str, Clip]:
    """The run's clips (all, or the names in `only`), encoded in parallel
    worker processes."""
    from mcraw import encode as E
    from mcraw.metadata import example_container_metadata
    from mcraw.metadata import example_frame_metadata

    specs = []
    for hw, tag in ((K4, "4k"), (HD, "hd")):
        for kind in E.SYNTHETIC_KINDS:
            for codec in (7, 6):
                seeds = [seed * 1000 + 100 * E.SYNTHETIC_KINDS.index(kind) + i
                         for i in range(frames)]
                name = f"{tag}_{kind}_{codec}"
                if only is None or name in only:
                    specs.append((name, kind, hw, codec, seeds))
    jobs = [(kind, *hw, s, codec)
            for _, kind, hw, codec, seeds in specs for s in seeds]
    payloads = iter(E.encode_synthetic_many(jobs))
    clips = {}
    rng = np.random.default_rng(seed)
    for name, kind, hw, codec, seeds in specs:
        writer = E.ContainerWriter(example_container_metadata())
        for i in range(len(seeds)):
            writer.add_frame(
                1000 + 33 * i, next(payloads),
                example_frame_metadata(hw[1], hw[0], codec),
            )
            writer.add_audio(
                rng.integers(-3000, 3000, 2048).astype(np.int16), i * 10**6
            )
        path = workdir / f"{name}.mcraw"
        path.write_bytes(writer.finish())
        clips[name] = Clip(name, kind, hw, codec, seeds, path)
    return clips


def mixed_clip(clips: dict[str, Clip], workdir: Path):
    """A clip that switches codec and geometry mid-stream, reusing encoded
    payloads; returns (path, [(clip, frame index), ...])."""
    from mcraw import encode as E
    from mcraw.container import ContainerReader
    from mcraw.metadata import example_container_metadata

    order = [("4k_mix12_7", 0), ("4k_mix12_7", 1), ("4k_mix12_6", 2),
             ("hd_mix12_7", 3), ("hd_mix12_7", 4), ("hd_mix12_6", 5),
             ("hd_mix12_6", 6), ("4k_mix12_7", 7)]
    writer = E.ContainerWriter(example_container_metadata())
    for t, (name, i) in enumerate(order):
        r = ContainerReader(str(clips[name].path))
        payload, meta = r.frame_payload(r.frames[i])
        writer.add_frame(5000 + t, bytes(payload), meta)
        r.close()
    path = workdir / "mixed.mcraw"
    path.write_bytes(writer.finish())
    return path, [(clips[n], i) for n, i in order]


# -- compile counting --------------------------------------------------------


class CompileCounter:
    """Counts XLA backend compilations (JAX's monitoring event)."""

    def __init__(self):
        import jax
        from jax._src.dispatch import BACKEND_COMPILE_EVENT

        self.n = 0
        self._event = BACKEND_COMPILE_EVENT

        def on_event(event, duration, **kw):
            if event == self._event:
                self.n += 1

        jax.monitoring.register_event_duration_secs_listener(on_event)


# -- phases ------------------------------------------------------------------


def run_cli(argv: list[str]) -> None:
    """`mcraw <argv>` in this process, its per-frame lines swallowed."""
    from mcraw.cli import main as cli_main

    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(argv)
    if rc != 0:
        raise Failure(f"mcraw {' '.join(argv)} exited {rc}")


def same_tree(a: Path, b: Path) -> int:
    names = sorted(os.listdir(a))
    check(names == sorted(os.listdir(b)), f"file sets differ: {a} vs {b}")
    for n in names:
        check(filecmp.cmp(a / n, b / n, shallow=False), f"{b / n} differs")
    return len(names)


def phase_cli(clips, workdir: Path, counter: CompileCounter) -> None:
    """Byte-identical CLI exports, then the steady export window."""
    for name in ("4k_mix12_7", "4k_mix12_6", "hd_mix12_7", "hd_mix12_6"):
        clip = str(clips[name].path)
        ref = workdir / f"{name}_numpy"
        run_cli(["decode", clip, "--backend", "numpy", "--output-dir", str(ref)])
        for mode, argv in (
            ("per-frame", [clip]),
            ("pipeline", ["decode", clip, "--pipeline"]),
            ("batch", ["decode", clip, "--batch"]),
        ):
            dst = workdir / f"{name}_{mode}"
            t0 = time.perf_counter()
            run_cli(argv + ["--output-dir", str(dst)])
            dt = time.perf_counter() - t0
            n = same_tree(ref, dst)
            log(f"  cli {name} {mode}: {n} files byte-identical to "
                f"--backend numpy ({dt:.2f} s)")
            shutil.rmtree(dst)
        shutil.rmtree(ref)

    # Steady window: the warmed pipeline export of the 4K modern clip.
    clip = clips["4k_mix12_7"]
    dst = workdir / "steady"
    before = counter.n
    t0 = time.perf_counter()
    run_cli(["decode", str(clip.path), "--pipeline", "--output-dir", str(dst)])
    dt = time.perf_counter() - t0
    compiles = counter.n - before
    shutil.rmtree(dst)
    nframes = len(clip.seeds)
    log(f"  steady --pipeline export, 4K modern: {nframes} frames in "
        f"{dt:.3f} s = {nframes / dt:.2f} frames/s (DNG+WAV on disk); "
        f"compilations in window: {compiles}")
    check(compiles == 0, f"{compiles} compilations in the steady window")


def phase_library(clips, workdir: Path) -> None:
    from mcraw.kernels import numpy_ref as R
    from mcraw.pipeline import Decoder

    for clip in clips.values():
        d = Decoder(str(clip.path), backend="jax")
        src = [clip.source(i) for i in range(len(clip.seeds))]
        for i, ts in enumerate(d.frames):
            img, _ = d.load_frame_device(ts)
            check(np.array_equal(np.asarray(img), src[i]),
                  f"load_frame_device {clip.name} frame {i}")
        payload, _ = d._reader.frame_payload(d.frames[0])
        oracle = (R.decode_modern if clip.codec == 7 else R.decode_legacy)(
            np.asarray(payload), clip.hw[1], clip.hw[0]
        )
        check(np.array_equal(oracle, src[0]), f"numpy_ref {clip.name}")
        nb = min(8, len(d.frames))
        imgs, _ = d.decode_batch(d.frames[:nb])
        check(np.array_equal(np.asarray(imgs), np.stack(src[:nb])),
              f"decode_batch {clip.name}")
        fd = d.make_frame_decoder()
        for i, ts in enumerate(d.frames):
            check(np.array_equal(np.asarray(fd(ts)[0]), src[i]),
                  f"make_frame_decoder {clip.name} frame {i}")
        log(f"  {clip.name}: load_frame_device x{len(src)}, numpy_ref, "
            f"decode_batch x{nb}, frame decoder x{len(src)} "
            f"({fd.num_programs} program(s)) element-exact")
        d.close()

    path, order = mixed_clip(clips, workdir)
    d = Decoder(str(path), backend="jax")
    k = 0
    runs = 0
    for imgs, metas in d.decode_batch_iter(chunk_frames=4):
        runs += 1
        arr = np.asarray(imgs)
        for j in range(arr.shape[0]):
            clip, i = order[k]
            check(np.array_equal(arr[j], clip.source(i)),
                  f"decode_batch_iter mixed frame {k}")
            k += 1
    check(k == len(order), "decode_batch_iter lost frames")
    d.close()
    log(f"  decode_batch_iter on a clip switching codec and geometry: "
        f"{k} frames in {runs} homogeneous runs element-exact")


def phase_preview(clips) -> None:
    from mcraw import preview as P
    from mcraw.metadata import ContainerMetadata, FrameMetadata
    from mcraw.pipeline import Decoder

    for name in ("4k_mix12_7", "4k_mix12_6"):
        clip = clips[name]
        d = Decoder(str(clip.path), backend="jax")
        cm = ContainerMetadata(d.container_metadata)
        fm = FrameMetadata(d._reader.frame_payload(d.frames[0])[1])
        black, white, neutral, fwd = P._frame_params(fm, cm)
        src = clip.source(0)
        for dem in ("bilinear", "malvar"):
            t0 = time.perf_counter()
            rgba = np.asarray(
                P.preview_frame_rgba(d, d.frames[0], demosaic=dem)
            ).astype(np.int64)
            dt = time.perf_counter() - t0
            got = np.stack(
                [rgba & 0xFF, (rgba >> 8) & 0xFF, (rgba >> 16) & 0xFF], -1
            )
            want = P.develop_f64(src, black, white, neutral, fwd,
                                 tuple(cm.cfa_pattern), demosaic=dem)
            err = int(np.abs(got - want).max())
            frac = float(np.mean(np.abs(got - want) > 0))
            log(f"  preview {name} {dem}: max |err| {err} LSB vs "
                f"develop_f64 ({frac:.2e} of channels off by 1), "
                f"first call {dt:.2f} s")
            check(err <= 1, f"preview {name} {dem}: {err} LSB")
            check(int(((rgba >> 24) & 0xFF).min()) == 255, "alpha != 255")
        d.close()


class _Tally:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_card_tests() -> None:
    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda"  # conftest: do not force the CPU
    tally = _Tally()
    rc = pytest.main(
        [str(REPO / "tests" / "test_gpu.py"), "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        plugins=[tally],
    )
    log(f"  pytest -m gpu: {tally.passed} passed, {tally.failed} failed, "
        f"{tally.skipped} skipped (rc {rc})")
    check(rc == 0 and tally.passed > 0 and tally.failed == 0
          and tally.skipped == 0, "card-only tests")


def _median_time(fn, n: int = 20) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _cold_compile(jitted, args):
    """(compiled, seconds) for one program with the persistent compile
    cache switched off, so the time is a real compilation."""
    import jax

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        t0 = time.perf_counter()
        compiled = jitted.lower(*args).compile()
        return compiled, time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_compilation_cache", was)


def phase_timing(clips, card: str) -> None:
    """Each plain-XLA kernel at 4K, warmed, beside a large copy."""
    import jax
    import jax.numpy as jnp

    from mcraw import preview as P
    from mcraw.container import ContainerReader
    from mcraw.kernels import unpack as U
    from mcraw.kernels.checksum import device_checksum

    h, w = K4
    copy_src = jnp.zeros((1 << 28,), jnp.uint32)  # 1 GiB
    copy = jax.jit(lambda a: a + jnp.uint32(1))
    t = _median_time(lambda: copy(copy_src))
    copy_rate = 2 * copy_src.nbytes / t
    log(f"  large copy (1 GiB read + 1 GiB write): {t * 1e3:.3f} ms = "
        f"{copy_rate / 1e9:.1f} GB/s, {copy_rate / HBM_PEAK_BYTES_PER_S:.3f} "
        f"of 3.35 TB/s [{card}]")
    del copy_src

    def rate(name, fn, nbytes):
        t = _median_time(fn)
        log(f"  kernel {name} 4K: {t * 1e3:.3f} ms/frame, "
            f"{nbytes / t / 1e9:.1f} GB/s = "
            f"{nbytes / t / HBM_PEAK_BYTES_PER_S:.4f} of 3.35 TB/s, "
            f"{nbytes / t / copy_rate:.4f} of the copy [{card}]")

    imgs = {}
    for name, codec in (("4k_mix12_7", 7), ("4k_mix12_6", 6)):
        r = ContainerReader(str(clips[name].path))
        payload, _ = r.frame_payload(r.frames[0])
        prep = U.prepare_modern if codec == 7 else U.prepare_legacy
        plan = prep(np.asarray(payload), w, h)
        fn, kw = U.device_decoder(plan), U.geometry_kwargs(plan)
        r.close()
        args = [jax.device_put(a) for a in
                (plan.payload, plan.offsets, plan.cls, plan.refs)]
        compiled, dt = _cold_compile(
            jax.jit(functools.partial(fn.__wrapped__, **kw)), args
        )
        log(f"  decode type {codec} 4K compile (persistent cache off): "
            f"{dt:.2f} s; memory_analysis: {compiled.memory_analysis()}")
        rate(f"decode type {codec}", lambda: fn(*args, **kw),
             sum(a.nbytes for a in args) + 2 * h * w)
        imgs[codec] = fn(*args, **kw)

    checksum = jax.jit(device_checksum)
    rate("checksum", lambda: checksum(imgs[7]), 2 * h * w)

    black = jnp.asarray(np.zeros(4, np.float32))
    white = jnp.float32(4095.0)
    neutral = jnp.asarray(np.array([0.55, 1.0, 0.71], np.float32))
    fwd = jnp.asarray(np.diag([0.9642, 1.0, 0.8249]).astype(np.float32))
    for dem in ("bilinear", "malvar"):
        _, dt = _cold_compile(
            jax.jit(functools.partial(
                P.develop_rgba.__wrapped__, height=h, width=w,
                cfa=(0, 1, 1, 2), demosaic=dem)),
            (imgs[7], black, white, neutral, fwd),
        )
        log(f"  develop {dem} 4K compile (persistent cache off): {dt:.2f} s")
        rate(f"develop {dem}", lambda: P.develop_rgba(
            imgs[7], black, white, neutral, fwd, height=h, width=w,
            cfa=(0, 1, 1, 2), demosaic=dem), 2 * h * w + 4 * h * w)


def phase_four_cards(clips) -> None:
    """Frame-parallel decode over Mesh(devices[:4], ("frames",))."""
    import jax
    from jax.sharding import Mesh

    from mcraw.parallel import decode_clips
    from mcraw.pipeline import Decoder

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    mesh = Mesh(np.array(jax.devices()[:4]), ("frames",))
    for name in ("4k_mix12_7", "4k_mix12_6"):
        clip = clips[name]
        d = Decoder(str(clip.path), backend="jax")
        one, _ = d.decode_batch()
        one = np.asarray(one)
        out, _ = d.decode_batch(mesh=mesh)
        check(len(out.sharding.device_set) == 4, f"{name}: not on 4 devices")
        got = np.asarray(out)
        for i in range(len(clip.seeds)):
            check(np.array_equal(got[i], clip.source(i)), f"{name} frame {i}")
        check(np.array_equal(got, one), f"{name}: mesh != one card")
        n = 0
        for imgs, _ in d.decode_batch_iter(chunk_frames=8, mesh=mesh):
            check(len(imgs.sharding.device_set) == 4, "iter not on 4 devices")
            arr = np.asarray(imgs)
            for j in range(arr.shape[0]):
                check(np.array_equal(arr[j], one[n]), f"{name} iter {n}")
                n += 1
        log(f"  {name}: decode_batch and decode_batch_iter over 4 cards, "
            f"{len(clip.seeds)} frames element-exact vs one card and the "
            f"source; output on {len(out.sharding.device_set)} devices")
        d.close()

    # decode_clips needs one geometry: four views of the 4K clip's frames.
    decs = [Decoder(str(clips["4k_mix12_7"].path), backend="jax")
            for _ in range(4)]
    out, _ = decode_clips(decs, mesh=mesh, frames_per_clip=4)
    check(len(out.sharding.device_set) == 4, "decode_clips not on 4 devices")
    got = np.asarray(out)
    src = [clips["4k_mix12_7"].source(i) for i in range(4)]
    for c in range(4):
        for f in range(4):
            check(np.array_equal(got[c, f], src[f]), f"decode_clips {c},{f}")
    log(f"  decode_clips: 4 clips x 4 frames over 4 cards element-exact; "
        f"output on {len(out.sharding.device_set)} devices")


# -- main --------------------------------------------------------------------


def card_name_and_limit() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=16,
                    help="frames per clip (at least 16)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the frame-sharded mesh over 4 cards")
    args = ap.parse_args(argv)

    import jax

    from mcraw.device import enable_compile_cache, platform_info

    try:
        platform, kind, count = platform_info()
    except RuntimeError as e:
        log(f"FAIL device check: {e}")
        return 2
    if platform != "gpu":
        log(f"FAIL device check: JAX platform is {platform!r}, not a GPU")
        return 2

    card = card_name_and_limit()
    log(f"card (nvidia-smi name, power.limit): {card}")
    card = card.splitlines()[0]
    log(f"jax {jax.__version__}: {count} x {kind}")

    from mcraw.kernels import native

    log(f"compile cache: {enable_compile_cache()}")
    log(f"host scanner: {'native C++' if native.have_native() else 'NumPy'}")
    counter = CompileCounter()

    if args.four_cards:
        only = ("4k_mix12_7", "4k_mix12_6")
        phases = [("four cards", lambda: phase_four_cards(clips))]
    else:
        only = None
        phases = [
            ("cli export", lambda: phase_cli(clips, workdir, counter)),
            ("library paths", lambda: phase_library(clips, workdir)),
            ("preview", lambda: phase_preview(clips)),
            ("card-only tests", phase_card_tests),
            ("kernel timing", lambda: phase_timing(clips, card)),
        ]
    with tempfile.TemporaryDirectory(prefix="mcraw_smoke_") as tmp:
        workdir = Path(tmp)
        try:
            t0 = time.perf_counter()
            clips = build_clips(workdir, args.seed, max(16, args.frames), only)
            log(f"phase build clips: {len(clips)} clips, "
                f"{sum(len(c.seeds) for c in clips.values())} frames "
                f"({time.perf_counter() - t0:.1f} s) ok")
            for name, run in phases:
                t0 = time.perf_counter()
                log(f"phase {name}:")
                run()
                peak = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                        for d in jax.local_devices()]
                log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s; "
                    f"peak_bytes_in_use so far {peak})")
        except Exception as e:  # report which phase failed, then fail
            traceback.print_exc(file=sys.stdout)
            log(f"FAIL {type(e).__name__}: {e}")
            return 1

    for dev in jax.devices()[: 4 if args.four_cards else 1]:
        stats = dev.memory_stats() or {}
        log(f"peak_bytes_in_use {dev.id}: {stats.get('peak_bytes_in_use')}")
    log(f"compilations in the whole run: {counter.n}")
    log(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
