#!/usr/bin/env python3
"""Device decode throughput on one GPU: 4K 12-bit MCRAW, frames/sec.

Prints the platform, device kind and count, and the card's name and power
limit, then ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

- value: device decode throughput (frames/s) for 4096x3072 12-bit
  modern-codec frames already on the device (host prep and the host-to-device
  copy excluded), each frame folded into an on-device checksum.
- vs_baseline: speedup vs the compiled C++ reference decoder (raw::Decode)
  on this host's CPU over the same payloads, when the reference tree is
  present; otherwise vs the north-star floor (30x realtime = 720 fps at
  24 fps content).
- worst_case_fps: full-range noise plus one 5-bit tile; all16_fps: every
  block at 16 bits.
- legacy_fps_4k: legacy codec (type 6) at 4K.
- decode_develop_fps / decode_develop_malvar_fps /
  decode_develop_legacy_fps: RAW payload -> RGBA8888 preview on device
  (decode + develop), bilinear / Malvar-He-Cutler / legacy codec.
- fps_1080p / legacy_fps_1080p: the decode legs at 1920x1080.
- latency_ms_single_frame: one decode dispatch to ready, device-resident
  inputs, median.

Every leg is gated before timing: the device checksum of each frame must
equal the source image's, and each develop leg must sit within 1 LSB per
channel of the float64 model (mcraw.preview.develop_f64) on one frame.
Times are host clock around `block_until_ready` on warmed programs. Without a
GPU the script exits nonzero and prints no result line.
"""

import json
import subprocess
import sys
import time

import numpy as np

H, W = 3072, 4096
FRAMES = 8  # distinct frames per leg
ITERS = 24  # dispatches per timed burst
BURSTS = 5  # best burst is reported


def make_frames(h=H, w=W, content="mix12", codec=7, n=FRAMES):
    from mcraw.encode import encode_synthetic_many, synthetic_plane

    seeds = [11 + k for k in range(n)]
    imgs = [synthetic_plane(content, h, w, s) for s in seeds]
    payloads = encode_synthetic_many(
        [(content, h, w, s, codec) for s in seeds]
    )
    return imgs, [np.frombuffer(p, dtype=np.uint8) for p in payloads]


def _want(img) -> int:
    return int(img.astype(np.int64).sum() & 0xFFFFFFFF)


def _gate_and_time(run, imgs):
    """Check every frame's checksum, then time ITERS dispatches per burst
    (outputs are checksums, so the device work cannot be elided). Returns
    (seconds per frame, single-dispatch latency in seconds)."""
    import jax

    for i, img in enumerate(imgs):
        got = int(jax.block_until_ready(run(i)))
        if got != _want(img):
            raise AssertionError(f"checksum mismatch on frame {i}")
    best = float("inf")
    for _ in range(BURSTS):
        t0 = time.perf_counter()
        outs = [run(i % len(imgs)) for i in range(ITERS)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / ITERS)
        for i, o in enumerate(outs):
            if int(o) != _want(imgs[i % len(imgs)]):
                raise AssertionError("burst checksum mismatch")
    lat = []
    for _ in range(12):
        t0 = time.perf_counter()
        jax.block_until_ready(run(0))
        lat.append(time.perf_counter() - t0)
    return best, float(np.median(lat))


def _decoder(payloads, h, w, codec):
    """(decode fn with geometry bound, per-frame device args)."""
    import functools

    import jax

    from mcraw.kernels import unpack as U

    prep = U.prepare_modern if codec == 7 else U.prepare_legacy
    plans = [prep(p, w, h) for p in payloads]
    fn = functools.partial(
        U.device_decoder(plans[0]).__wrapped__,
        **U.geometry_kwargs(plans[0]),
    )
    args = [
        tuple(jax.device_put(a) for a in (q.payload, q.offsets, q.cls, q.refs))
        for q in plans
    ]
    return fn, args


def bench_decode(imgs, payloads, h=H, w=W, codec=7):
    import jax

    from mcraw.kernels.checksum import device_checksum

    fn, args = _decoder(payloads, h, w, codec)
    step = jax.jit(lambda *a: device_checksum(fn(*a)))
    per_frame, latency = _gate_and_time(lambda i: step(*args[i]), imgs)
    return 1.0 / per_frame, latency


def bench_preview(imgs, payloads, codec=7, demosaic="bilinear"):
    """Payload -> RGBA8888 on device (decode + develop), gated against the
    float64 develop model on frame 0."""
    import jax
    import jax.numpy as jnp

    from mcraw import preview as P
    from mcraw.kernels.checksum import device_checksum

    fn, args = _decoder(payloads, H, W, codec)
    cfa = (0, 1, 1, 2)
    black = np.zeros(4, np.float32)
    neutral = np.array([0.55, 1.0, 0.71], np.float32)
    fwd = np.diag([0.9642, 1.0, 0.8249]).astype(np.float32)
    params = tuple(map(jnp.asarray, (black, np.float32(4095.0), neutral, fwd)))

    def rgba(*a):
        return P.develop_rgba.__wrapped__(
            fn(*a), *params, height=H, width=W, cfa=cfa, demosaic=demosaic
        )

    got = np.asarray(jax.jit(rgba)(*args[0])).astype(np.int64)
    got = np.stack([got & 0xFF, (got >> 8) & 0xFF, (got >> 16) & 0xFF], -1)
    want = P.develop_f64(imgs[0], black, 4095.0, neutral, fwd, cfa,
                         demosaic=demosaic)
    err = int(np.abs(got - want).max())
    if err > 1:
        raise AssertionError(f"develop gate: max |err| {err} > 1 LSB")

    # Gate the decode half per frame, then time the fused program.
    dec = jax.jit(lambda *a: device_checksum(fn(*a)))
    for i, img in enumerate(imgs):
        if int(dec(*args[i])) != _want(img):
            raise AssertionError(f"preview decode gate: frame {i}")
    step = jax.jit(lambda *a: device_checksum(rgba(*a)))
    sums = [int(step(*a)) for a in args]
    best = float("inf")
    for _ in range(BURSTS):
        t0 = time.perf_counter()
        outs = [step(*args[i % len(args)]) for i in range(ITERS)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / ITERS)
        if any(int(o) != sums[i % len(args)] for i, o in enumerate(outs)):
            raise AssertionError("preview burst checksum mismatch")
    return 1.0 / best


def bench_reference_cpu(payloads):
    """Compiled reference decoder fps on this host's CPU, or None when the
    reference tree is absent."""
    from tools import ref_shim

    if ref_shim.get_lib() is None:
        return None
    ref_shim.ref_decode(payloads[0], W, H)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for p in payloads:
            ref_shim.ref_decode(p, W, H)
        best = min(best, (time.perf_counter() - t0) / len(payloads))
    return 1.0 / best


def main() -> int:
    from mcraw.device import enable_compile_cache, platform_info

    platform, kind, count = platform_info()
    print(f"platform {platform}, device_kind {kind}, count {count}")
    if platform != "gpu":
        print("error: no GPU; this benchmark measures the card only",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {card}")
    print(f"compile cache: {enable_compile_cache()}")

    imgs, payloads = make_frames()
    fps, latency = bench_decode(imgs, payloads)
    payload_bytes = sum(len(p) for p in payloads) / len(payloads)
    gbps = (payload_bytes + 2 * H * W) * fps / 1e9

    fps_worst, _ = bench_decode(*make_frames(content="worst"))
    fps_all16, _ = bench_decode(*make_frames(content="all16"))
    imgs_l, payloads_l = make_frames(codec=6, n=4)
    fps_legacy, _ = bench_decode(imgs_l, payloads_l, codec=6)
    fps_preview = bench_preview(imgs, payloads)
    fps_preview_malvar = bench_preview(imgs, payloads, demosaic="malvar")
    fps_preview_legacy = bench_preview(imgs_l, payloads_l, codec=6)
    fps_1080, _ = bench_decode(
        *make_frames(h=1080, w=1920), h=1080, w=1920
    )
    fps_legacy_1080, _ = bench_decode(
        *make_frames(h=1080, w=1920, codec=6), h=1080, w=1920, codec=6
    )

    ref_fps = bench_reference_cpu(payloads)
    vs = fps / ref_fps if ref_fps else fps / 720.0
    print(json.dumps({
        "metric": "4K 12-bit MCRAW decode throughput (1 chip)",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": vs,
        "unpack_gbps": gbps,
        "worst_case_fps": fps_worst,
        "all16_fps": fps_all16,
        "legacy_fps_4k": fps_legacy,
        "decode_develop_fps": fps_preview,
        "decode_develop_malvar_fps": fps_preview_malvar,
        "decode_develop_legacy_fps": fps_preview_legacy,
        "fps_1080p": fps_1080,
        "legacy_fps_1080p": fps_legacy_1080,
        "latency_ms_single_frame": latency * 1e3,
        "device": {"platform": platform, "kind": kind, "count": count},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
