#!/usr/bin/env python3
"""Randomized CONTAINER-level differential soak: full-file byte parity.

Each iteration authors a random .mcraw container (random frame count,
geometry, codec, audio chunk sizes/channels/timestamps — shapes the fixed
tests never enumerate), then runs BOTH CLIs (ours and the compiled
reference example) and byte-compares every emitted file. Catches
container-walk divergences end-to-end, not just codec ones.

Run from a non-repo cwd or with --backend numpy semantics: our CLI is
invoked with the numpy backend explicitly so no accelerator start-up can hang
the soak.

Usage: python tools/soak_container.py [seconds] (default 600)
"""

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def author_random_clip(rng, path):
    from mcraw import encode as E
    from mcraw.metadata import example_container_metadata, example_frame_metadata

    codec = int(rng.integers(6, 8))
    nframes = int(rng.integers(0, 5))
    h = int(rng.integers(1, 13)) * 4
    w = int(rng.integers(8, 200))
    channels = int(rng.integers(1, 3))
    rate = int(rng.choice([8000, 44100, 48000]))
    cm = example_container_metadata(sample_rate=rate, channels=channels)
    wr = E.ContainerWriter(cm)
    ts = 1000
    for _ in range(nframes):
        img = rng.integers(
            0, 1 << int(rng.integers(1, 17)), size=(h, w), dtype=np.uint16
        )
        payload = (
            E.encode_modern(img) if codec == 7 else E.encode_legacy(img)
        )
        fm = example_frame_metadata(w, h, compression_type=codec)
        wr.add_frame(ts, payload, fm)
        ts += int(rng.integers(1, 50_000_000))
        # Interleave audio randomly; missing timestamps are legal per the
        # reference walk. Sample counts stay a multiple of the channel
        # count: an odd STEREO count makes the reference example read past
        # its vector (example.cpp:40-42, UB we deliberately do not inherit
        # — our CLI drops the trailing sample, pinned by
        # test_odd_samples_stereo_truncates), so byte parity is undefined
        # there by design. n == 0 stays in: a zero-size AUDIO_DATA chunk
        # aborts BOTH CLIs identically (the reference fread(_, 0, 1) throw,
        # mirrored by container._read1 — this soak found that quirk).
        for _ in range(int(rng.integers(0, 3))):
            n = int(rng.integers(0, 2000)) // channels * channels
            samples = rng.integers(-32768, 32768, size=n).astype(np.int16)
            with_ts = bool(rng.integers(0, 2))
            wr.add_audio(
                samples, timestamp_ns=ts if with_ts else None
            )
    Path(path).write_bytes(wr.finish())
    return nframes


def run_cli(cmd, cwd, env=None):
    return subprocess.run(
        cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def main():
    budget_s = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0

    from tools import ref_shim

    exe = ref_shim.build_example()
    assert exe, "reference example unavailable"

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)

    rng = np.random.default_rng(int(time.time()) % (1 << 31))
    t0 = time.time()
    iters = fails = 0
    while time.time() - t0 < budget_s:
        iters += 1
        with tempfile.TemporaryDirectory() as td:
            td = Path(td)
            clip = td / "clip.mcraw"
            try:
                author_random_clip(rng, str(clip))
            except Exception as e:  # noqa: BLE001
                print(f"AUTHOR FAIL iter {iters}: {e!r}", flush=True)
                fails += 1
                continue
            mine, ref = td / "mine", td / "ref"
            mine.mkdir()
            ref.mkdir()
            r1 = run_cli(
                [sys.executable, "-m", "mcraw", "decode", str(clip),
                 "--backend", "numpy"],
                cwd=mine, env=env,
            )
            r2 = run_cli([str(exe), str(clip)], cwd=ref)
            ok = r1.returncode == r2.returncode
            if ok:
                ours = sorted(p.name for p in mine.iterdir())
                theirs = sorted(p.name for p in ref.iterdir())
                ok = ours == theirs and all(
                    (mine / n).read_bytes() == (ref / n).read_bytes()
                    for n in ours
                )
            if not ok:
                fails += 1
                keep = Path(__file__).with_name(
                    f"soak_container_fail_{iters}.mcraw"
                )
                keep.write_bytes(clip.read_bytes())
                print(
                    f"FAIL iter {iters}: rc {r1.returncode}/{r2.returncode}"
                    f" stderr1={r1.stderr[:120]!r} kept {keep}",
                    flush=True,
                )
        if iters % 20 == 0:
            print(
                f"{iters} iters, {fails} fails, {time.time()-t0:.0f}s",
                flush=True,
            )
    print(f"DONE: {iters} iterations, {fails} failures", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
