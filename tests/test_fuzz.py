"""Robustness fuzzing: random corruption must raise MotionCamException (or
decode cleanly) — never crash, hang, or corrupt memory (SURVEY.md §5:
the reference has UB on truncated/malformed input; this framework must not)."""

import numpy as np
import pytest

from mcraw import encode as E
from mcraw.container import ContainerReader
from mcraw.errors import MotionCamException
from mcraw.kernels import numpy_ref as R
from mcraw.metadata import example_container_metadata, example_frame_metadata


def _clip(rng):
    writer = E.ContainerWriter(example_container_metadata())
    img = rng.integers(0, 4096, size=(8, 128), dtype=np.uint16)
    writer.add_frame(1, E.encode_modern(img), example_frame_metadata(128, 8))
    writer.add_audio(rng.integers(-100, 100, size=64).astype(np.int16), 5)
    return writer.finish()


def test_random_truncation_never_crashes(rng):
    blob = _clip(rng)
    for _ in range(60):
        cut = int(rng.integers(0, len(blob)))
        try:
            r = ContainerReader(blob[:cut])
            for ts in r.frames:
                r.frame_payload(ts)
            for i in range(r.num_audio_chunks):
                r.audio_chunk(i)
        except MotionCamException:
            pass


def test_random_byte_flips_never_crash(rng):
    blob = bytearray(_clip(rng))
    for _ in range(80):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 8))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        try:
            r = ContainerReader(bytes(b))
            for ts in r.frames[:4]:
                payload, meta = r.frame_payload(ts)
                w = int(meta.get("width", 0))
                h = int(meta.get("height", 0))
                if 0 < w <= 4096 and 0 < h <= 4096:
                    R.decode_modern(np.asarray(payload), w, h)
        except (MotionCamException, ValueError, KeyError, TypeError):
            pass  # clean rejection is fine; crashes/hangs are not


def test_random_payload_decode_never_crashes(rng):
    """Feed raw noise to both codecs."""
    for _ in range(40):
        n = int(rng.integers(16, 2000))
        noise = rng.integers(0, 256, size=n, dtype=np.uint8)
        for fn, (w, h) in ((R.decode_modern, (64, 8)), (R.decode_legacy, (32, 4))):
            try:
                fn(noise, w, h)
            except MotionCamException:
                pass


def test_metadata_stream_count_bomb(rng):
    """A huge declared numBlocks must fail cleanly, not allocate wild."""
    img = rng.integers(0, 256, size=(8, 64), dtype=np.uint16)
    payload = bytearray(E.encode_modern(img))
    _, _, bits_off, _ = R.read_metadata_header(np.frombuffer(bytes(payload), np.uint8))
    payload[bits_off : bits_off + 4] = (0x7FFFFFFF).to_bytes(4, "little")
    with pytest.raises(MotionCamException):
        R.decode_modern(np.frombuffer(bytes(payload), np.uint8), 64, 8)


def test_light_prep_fuzz_never_crashes(rng):
    """The device decode's host prep (serial scans + validation) must
    reject or survive arbitrary corruption without crashing — it guards
    the device program's assumptions (offsets in-bounds, counts sane)."""
    from mcraw.kernels import unpack as U

    img = rng.integers(0, 4096, size=(16, 128), dtype=np.uint16)
    payload = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    for _ in range(60):
        bad = payload.copy()
        mode = rng.integers(0, 3)
        if mode == 0:  # truncate
            bad = bad[: int(rng.integers(0, len(bad)))]
        elif mode == 1:  # flip bytes
            idx = rng.integers(0, len(bad), size=8)
            bad[idx] = rng.integers(0, 256, size=8)
        else:  # pure noise
            bad = rng.integers(0, 256, size=int(rng.integers(0, 4096))).astype(
                np.uint8
            )
        try:
            plan = U.prepare_modern(bad, 128, 16)
            n = len(plan.payload)
            assert np.all(plan.offsets + 128 <= n)  # windows in bounds
        except MotionCamException:
            pass  # rejection is the expected outcome
