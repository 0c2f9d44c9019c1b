"""Malformed-payload behavior parity vs the compiled C++ reference
(VERDICT r2 #3).

The reference's loadFrame DOES check the codec return value
(/root/reference/lib/Decoder.cpp:225-231): raw::Decode returning <= 0
throws IOException("Failed to uncompress frame") (legacy: "Failed to
uncompress legacy frame"), which the example prints as "Error: <what>"
and exits -1 (example.cpp:197-200). Decode returns 0 exactly for the
three header checks (RawData.cpp:547-554) and for zero output area;
DecodeLegacy returns height*width (RawData_Legacy.cpp:445-495), so only
zero area fails there.

These tests pin BYTE parity (stdout, stderr, exit status, emitted files)
for every malformed class where the reference's behavior is
deterministic, and pin OUR documented behavior where the reference's is
undefined:

  - truncated payloads: the reference reuses stale/uninitialized stack
    buffers (RawData.cpp:419-420 skips the write; RawData_Legacy.cpp:473
    reads uninitialized references) and reads past its input buffer in
    DecodeMetadata (RawData.cpp:486 has no header bounds check) — UB. We
    raise, surfacing the reference's error text at the CLI.
  - metadata stream counts not a multiple of 64: the reference overruns
    its output vector (RawData.cpp:476 resize vs :485-494 64-stride
    writes) — UB. We decode the tail group into padding and crop.
"""

import struct
import subprocess

import numpy as np
import pytest

from mcraw import encode as E
from mcraw.cli import main as cli_main
from mcraw.errors import IOException
from mcraw.metadata import example_container_metadata, example_frame_metadata
from mcraw.pipeline import Decoder


# ref_example fixture: session-scoped, in conftest.py (shared with
# test_json_parity.py).


def _clip(rng, payloads_meta):
    """Container from explicit (payload_bytes, frame_metadata) pairs."""
    writer = E.ContainerWriter(example_container_metadata())
    for i, (payload, fm) in enumerate(payloads_meta):
        writer.add_frame(1000 + i, payload, fm)
    writer.add_audio(np.zeros(256, np.int16), 0)
    return writer.finish()


def _run_both_raw(tmp_path, blob, ref_example, capsys, monkeypatch):
    """Run both CLIs reference-style; return (ref_proc, our_rc, our_out,
    our_err, ref_dir, my_dir)."""
    clip = tmp_path / "clip.mcraw"
    clip.write_bytes(blob)
    ref_dir = tmp_path / "ref"
    my_dir = tmp_path / "mine"
    ref_dir.mkdir()
    my_dir.mkdir()
    ref = subprocess.run(
        [str(ref_example), str(clip)],
        cwd=ref_dir, capture_output=True, text=True,
    )
    monkeypatch.chdir(my_dir)
    capsys.readouterr()
    rc = cli_main(["decode", str(clip), "--backend", "numpy"])
    out = capsys.readouterr()
    return ref, rc, out.out, out.err, ref_dir, my_dir


def _assert_cli_parity(tmp_path, blob, ref_example, capsys, monkeypatch):
    ref, rc, out, err, ref_dir, my_dir = _run_both_raw(
        tmp_path, blob, ref_example, capsys, monkeypatch
    )
    assert out == ref.stdout
    assert err == ref.stderr
    # example returns -1 -> 255 through the shell; cli_main returns -1/0.
    assert (rc != 0) == (ref.returncode != 0)
    ref_files = sorted(p.name for p in ref_dir.iterdir())
    my_files = sorted(p.name for p in my_dir.iterdir())
    assert ref_files == my_files
    for name in ref_files:
        assert (ref_dir / name).read_bytes() == (my_dir / name).read_bytes()


def _corrupt_modern(rng, h=16, w=192, mode="bits_off"):
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = bytearray(E.encode_modern(img))
    ew, eh, bo, ro = struct.unpack("<IIII", payload[:16])
    if mode == "bits_off":
        bo = len(payload) + 1  # > len -> Decode returns 0
    elif mode == "refs_off":
        ro = len(payload) + 1
    elif mode == "enc_w_mod":
        ew = ew + 3  # % 64 != 0
    elif mode == "enc_w_small":
        ew = 64  # < width (width=192)
    else:
        raise AssertionError(mode)
    payload[:16] = struct.pack("<IIII", ew, eh, bo, ro)
    return bytes(payload), example_frame_metadata(w, h, 7)


@pytest.mark.parametrize(
    "mode", ["bits_off", "refs_off", "enc_w_mod", "enc_w_small"]
)
def test_bad_modern_header_cli_parity(
    tmp_path, rng, ref_example, capsys, monkeypatch, mode
):
    """Every header-check failure (RawData.cpp:547-554) must abort both
    CLIs with byte-identical stdout/stderr/exit/files (audio.wav only)."""
    blob = _clip(rng, [_corrupt_modern(rng, mode=mode)])
    _assert_cli_parity(tmp_path, blob, ref_example, capsys, monkeypatch)


def test_second_frame_malformed_cli_parity(
    tmp_path, rng, ref_example, capsys, monkeypatch
):
    """Good frame 0, corrupt frame 1: both CLIs write frame_000000.dng
    then abort identically (the reference loop is fail-fast,
    example.cpp:187-195)."""
    img = rng.integers(0, 4096, size=(16, 192), dtype=np.uint16)
    good = (bytes(E.encode_modern(img)), example_frame_metadata(192, 16, 7))
    blob = _clip(rng, [good, _corrupt_modern(rng, mode="bits_off")])
    _assert_cli_parity(tmp_path, blob, ref_example, capsys, monkeypatch)


def test_zero_width_modern_cli_parity(
    tmp_path, rng, ref_example, capsys, monkeypatch
):
    """Frame metadata width=0: Decode writes rows x 0 values and returns
    0 -> "Failed to uncompress frame" (defined in the reference: all its
    writes are memcpy(.., 0))."""
    img = rng.integers(0, 4096, size=(16, 192), dtype=np.uint16)
    fm = example_frame_metadata(0, 16, 7)
    blob = _clip(rng, [(bytes(E.encode_modern(img)), fm)])
    _assert_cli_parity(tmp_path, blob, ref_example, capsys, monkeypatch)


def test_zero_height_legacy_cli_parity(
    tmp_path, rng, ref_example, capsys, monkeypatch
):
    """Legacy is the codec that never fails a header check; zero area is
    its only <= 0 return (RawData_Legacy.cpp:478-494)."""
    img = rng.integers(0, 4096, size=(8, 96), dtype=np.uint16)
    fm = example_frame_metadata(96, 0, 6)
    blob = _clip(rng, [(bytes(E.encode_legacy(img)), fm)])
    _assert_cli_parity(tmp_path, blob, ref_example, capsys, monkeypatch)


def test_under_declared_encoded_height_parity(
    tmp_path, rng, ref_example, capsys, monkeypatch
):
    """encodedHeight < height: the reference short-decodes and leaves the
    tail rows of its (fresh, zero-initialized) output buffer untouched
    (Decoder.cpp:221-222). Our decoder zero-pads identically — full DNG
    byte parity on a one-frame clip. (On multi-frame clips the C++
    example reuses outData, so its tail would echo the previous frame —
    a stateful quirk we document and do not replicate:
    kernels/numpy_ref.py decode_modern.)"""
    h, w = 16, 192
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = bytearray(E.encode_modern(img))
    ew, eh, bo, ro = struct.unpack("<IIII", payload[:16])
    payload[:16] = struct.pack("<IIII", ew, 8, bo, ro)  # declare 8 of 16
    blob = _clip(rng, [(bytes(payload), example_frame_metadata(w, h, 7))])
    _assert_cli_parity(tmp_path, blob, ref_example, capsys, monkeypatch)


def test_truncated_payload_is_our_error_their_ub(rng):
    """Truncated frame payload: the reference's behavior is stale-buffer
    reuse + OOB metadata reads (UB, see module docstring); ours is a
    deterministic raise that surfaces the reference's own error text at
    the API/CLI boundary. Named divergence test per VERDICT r2 #3."""
    img = rng.integers(0, 65536, size=(16, 192), dtype=np.uint16)
    full = bytes(E.encode_modern(img))
    fm = example_frame_metadata(192, 16, 7)
    blob = _clip(rng, [(full[: len(full) - 7], fm)])
    d = Decoder(blob, backend="numpy")
    with pytest.raises(IOException, match="^Failed to uncompress frame$"):
        d.load_frame(d.frames[0])

    leg = bytes(E.encode_legacy(img))
    blob6 = _clip(  # cut into the block stream, not just the tail table
        rng, [(leg[: len(leg) // 2], example_frame_metadata(192, 16, 6))]
    )
    d6 = Decoder(blob6, backend="numpy")
    with pytest.raises(
        IOException, match="^Failed to uncompress legacy frame$"
    ):
        d6.load_frame(d6.frames[0])


def test_nonmultiple64_stream_count_decodes(rng):
    """Declared metadata counts that are not multiples of 64 are reference
    UB (vector overrun, RawData.cpp:476 vs :485-494); our decoder pads
    the tail group and crops — element-exact decode, no error."""
    from mcraw.kernels import numpy_ref as NR

    img = rng.integers(0, 4096, size=(16, 192), dtype=np.uint16)
    tiles = (16 // 4) * (192 // 64) * 4  # 48 blocks: NOT a multiple of 64
    assert tiles % 64 != 0
    payload = np.frombuffer(
        E.encode_modern(img, declared_count=tiles), dtype=np.uint8
    )
    assert np.array_equal(NR.decode_modern(payload, 192, 16), img)


def test_noncanonical_payloads_through_pallas_kernels(rng):
    """Mutated (noncanonical) payloads through BOTH device decodes (the
    plain-XLA programs that replaced the fused kernels): refs below min /
    wraparound refs / over-wide bits nibbles 12-15 / stream gaps / junk
    stream tails. The mutation soak (tools/soak_mutation.py) covers
    ref-shim/oracle; this pins the device decode on the same
    distribution."""
    from mcraw.kernels import unpack as U
    from tools.soak_mutation import make_coder

    h, w = 16, 192
    img = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
    payload = np.frombuffer(
        E.encode_modern(
            img,
            coder=make_coder(rng, cap_bits=16, cap_ref=0xFFFF, wrap_ok=True),
            meta_coder=make_coder(
                rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True
            ),
            meta_tail=rng.integers(0, 1 << 16, size=17, dtype=np.uint16),
            gaps=(rng.bytes(11), rng.bytes(5)),
        ),
        dtype=np.uint8,
    )
    assert np.array_equal(np.asarray(U.decode_modern(payload, w, h)), img)

    lpay = np.frombuffer(
        E.encode_legacy(
            img,
            coder=make_coder(rng, cap_bits=15, cap_ref=0x0FFF, wrap_ok=True),
        ),
        dtype=np.uint8,
    )
    assert np.array_equal(np.asarray(U.decode_legacy(lpay, w, h)), img)
