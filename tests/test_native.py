"""The native host scanner must exist where a toolchain exists, and must
agree exactly with the pure-Python reference scans (kernels/native.py is a
silent-fallback wrapper, so without these tests CI proves nothing about the
C++ path)."""

import shutil

import numpy as np
import pytest

from mcraw import encode as E
from mcraw.errors import DecodeError
from mcraw.kernels import native as N
from mcraw.kernels import numpy_ref as R


def test_native_available_when_toolchain_present():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    # get_lib() auto-builds (stamp-checked) — absence here is a real failure,
    # not an environment quirk.
    assert N.have_native(), "native scanner failed to build/load with g++ present"


@pytest.fixture
def native_lib():
    if not N.have_native():
        pytest.skip("native scanner unavailable")
    return N.get_lib()


def _modern_streams(rng, h=16, w=128):
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    data = np.frombuffer(E.encode_modern(img), dtype=np.uint8)
    _, _, bits_off, refs_off = R.read_metadata_header(data)
    return data, bits_off, refs_off


def test_metadata_scan_matches_python(native_lib, rng):
    data, bits_off, refs_off = _modern_streams(rng)
    for off in (bits_off, refs_off):
        vals_n, end_n = N.decode_metadata_stream(data, off)
        vals_p, end_p = R.decode_metadata_stream(data, off)
        assert end_n == end_p
        np.testing.assert_array_equal(vals_n, vals_p)


def test_metadata_scan_truncated(native_lib, rng):
    data, bits_off, _ = _modern_streams(rng)
    # Cut mid group-header (4-byte count + 1 of 2 header bytes).
    with pytest.raises(DecodeError):
        N.decode_metadata_stream(data[: bits_off + 5], bits_off)


def test_legacy_scan_matches_python(native_lib, rng):
    h, w = 24, 96
    img = rng.integers(0, 1024, size=(h, w), dtype=np.uint16)
    data = np.frombuffer(E.encode_legacy(img), dtype=np.uint8)
    num_blocks = h * (R.legacy_padded_width(w) // 32) * 2
    bits_n, refs_n, offs_n = N.legacy_scan(data, num_blocks)
    bits_p, refs_p, offs_p = R.legacy_scan(data, num_blocks)
    np.testing.assert_array_equal(bits_n, bits_p)
    np.testing.assert_array_equal(refs_n, refs_p)
    np.testing.assert_array_equal(offs_n, offs_p)


def test_legacy_scan_truncated(native_lib, rng):
    img = rng.integers(0, 1024, size=(8, 64), dtype=np.uint16)
    data = np.frombuffer(E.encode_legacy(img), dtype=np.uint8)
    num_blocks = 8 * (64 // 32) * 2
    with pytest.raises(DecodeError):
        N.legacy_scan(data[: len(data) // 2], num_blocks)
