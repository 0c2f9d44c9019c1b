"""Exact NumPy reference implementations of both MCRAW block codecs.

These are the correctness oracles for the device decode, bit-exact against the
C++ reference decoders (validated by differential tests via tools/ref_shim):

- ``decode_modern``  == motioncam::raw::Decode        (RawData.cpp:528-612)
- ``decode_legacy``  == motioncam::raw::DecodeLegacy  (RawData_Legacy.cpp:445-495)

They are vectorized over blocks where the format allows (the modern codec's
main data has no inline headers, so offsets are a prefix sum) and fall back
to a Python walk only over the serial inline-header chains (modern metadata
streams, legacy block stream).
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from ..errors import DecodeError

METADATA_OFFSET = 16  # RawData.cpp:25
HEADER_LENGTH = 2  # 2-byte block header (RawData.cpp:24)


def unpack_blocks(payload_windows: np.ndarray, bits: np.ndarray, modern: bool) -> np.ndarray:
    """Unpack fixed-width windows into uint16 values via the field tables.

    payload_windows: (N, MAX_LENGTH) uint8 — each row is a block's payload,
        zero-padded to the max block length.
    bits: (N,) integer bit widths (0..16).
    Returns (N, BLOCK) uint16 (references NOT added).
    """
    if modern:
        pos, rsh, msk, lsh = T.MODERN_POS, T.MODERN_RSH, T.MODERN_MSK, T.MODERN_LSH
        cls_index = T.MODERN_CLASS_INDEX
    else:
        pos, rsh, msk, lsh = T.LEGACY_POS, T.LEGACY_RSH, T.LEGACY_MSK, T.LEGACY_LSH
        cls_index = T.LEGACY_CLASS_INDEX

    ci = cls_index[np.asarray(bits, dtype=np.int64)]  # (N,)
    p = pos[ci]  # (N, BLOCK, F)
    g = payload_windows.astype(np.uint16)  # (N, MAX_LENGTH)
    picked = np.take_along_axis(g[:, None, :], p.astype(np.int64), axis=2)
    vals = ((picked >> rsh[ci].astype(np.uint16)) & msk[ci].astype(np.uint16)) << lsh[
        ci
    ].astype(np.uint16)
    return np.bitwise_or.reduce(vals, axis=2).astype(np.uint16)


def _decode_header(b0: int, b1: int) -> tuple[int, int]:
    """2-byte block header -> (bits, reference). RawData.cpp:106-110."""
    return (b0 >> 4) & 0x0F, ((b0 & 0x0F) << 8) | b1


def decode_metadata_stream(data: np.ndarray, offset: int) -> tuple[np.ndarray, int]:
    """Decode one modern metadata stream ("bits" or "refs").

    Mirrors DecodeMetadata (RawData.cpp:463-498): u32 LE numBlocks, then
    ceil(numBlocks/64) modern blocks each with a 2-byte inline header; the
    12-bit header reference is added to all 64 values of its group.

    Returns (values (numBlocks,) uint16, offset past the stream). Unlike the
    reference (which overruns its output vector when numBlocks % 64 != 0,
    RawData.cpp:476 vs :485-494), the tail group is decoded into padding and
    cropped.
    """
    n = len(data)
    if offset + 4 > n:
        raise DecodeError("metadata stream header out of bounds")
    num_blocks = (
        int(data[offset])
        | (int(data[offset + 1]) << 8)
        | (int(data[offset + 2]) << 16)
        | (int(data[offset + 3]) << 24)
    )
    offset += 4

    # Structural bound: every 64-value group needs at least its 2-byte
    # header, so a declared count beyond 64*(remaining/2) is malformed.
    # (Prevents attacker-controlled allocation before the walk even starts.)
    if num_blocks > 64 * max(0, n - offset) // 2:
        raise DecodeError("metadata stream declares impossible block count")

    num_groups = (num_blocks + 63) // 64
    lengths = T.MODERN_BLOCK_LENGTH
    bits_arr = np.zeros(num_groups, dtype=np.int32)
    refs_arr = np.zeros(num_groups, dtype=np.uint16)
    windows = np.zeros((num_groups, T.MODERN_MAX_LENGTH), dtype=np.uint8)

    for g in range(num_groups):
        if offset + HEADER_LENGTH > n:
            raise DecodeError("metadata stream truncated (header)")
        bits, ref = _decode_header(int(data[offset]), int(data[offset + 1]))
        offset += HEADER_LENGTH
        blen = int(lengths[bits])
        if offset + blen > n:
            # Reference skips decoding and leaves stale data
            # (RawData.cpp:419-420); strict mode raises instead.
            raise DecodeError("metadata stream truncated (payload)")
        windows[g, :blen] = data[offset : offset + blen]
        bits_arr[g] = bits
        refs_arr[g] = ref
        offset += blen

    vals = unpack_blocks(windows, bits_arr, modern=True)  # (G, 64)
    vals = vals + refs_arr[:, None]  # uint16 wraparound, same as the C++ +=
    return vals.reshape(-1)[:num_blocks], offset


def read_metadata_header(data: np.ndarray) -> tuple[int, int, int, int]:
    """16-byte modern payload header. RawData.cpp:500-524."""
    if len(data) < METADATA_OFFSET:
        raise DecodeError("payload too short for metadata header")
    h = data[:16].view("<u4")
    return int(h[0]), int(h[1]), int(h[2]), int(h[3])


def modern_block_geometry(encoded_width: int, encoded_height: int) -> tuple[int, int, int]:
    """(tiles_y, tiles_x, num_blocks) for the modern main data."""
    tiles_y = (encoded_height + 3) // 4
    tiles_x = encoded_width // T.MODERN_BLOCK
    return tiles_y, tiles_x, tiles_y * tiles_x * 4


def modern_deinterleave(
    vals: np.ndarray, refs: np.ndarray, tiles_y: int, tiles_x: int
) -> np.ndarray:
    """Bayer-phase de-interleave of modern main-data blocks.

    vals: (num_blocks, 64) uint16, refs: (num_blocks,) uint16.
    Per tile, 4 consecutive blocks p0..p3 hold the four phases
    (RawData.cpp:571-609): row r = 2h+q of the tile takes even columns from
    p[2q] and odd columns from p[2q+1], half h selecting values [32h:32h+32].
    Returns the (4*tiles_y, 64*tiles_x) uint16 image at encoded size.
    """
    v = (vals + refs[:, None].astype(np.uint16)).reshape(tiles_y, tiles_x, 4, 64)
    # p -> (q, c); j -> (h, k)
    v = v.reshape(tiles_y, tiles_x, 2, 2, 2, 32)  # (ty, tx, q, c, h, k)
    v = v.transpose(0, 4, 2, 1, 5, 3)  # (ty, h, q, tx, k, c)
    return np.ascontiguousarray(v).reshape(tiles_y * 4, tiles_x * 64)


def decode_modern(data: np.ndarray, width: int, height: int) -> np.ndarray:
    """Decode a compressionType-7 payload to an (height, width) uint16 plane."""
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    enc_w, enc_h, bits_off, refs_off = read_metadata_header(data)

    # Validity checks, RawData.cpp:547-554
    if bits_off > n or refs_off > n:
        raise DecodeError("metadata offsets out of bounds")
    if enc_w % T.MODERN_BLOCK != 0:
        raise DecodeError("encoded width not a multiple of 64")
    if enc_w < width:
        raise DecodeError("encoded width smaller than width")

    bits, _ = decode_metadata_stream(data, bits_off)
    refs, _ = decode_metadata_stream(data, refs_off)

    tiles_y, tiles_x, num_blocks = modern_block_geometry(enc_w, enc_h)
    if len(bits) < num_blocks or len(refs) < num_blocks:
        raise DecodeError("metadata streams shorter than block count")
    bits = np.minimum(bits[:num_blocks].astype(np.int64), 16)

    lengths = T.MODERN_BLOCK_LENGTH[bits]
    offsets = METADATA_OFFSET + np.concatenate(
        ([0], np.cumsum(lengths, dtype=np.int64)[:-1])
    )
    if offsets[-1] + lengths[-1] > n:
        raise DecodeError("main data truncated")

    padded = np.zeros(n + T.MODERN_MAX_LENGTH, dtype=np.uint8)
    padded[:n] = data
    windows = padded[offsets[:, None] + np.arange(T.MODERN_MAX_LENGTH)]

    vals = unpack_blocks(windows, bits, modern=True)
    img = modern_deinterleave(vals, refs[:num_blocks], tiles_y, tiles_x)
    out = img[:height, :width]
    if out.shape[0] < height:
        # Under-declared encodedHeight: the reference writes only
        # 4*ceil(encodedHeight/4) rows and returns; the caller's buffer
        # keeps its resize() contents for the tail (Decoder.cpp:221-222 —
        # zeros for a fresh vector; NOTE the example reuses outData across
        # frames, so the C++ tail shows the PREVIOUS same-size frame
        # there — a stateful quirk we deliberately do not replicate; we
        # always zero-fill, matching the reference's first decode).
        out = np.concatenate(
            [out, np.zeros((height - out.shape[0], out.shape[1]), np.uint16)]
        )
    return out


def legacy_padded_width(width: int) -> int:
    """Width padded to a multiple of 32. RawData_Legacy.cpp:34-36."""
    return 32 * ((width + 31) // 32)


def legacy_chunk_offsets(data: np.ndarray) -> list[int]:
    """Parse the trailing chunk-offset table (RawData_Legacy.cpp:452-469).

    Entries of [u32 BE pos][0xFF marker] are walked backwards from the last
    byte while the marker is 0xFF. The reference parses but never uses them;
    they enable parallel chunked decode.
    """
    out: list[int] = []
    n = len(data)
    if n == 0:
        return out
    i = n - 1
    while i >= 4 and data[i] == 0xFF:
        pos = (
            (int(data[i - 4]) << 24)
            | (int(data[i - 3]) << 16)
            | (int(data[i - 2]) << 8)
            | int(data[i - 1])
        )
        out.append(pos)
        i -= 5
    return out


def legacy_scan(
    data: np.ndarray, num_blocks: int, start_offset: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk the legacy inline-header chain (pure-Python fallback).

    Returns (bits (N,), refs (N,), payload_offsets (N,)) where
    payload_offsets point just past each 2-byte header. This is the serial
    part of the legacy codec; the native C++ scanner replaces it on the hot
    path.
    """
    n = len(data)
    lengths = T.LEGACY_BLOCK_LENGTH
    bits_arr = np.zeros(num_blocks, dtype=np.int32)
    refs_arr = np.zeros(num_blocks, dtype=np.uint16)
    offs_arr = np.zeros(num_blocks, dtype=np.int64)
    mv = data  # uint8 ndarray indexing
    offset = start_offset
    for i in range(num_blocks):
        # Truncation semantics per RawData_Legacy.cpp:387-399 (note `>=`).
        if offset + HEADER_LENGTH >= n:
            raise DecodeError("legacy stream truncated (header)")
        b0 = int(mv[offset])
        b1 = int(mv[offset + 1])
        bits = min(16, (b0 >> 4) & 0x0F)
        refs_arr[i] = ((b0 & 0x0F) << 8) | b1
        blen = int(lengths[bits])
        if offset + HEADER_LENGTH + blen >= n:
            raise DecodeError("legacy stream truncated (payload)")
        bits_arr[i] = bits
        offs_arr[i] = offset + HEADER_LENGTH
        offset += HEADER_LENGTH + blen
    return bits_arr, refs_arr, offs_arr


def legacy_interleave(
    vals: np.ndarray, refs: np.ndarray, height: int, padded_width: int
) -> np.ndarray:
    """Even/odd interleave of legacy block pairs (RawData_Legacy.cpp:483-486).

    vals: (num_blocks, 16) uint16, refs: (num_blocks,) uint16, where blocks
    alternate even-pixel / odd-pixel. Returns (height, padded_width) uint16.
    """
    num_pairs = height * (padded_width // 32)
    v = (vals + refs[:, None].astype(np.uint16)).reshape(num_pairs, 2, 16)
    v = v.transpose(0, 2, 1)  # (pair, k, parity)
    return np.ascontiguousarray(v).reshape(height, padded_width)


def decode_legacy(data: np.ndarray, width: int, height: int) -> np.ndarray:
    """Decode a compressionType-6 payload to an (height, width) uint16 plane."""
    data = np.asarray(data, dtype=np.uint8)
    padded_width = legacy_padded_width(width)
    num_blocks = height * (padded_width // 32) * 2

    bits, refs, offs = legacy_scan(data, num_blocks)

    padded = np.zeros(len(data) + T.LEGACY_MAX_LENGTH, dtype=np.uint8)
    padded[: len(data)] = data
    windows = padded[offs[:, None] + np.arange(T.LEGACY_MAX_LENGTH)]

    vals = unpack_blocks(windows, bits, modern=False)
    img = legacy_interleave(vals, refs, height, padded_width)
    return img[:, :width]
