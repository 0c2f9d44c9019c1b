"""MCRAW encoder: the exact inverse of the reference decoders.

The reference ships no encoder; this one exists so the framework can (a)
generate synthetic test fixtures covering every bit width and edge case of
the format spec (SURVEY.md §2.4), and (b) author valid .mcraw containers
outright. Output is validated by differential tests that feed encoded
containers through the *compiled C++ reference decoder* (tools/ref_shim).

Packing uses the same field tables as decoding (kernels/tables.py); each
field writes ``((val >> lshift) & mask) << rshift`` into byte ``pos`` — the
exact inverse of the decoder's extraction, and fields are disjoint so OR
accumulation is lossless.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from . import container as C
from .kernels import tables as T
from .errors import MotionCamException

MODERN_REF_MAX = 0x0FFF  # block reference is 12 bits (RawData.cpp:106-110)


def _bits_needed(maxval: int) -> int:
    return int(maxval).bit_length()


def _class_width(bits: np.ndarray) -> np.ndarray:
    """Representable residual width per header value: nibbles/values 11-16
    all select the 16-bit class (RawData.cpp:454-457 switch default;
    RawData_Legacy.cpp:395 clamps then :435-438 defaults)."""
    bits = np.asarray(bits, dtype=np.int64)
    return np.where(bits >= 11, 16, bits)


def _coded(blocks: np.ndarray, coder, ref_max: int):
    """Per-block (bits, refs, resid) selection.

    Canonical (coder=None): ref = block min capped to ref_max, smallest
    decode class. A coder — the mutation-soak hook — may return ANY
    (bits, refs) pair consistent with exact decode: both decoders add the
    reference in uint16 arithmetic (RawData.cpp:491-492, :581-593;
    RawData_Legacy.cpp:483-486), so resid = (value - ref) mod 2^16 must
    fit the class width. This admits every layout a conforming encoder
    could emit — refs below the block min, over-wide bits (nibbles 12-15),
    and full wraparound refs under the 16-bit class — while rejecting
    unrepresentable choices loudly.
    """
    if coder is None:
        refs = np.minimum(blocks.min(axis=1), ref_max)
        resid = blocks - refs[:, None]
        needed = np.array([_bits_needed(int(x)) for x in resid.max(axis=1)])
        bits = np.array(
            [_canonical_bits(int(b)) for b in needed], dtype=np.int64
        )
        return bits, refs, resid
    bits, refs = coder(blocks, ref_max)
    bits = np.asarray(bits, dtype=np.int64)
    refs = np.asarray(refs, dtype=np.int64)
    if np.any(bits < 0) or np.any(bits > 16):
        raise MotionCamException("coder produced bits outside 0..16")
    resid = (blocks - refs[:, None]) & 0xFFFF
    limit = (1 << _class_width(bits)) - 1
    if np.any(resid.max(axis=1) > limit):
        raise MotionCamException("coder produced unrepresentable residuals")
    return bits, refs, resid


def _canonical_bits(needed: int) -> int:
    """Smallest header nibble whose decode class can represent `needed` bits.

    The header nibble is 4 bits so "16-bit" blocks are written as nibble 11
    (any of 11..15 decodes identically via Decode16).
    """
    if needed <= 10:
        return needed
    if needed <= 16:
        return 11
    raise MotionCamException(f"value needs {needed} bits > 16")


def pack_blocks(vals: np.ndarray, bits: np.ndarray, modern: bool) -> list[bytes]:
    """Pack (N, BLOCK) uint16 residuals into per-block payload bytes."""
    if modern:
        pos, rsh, msk, lsh = T.MODERN_POS, T.MODERN_RSH, T.MODERN_MSK, T.MODERN_LSH
        cls_index, lengths = T.MODERN_CLASS_INDEX, T.MODERN_BLOCK_LENGTH
        max_len = T.MODERN_MAX_LENGTH
    else:
        pos, rsh, msk, lsh = T.LEGACY_POS, T.LEGACY_RSH, T.LEGACY_MSK, T.LEGACY_LSH
        cls_index, lengths = T.LEGACY_CLASS_INDEX, T.LEGACY_BLOCK_LENGTH
        max_len = T.LEGACY_MAX_LENGTH

    vals = np.asarray(vals, dtype=np.int64)
    bits = np.asarray(bits, dtype=np.int64)
    ci = cls_index[bits]  # (N,)
    p, r, m, s = pos[ci], rsh[ci], msk[ci], lsh[ci]  # (N, BLOCK, F)
    contrib = ((vals[:, :, None] >> s) & m) << r  # (N, BLOCK, F)

    out = np.zeros((len(vals), max_len), dtype=np.int64)
    n_idx = np.broadcast_to(np.arange(len(vals))[:, None, None], p.shape)
    np.bitwise_or.at(out, (n_idx.ravel(), p.ravel()), contrib.ravel())
    out8 = out.astype(np.uint8)
    return [out8[i, : lengths[bits[i]]].tobytes() for i in range(len(vals))]


def _encode_value_stream(
    values: np.ndarray,
    coder=None,
    tail_values: np.ndarray | None = None,
) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Split values into 64-value groups; per group pick ref + bits.

    Returns (payload_bytes_without_count, per-group bits, per-group refs).
    The tail group is padded with the group reference by default (decodes
    to the reference itself; callers crop); tail_values (mutation hook)
    substitutes arbitrary uint16 padding — the decoder must crop it
    identically. The inline 2-byte headers carry 12-bit references
    (RawData.cpp:106-110), so a coder here must keep refs <= 0x0FFF.
    """
    values = np.asarray(values, dtype=np.uint16).astype(np.int64)
    n = len(values)
    groups = (n + 63) // 64
    g = np.zeros((groups, 64), dtype=np.int64)
    pad_known = tail_values is not None
    if pad_known and groups:
        tv = np.asarray(tail_values, dtype=np.uint16).astype(np.int64)
        if len(tv):
            g[-1, 64 - len(tv):] = tv
    for i in range(groups):
        chunk = values[i * 64 : (i + 1) * 64]
        if len(chunk) < 64 and not pad_known:
            ref = min(int(chunk.min()), MODERN_REF_MAX) if len(chunk) else 0
            g[i, :] = ref  # tail padding decodes to the reference itself
        g[i, : len(chunk)] = chunk
    bits, refs, resid = _coded(g, coder, MODERN_REF_MAX)
    if np.any(refs > MODERN_REF_MAX) or np.any(refs < 0):
        raise MotionCamException("stream reference exceeds 12 bits")
    if np.any(bits > 15):
        raise MotionCamException("stream bits exceed the 4-bit header nibble")
    payloads = pack_blocks(resid.astype(np.uint16), bits, modern=True)

    out = bytearray()
    for i in range(groups):
        b0 = ((int(bits[i]) & 0x0F) << 4) | ((int(refs[i]) >> 8) & 0x0F)
        b1 = int(refs[i]) & 0xFF
        out += bytes((b0, b1)) + payloads[i]
    return bytes(out), bits, refs


def encode_modern(
    image: np.ndarray,
    encoded_width: int | None = None,
    encoded_height: int | None = None,
    *,
    coder=None,
    meta_coder=None,
    meta_tail: np.ndarray | None = None,
    gaps: tuple[bytes, bytes] = (b"", b""),
    declared_count: int | None = None,
) -> bytes:
    """Encode an (H, W) uint16 plane as a compressionType-7 payload.

    W is padded to encoded_width (a multiple of 64, default: W rounded up)
    with edge-replicated columns. encoded_height (default H) may exceed H
    and need not be a multiple of 4: the decoder processes whole 4-row
    tiles — ceil(encodedHeight/4) of them — and crops to `height` on output
    (RawData.cpp:571-609; the reference itself *overruns* its caller's
    height-sized buffer in that case, which is why differential tests for
    these shapes go through ref_shim's over-allocated wrapper rather than
    the reference example binary). Pad rows are edge-replicated.

    Mutation-soak hooks (canonical output is unchanged when all are left
    at their defaults): `coder` picks noncanonical (bits, refs) for main
    blocks (see _coded; main-data refs travel through the refs metadata
    stream as full uint16 values, so refs up to 65535 are format-legal
    here), `meta_coder`/`meta_tail` do the same for the two metadata
    streams (their inline headers cap refs at 12 bits), `gaps` inserts
    junk bytes before each metadata stream (the decoder must honor the
    header offsets, not adjacency), and `declared_count` overrides the
    streams' numBlocks word (values not a multiple of 64 are reference
    UB — vector overrun at RawData.cpp:476 vs :485-494 — so only our
    decoder's pad-and-crop behavior is testable for those).
    """
    image = np.asarray(image, dtype=np.uint16)
    h, w = image.shape
    if encoded_width is None:
        encoded_width = 64 * ((w + 63) // 64)
    if encoded_width % 64 != 0 or encoded_width < w:
        raise MotionCamException("bad encoded width")
    if encoded_height is None:
        encoded_height = h
    if encoded_height < h:
        raise MotionCamException("bad encoded height")
    tile_rows = 4 * ((encoded_height + 3) // 4)

    if encoded_width != w:
        pad = np.repeat(image[:, -1:], encoded_width - w, axis=1)
        image = np.concatenate([image, pad], axis=1)
    if tile_rows != h:
        pad = np.repeat(image[-1:, :], tile_rows - h, axis=0)
        image = np.concatenate([image, pad], axis=0)

    tiles_y, tiles_x = tile_rows // 4, encoded_width // 64
    # Inverse of modern_deinterleave: (ty,h2,q,tx,k,c) <- image
    v = image.reshape(tiles_y, 2, 2, tiles_x, 32, 2)
    v = v.transpose(0, 3, 2, 5, 1, 4)  # (ty, tx, q, c, h2, k)
    blocks = v.reshape(tiles_y * tiles_x * 4, 64).astype(np.int64)

    num_blocks = len(blocks)
    bits, refs, resid = _coded(blocks, coder, MODERN_REF_MAX)

    payloads = pack_blocks(resid.astype(np.uint16), bits, modern=True)
    main = b"".join(payloads)

    bits_stream, _, _ = _encode_value_stream(
        bits.astype(np.uint16), coder=meta_coder, tail_values=meta_tail
    )
    refs_stream, _, _ = _encode_value_stream(
        refs.astype(np.uint16), coder=meta_coder, tail_values=meta_tail
    )

    bits_off = 16 + len(main) + len(gaps[0])
    refs_off = bits_off + 4 + len(bits_stream) + len(gaps[1])
    header = struct.pack(
        "<IIII", encoded_width, encoded_height, bits_off, refs_off
    )
    # The stream count is padded to a multiple of 64: DecodeMetadata
    # (RawData.cpp:476 vs :485-494) resizes to numBlocks but always decodes
    # whole 64-value groups, overflowing its vector otherwise — so valid
    # containers must carry numBlocks % 64 == 0. Decode reads only the first
    # tiles*4 entries.
    count = struct.pack(
        "<I",
        64 * ((num_blocks + 63) // 64)
        if declared_count is None
        else declared_count,
    )
    return (
        header + main + gaps[0] + count + bits_stream
        + gaps[1] + count + refs_stream
    )


def encode_legacy(
    image: np.ndarray,
    chunk_rows: int | None = None,
    add_offset_table: bool = True,
    *,
    coder=None,
) -> bytes:
    """Encode an (H, W) uint16 plane as a compressionType-6 payload.

    Blocks carry inline 2-byte headers; width is padded to a multiple of 32
    (RawData_Legacy.cpp:34-36). When add_offset_table is set, a trailing
    [u32 BE pos][0xFF] chunk table (one entry per `chunk_rows` rows) plus a
    0x00 guard byte is appended, enabling chunk-parallel decode
    (RawData_Legacy.cpp:452-469 parses it; the reference then ignores it).

    `coder` is the mutation-soak hook for noncanonical (bits, refs) per
    block (see _coded). Legacy headers are inline, so refs are capped at
    12 bits and bits at the 4-bit nibble (11-15 all decode as 16-bit BE,
    RawData_Legacy.cpp:395, :435-438).
    """
    image = np.asarray(image, dtype=np.uint16)
    h, w = image.shape
    padded_width = 32 * ((w + 31) // 32)
    if padded_width != w:
        pad = np.repeat(image[:, -1:], padded_width - w, axis=1)
        image = np.concatenate([image, pad], axis=1)

    # Inverse of legacy_interleave: pairs of (even, odd) 16-value blocks.
    pairs = image.reshape(h * (padded_width // 32), 16, 2)
    blocks = pairs.transpose(0, 2, 1).reshape(-1, 16).astype(np.int64)

    bits, refs, resid = _coded(blocks, coder, MODERN_REF_MAX)
    if np.any(refs > MODERN_REF_MAX) or np.any(refs < 0):
        raise MotionCamException("legacy reference exceeds 12 bits")
    if np.any(bits > 15):
        raise MotionCamException("legacy bits exceed the 4-bit header nibble")
    payloads = pack_blocks(resid.astype(np.uint16), bits, modern=False)

    out = bytearray()
    blocks_per_row = (padded_width // 32) * 2
    row_starts = []
    for i, payload in enumerate(payloads):
        if i % blocks_per_row == 0:
            row_starts.append(len(out))
        b0 = ((int(bits[i]) & 0x0F) << 4) | ((int(refs[i]) >> 8) & 0x0F)
        out += bytes((b0, int(refs[i]) & 0xFF)) + payload

    if add_offset_table:
        if chunk_rows is None:
            chunk_rows = max(1, h // 4)
        # Guard byte stops the backwards 0xFF walk at the table start.
        out += b"\x00"
        for row in range(0, h, chunk_rows):
            if row == 0:
                continue
            out += struct.pack(">I", row_starts[row]) + b"\xff"
    else:
        # A trailing byte is mandatory: the reference bounds check is
        # `offset + 2 + len >= input_len` (strictly >=, RawData_Legacy.cpp
        # :398), so the final block only decodes if at least one byte follows
        # it. A 0x00 also stops the backwards 0xFF table walk (:455-469) from
        # misparsing payloads that end in 0xFF.
        out += b"\x00"
    return bytes(out)


def _json_bytes(metadata: dict | bytes) -> bytes:
    """dict -> serialized JSON; bytes pass through VERBATIM so tests and
    the mutation soak can author malformed / dialect-edge JSON text."""
    if isinstance(metadata, (bytes, bytearray)):
        return bytes(metadata)
    return json.dumps(metadata).encode()


class ContainerWriter:
    """Writes a valid version-3 .mcraw container (inverse of Decoder::init)."""

    def __init__(self, container_metadata: dict | bytes):
        self._out = bytearray()
        self._out += C.HEADER_FMT.pack(C.CONTAINER_ID, C.CONTAINER_VERSION)
        self._item(C.ItemType.METADATA, _json_bytes(container_metadata))
        self._frame_offsets: list[tuple[int, int]] = []  # (offset, timestamp)
        self._audio_offsets: list[tuple[int, int]] = []
        self._finished = False

    def _item(self, t: C.ItemType, payload: bytes) -> None:
        self._out += C.ITEM_FMT.pack(int(t), len(payload))
        self._out += payload

    def add_frame(
        self, timestamp: int, payload: bytes, frame_metadata: dict | bytes
    ) -> None:
        self._frame_offsets.append((len(self._out), timestamp))
        self._item(C.ItemType.BUFFER, payload)
        self._item(C.ItemType.METADATA, _json_bytes(frame_metadata))

    def add_audio(
        self, samples: np.ndarray, timestamp_ns: int | None = None
    ) -> None:
        """Interleaved int16 samples; omit timestamp_ns to emulate older
        recordings that lack the AUDIO_DATA_METADATA item (Decoder.cpp:63-70).
        """
        ts = 0 if timestamp_ns is None else timestamp_ns
        self._audio_offsets.append((len(self._out), ts))
        self._item(
            C.ItemType.AUDIO_DATA, np.asarray(samples, dtype="<i2").tobytes()
        )
        if timestamp_ns is not None:
            self._item(
                C.ItemType.AUDIO_DATA_METADATA,
                C.AUDIO_METADATA_FMT.pack(timestamp_ns),
            )

    def finish(self) -> bytes:
        if self._finished:
            raise MotionCamException("already finished")
        self._finished = True

        # AUDIO_INDEX must be reachable from the last frame's offset by the
        # item walk in readExtra (Decoder.cpp:281-315).
        audio_arr = np.array(
            self._audio_offsets or np.empty(0), dtype=np.int64
        ).reshape(-1, 2)
        audio_payload = C.AUDIO_INDEX_FMT.pack(len(audio_arr), 0) + b"".join(
            C.BUFFER_OFFSET_FMT.pack(int(o), int(ts)) for o, ts in audio_arr
        )
        self._item(C.ItemType.AUDIO_INDEX, audio_payload)

        # Frame index data, preceded by a BUFFER_INDEX_DATA item header so
        # the readExtra walk terminates cleanly on an unknown-but-valid tag.
        index_payload = b"".join(
            C.BUFFER_OFFSET_FMT.pack(o, ts) for o, ts in self._frame_offsets
        )
        index_data_offset = len(self._out) + C.ITEM_FMT.size
        self._item(C.ItemType.BUFFER_INDEX_DATA, index_payload)

        self._out += C.ITEM_FMT.pack(
            int(C.ItemType.BUFFER_INDEX), C.BUFFER_INDEX_FMT.size
        )
        self._out += C.BUFFER_INDEX_FMT.pack(
            C.INDEX_MAGIC_I32,
            len(self._frame_offsets),
            index_data_offset,
        )
        return bytes(self._out)


# -- seeded synthetic content (tests, chip_smoke.py, bench.py) ---------------

SYNTHETIC_KINDS = ("mix12", "worst", "all16")


def synthetic_plane(kind: str, height: int, width: int, seed: int) -> np.ndarray:
    """A seeded (H, W) uint16 source plane of one content mix:

    - ``mix12``: a smooth 12-bit scene plus sensor noise (typical content);
    - ``worst``: full-range noise plus one 5-bit tile — the slowest mix the
      format can force (every class path live, near-maximal payload);
    - ``all16``: full-range noise, every block at 16 bits.
    """
    rng = np.random.default_rng(seed)
    if kind == "mix12":
        k = seed % 16
        base = (
            np.sin(np.arange(width) / (97 + k))[None, :]
            * np.cos(np.arange(height) / (61 + k))[:, None] * 1200 + 2000
        )
        return (base + rng.normal(0, 30, size=(height, width))).clip(
            0, 4095
        ).astype(np.uint16)
    if kind not in SYNTHETIC_KINDS:
        raise ValueError(f"unknown content kind {kind!r}")
    img = rng.integers(0, 1 << 16, size=(height, width), dtype=np.uint16)
    if kind == "worst":
        img[0:4, 0:64] = rng.integers(0, 32, size=(4, 64), dtype=np.uint16)
    return img


def encode_synthetic(job: tuple) -> bytes:
    """Encode one ``(kind, height, width, seed, codec)`` synthetic plane."""
    kind, height, width, seed, codec = job
    img = synthetic_plane(kind, height, width, seed)
    return encode_modern(img) if codec == 7 else encode_legacy(img)


def encode_synthetic_many(jobs: list[tuple], workers: int | None = None):
    """:func:`encode_synthetic` over many jobs in spawned worker processes
    (a 4K frame takes seconds to encode). The workers import no JAX, so a
    caller that holds a GPU keeps it to itself. Returns payloads in job
    order."""
    import os
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    workers = workers or min(16, os.cpu_count() or 1)
    with ProcessPoolExecutor(
        max_workers=workers, mp_context=get_context("spawn")
    ) as pool:
        return list(pool.map(encode_synthetic, jobs))
