"""Device (JAX/XLA) decode path for the MCRAW block codecs.

Decomposition (SURVEY.md §7): the serial, tiny parts run on the host — the
modern codec's two inline-header metadata streams and the legacy codec's
header chain — producing per-block ``(bits, reference, byte offset)`` arrays.
The massively parallel part, unpacking every block's payload bytes into
uint16 values, runs on the device as one fused XLA computation per frame (or
per batch of frames via vmap and a frame-sharded mesh):

    gather windows -> per-class branchless unpack -> select -> +ref
        -> Bayer de-interleave -> crop

Class-divergent control flow is computed vectorized: all (few) bit-width
classes are unpacked over every block and combined with a one-hot select.
The per-class unpack is integer shifts/masks/ORs driven by the shared field
tables, so the whole frame is one static-shape, integer-only program with no
data-dependent branching — exact on every backend.

The modern codec's block payload lengths are all multiples of 8
(RawData.cpp:27-45) and the main data starts at offset 16, so modern block
offsets are always 8-byte aligned — the window gather therefore moves
8-byte rows, not single bytes.

Padded payload lengths follow a fixed per-geometry ladder
(:func:`payload_bucket`): the jitted decode keys on the payload shape, so
one clip geometry compiles a handful of programs, not one per frame.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import tables as T
from . import numpy_ref as R
from ..errors import DecodeError

# -----------------------------------------------------------------------------
# Host-side preparation (serial, cheap; native C++ fast path when built)
# -----------------------------------------------------------------------------

# Rungs per geometry in the payload-length ladder. Frames of one clip vary by
# a few per cent in size, so they share one rung (one compiled program); a
# clip whose content class changes hops to a neighbouring rung.
PAYLOAD_BUCKETS = 8


def payload_bucket(need: int, full: int) -> int:
    """Smallest rung of the ladder ``k * step`` (step = full/8, 512-byte
    aligned) holding `need` bytes. `full` is the geometry's worst-case
    payload (every block at 16 bits), so a valid frame lands on one of
    PAYLOAD_BUCKETS rungs; oversized payloads (trailing bytes) extend the
    ladder by whole steps rather than failing."""
    step = -(-max(full, 1) // PAYLOAD_BUCKETS)
    step += (-step) % 512
    return -(-need // step) * step


def pad_or_window(
    payload: np.ndarray, size: int, window: np.ndarray | None = None
) -> np.ndarray:
    """A `size`-byte buffer whose head is `payload`: the zero-copy window
    slice when it covers `size`, else zeros + copy.

    Bytes past the payload are never addressed by any valid block, so the
    window's trailing container bytes are safe.
    """
    if window is not None and len(window) >= size:
        return np.asarray(window[:size], dtype=np.uint8)
    buf = np.zeros(size, dtype=np.uint8)
    buf[: len(payload)] = payload
    return buf


@dataclass(frozen=True)
class ModernPlan:
    """Device-ready arrays for one modern frame."""

    payload: np.ndarray  # (P,) uint8, 8-byte padded
    offsets: np.ndarray  # (N,) int32 byte offset of each main block
    cls: np.ndarray  # (N,) int32 index into MODERN_CLASSES
    refs: np.ndarray  # (N,) int32 block references
    tiles_y: int
    tiles_x: int
    width: int
    height: int


def prepare_modern(
    payload: np.ndarray,
    width: int,
    height: int,
    window: np.ndarray | None = None,
) -> ModernPlan:
    """Parse the modern payload's header + metadata streams (host side).

    The payload buffer is padded to its :func:`payload_bucket` rung.
    `window`, when given, is a read-only buffer that STARTS AT the payload
    and extends past it (e.g. the rest of the container mmap): if long
    enough it becomes the padded buffer zero-copy, eliding the ~15MB/frame
    pad memcpy entirely. Bytes past the payload are never addressed by any
    valid block, so their content is irrelevant.
    """
    payload = np.asarray(payload, dtype=np.uint8)
    n = len(payload)
    enc_w, enc_h, bits_off, refs_off = R.read_metadata_header(payload)
    if bits_off > n or refs_off > n:
        raise DecodeError("metadata offsets out of bounds")
    if enc_w % T.MODERN_BLOCK != 0:
        raise DecodeError("encoded width not a multiple of 64")
    if enc_w < width:
        raise DecodeError("encoded width smaller than width")

    from .native import decode_metadata_stream  # native C++ or numpy fallback

    bits, _ = decode_metadata_stream(payload, bits_off)
    refs, _ = decode_metadata_stream(payload, refs_off)

    tiles_y, tiles_x, num_blocks = R.modern_block_geometry(enc_w, enc_h)
    if len(bits) < num_blocks or len(refs) < num_blocks:
        raise DecodeError("metadata streams shorter than block count")
    bits = np.minimum(bits[:num_blocks].astype(np.int64), 16)

    lengths = T.MODERN_BLOCK_LENGTH[bits]
    offsets = R.METADATA_OFFSET + np.concatenate(
        ([0], np.cumsum(lengths, dtype=np.int64)[:-1])
    )
    if num_blocks and offsets[-1] + lengths[-1] > n:
        raise DecodeError("main data truncated")

    size = payload_bucket(
        n + (-n) % 8 + T.MODERN_MAX_LENGTH,
        R.METADATA_OFFSET + num_blocks * T.MODERN_MAX_LENGTH,
    )
    padded = pad_or_window(payload, size, window)
    return ModernPlan(
        payload=padded,
        offsets=offsets.astype(np.int32),
        cls=T.MODERN_CLASS_INDEX[bits].astype(np.int32),
        refs=refs[:num_blocks].astype(np.int32),
        tiles_y=tiles_y,
        tiles_x=tiles_x,
        width=width,
        height=height,
    )


@dataclass(frozen=True)
class LegacyPlan:
    payload: np.ndarray  # (P,) uint8 padded
    offsets: np.ndarray  # (N,) int32 payload offsets (past each header)
    cls: np.ndarray  # (N,) int32 index into LEGACY_CLASSES
    refs: np.ndarray  # (N,) int32
    padded_width: int
    width: int
    height: int


# Below this block count the serial scan is already < ~0.2 ms — thread
# dispatch overhead would dominate any chunk-parallel win.
LEGACY_PARALLEL_MIN_BLOCKS = 1 << 16


def prepare_legacy(
    payload: np.ndarray,
    width: int,
    height: int,
    window: np.ndarray | None = None,
) -> LegacyPlan:
    payload = np.asarray(payload, dtype=np.uint8)
    padded_width = R.legacy_padded_width(width)
    num_blocks = height * (padded_width // 32) * 2

    from . import native as _native

    # Chunk-parallel scan over the trailing offset table when present
    # (RawData_Legacy.cpp:452-469 — the format affordance the reference
    # parses and ignores; SURVEY.md §2.5 item 3); table-less or
    # bogus-table clips go through the SPECULATIVE parallel scan
    # (self-synchronizing header chain, native.legacy_scan_speculative).
    # Falls back to the serial walk for small frames / non-convergence.
    scanned = None
    if num_blocks >= LEGACY_PARALLEL_MIN_BLOCKS:
        chunks = R.legacy_chunk_offsets(payload)
        if chunks:
            scanned = _native.legacy_scan_parallel(
                payload, num_blocks, chunks
            )
        if scanned is None:
            scanned = _native.legacy_scan_speculative(payload, num_blocks)
    bits, refs, offs = scanned or _native.legacy_scan(payload, num_blocks)

    size = payload_bucket(
        len(payload) + T.LEGACY_MAX_LENGTH,
        num_blocks * (R.HEADER_LENGTH + T.LEGACY_MAX_LENGTH),
    )
    padded = pad_or_window(payload, size, window)
    return LegacyPlan(
        payload=padded,
        offsets=offs.astype(np.int32),
        cls=T.LEGACY_CLASS_INDEX[np.asarray(bits, dtype=np.int64)].astype(np.int32),
        refs=refs.astype(np.int32),
        padded_width=padded_width,
        width=width,
        height=height,
    )


# -----------------------------------------------------------------------------
# Device-side unpack
# -----------------------------------------------------------------------------


def _class_unpack(w: jnp.ndarray, cls_row: int, modern: bool) -> jnp.ndarray:
    """Branchless unpack of (N, MAX_LEN) int32 windows for one class.

    Field tables give, for output j and field f, a source byte position —
    a *constant* lane permutation — plus shift/mask constants. XLA folds the
    constant gathers; everything else is integer shifts/ands/ors.
    """
    if modern:
        pos, rsh, msk, lsh = T.MODERN_POS, T.MODERN_RSH, T.MODERN_MSK, T.MODERN_LSH
    else:
        pos, rsh, msk, lsh = T.LEGACY_POS, T.LEGACY_RSH, T.LEGACY_MSK, T.LEGACY_LSH
    out = None
    for f in range(pos.shape[2]):
        m = msk[cls_row, :, f]
        if not m.any():
            continue
        picked = jnp.take(w, jnp.asarray(pos[cls_row, :, f]), axis=1)
        part = (
            (picked >> jnp.asarray(rsh[cls_row, :, f])) & jnp.asarray(m)
        ) << jnp.asarray(lsh[cls_row, :, f])
        out = part if out is None else out | part
    if out is None:  # class 0: all zeros
        out = jnp.zeros(w.shape[:1] + (pos.shape[1],), dtype=w.dtype)
    return out


def unpack_select(
    w: jnp.ndarray, cls: jnp.ndarray, modern: bool, table_driven: bool = False
) -> jnp.ndarray:
    """(N, MAX_LEN) windows + per-block class -> (N, BLOCK) values.

    Computes every class's unpack and one-hot selects: ~10x the integer
    work of an oracle dispatch, but zero divergence and fully fusible.
    Uses the gather-free structured forms (structured.py);
    `table_driven=True` selects the table-generated reference forms (tests
    pin the two to each other).
    """
    from . import structured as S

    classes = T.MODERN_CLASSES if modern else T.LEGACY_CLASSES
    fns = S.MODERN_STRUCTURED if modern else S.LEGACY_STRUCTURED
    out = None
    for row, c in enumerate(classes):
        if c == 0:
            continue  # zero contribution
        if table_driven:
            vals = _class_unpack(w, row, modern)
        else:
            vals = fns[c](w)
        sel = (cls == row)[:, None]
        contrib = jnp.where(sel, vals, 0)
        out = contrib if out is None else out | contrib
    return out


def gather_windows_modern(payload: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """(P,) uint8 + (N,) 8-aligned offsets -> (N, 128) int32 windows."""
    rows = payload.reshape(-1, 8)
    row_idx = offsets[:, None] // 8 + jnp.arange(16)[None, :]  # (N, 16)
    g = jnp.take(rows, row_idx.reshape(-1), axis=0)  # (N*16, 8)
    return g.reshape(-1, 128).astype(jnp.int32)


def gather_windows_legacy(payload: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """Legacy offsets are odd-aligned (2-byte headers); gather single bytes."""
    idx = offsets[:, None] + jnp.arange(T.LEGACY_MAX_LENGTH)[None, :]
    return jnp.take(payload, idx.reshape(-1), axis=0).reshape(
        -1, T.LEGACY_MAX_LENGTH
    ).astype(jnp.int32)


def modern_deinterleave_jnp(
    vals: jnp.ndarray, refs: jnp.ndarray, tiles_y: int, tiles_x: int
) -> jnp.ndarray:
    """Bayer phase de-interleave; the jnp twin of the NumPy oracle's
    modern_deinterleave (RawData.cpp:581-593 made a layout transform)."""
    v = (vals + refs[:, None]) & 0xFFFF
    v = v.reshape(tiles_y, tiles_x, 2, 2, 2, 32)  # (ty, tx, q, c, h, k)
    v = v.transpose(0, 4, 2, 1, 5, 3)  # (ty, h, q, tx, k, c)
    return v.reshape(tiles_y * 4, tiles_x * 64)


def legacy_interleave_jnp(
    vals: jnp.ndarray, refs: jnp.ndarray, height: int, padded_width: int
) -> jnp.ndarray:
    v = (vals + refs[:, None]) & 0xFFFF
    v = v.reshape(height * (padded_width // 32), 2, 16).transpose(0, 2, 1)
    return v.reshape(height, padded_width)


@functools.partial(
    jax.jit, static_argnames=("tiles_y", "tiles_x", "width", "height")
)
def decode_modern_device(
    payload: jnp.ndarray,
    offsets: jnp.ndarray,
    cls: jnp.ndarray,
    refs: jnp.ndarray,
    *,
    tiles_y: int,
    tiles_x: int,
    width: int,
    height: int,
) -> jnp.ndarray:
    w = gather_windows_modern(payload, offsets)
    vals = unpack_select(w, cls, modern=True)
    img = modern_deinterleave_jnp(vals, refs, tiles_y, tiles_x)
    return img[:height, :width].astype(jnp.uint16)


@functools.partial(
    jax.jit, static_argnames=("padded_width", "width", "height")
)
def decode_legacy_device(
    payload: jnp.ndarray,
    offsets: jnp.ndarray,
    cls: jnp.ndarray,
    refs: jnp.ndarray,
    *,
    padded_width: int,
    width: int,
    height: int,
) -> jnp.ndarray:
    w = gather_windows_legacy(payload, offsets)
    vals = unpack_select(w, cls, modern=False)
    img = legacy_interleave_jnp(vals, refs, height, padded_width)
    return img[:, :width].astype(jnp.uint16)


def geometry_kwargs(plan) -> dict:
    """The static geometry keywords of the device decode for one plan."""
    if isinstance(plan, ModernPlan):
        return dict(tiles_y=plan.tiles_y, tiles_x=plan.tiles_x,
                    width=plan.width, height=plan.height)
    return dict(padded_width=plan.padded_width, width=plan.width,
                height=plan.height)


def device_decoder(plan):
    """The jitted device decode for the plan's codec; call it with the
    plan's four arrays and ``**geometry_kwargs(plan)``."""
    if isinstance(plan, ModernPlan):
        return decode_modern_device
    return decode_legacy_device


# -----------------------------------------------------------------------------
# Convenience single-frame entry points (host prep + device unpack)
# -----------------------------------------------------------------------------


def decode_modern(payload: np.ndarray, width: int, height: int) -> jax.Array:
    p = prepare_modern(payload, width, height)
    return decode_modern_device(
        jnp.asarray(p.payload),
        jnp.asarray(p.offsets),
        jnp.asarray(p.cls),
        jnp.asarray(p.refs),
        tiles_y=p.tiles_y,
        tiles_x=p.tiles_x,
        width=width,
        height=height,
    )


def decode_legacy(payload: np.ndarray, width: int, height: int) -> jax.Array:
    p = prepare_legacy(payload, width, height)
    return decode_legacy_device(
        jnp.asarray(p.payload),
        jnp.asarray(p.offsets),
        jnp.asarray(p.cls),
        jnp.asarray(p.refs),
        padded_width=p.padded_width,
        width=width,
        height=height,
    )
