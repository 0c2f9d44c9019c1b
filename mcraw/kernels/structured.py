"""Gather-free per-class unpack: slices, reshapes, shifts — integer code only.

The table-driven unpack (unpack.py::_class_unpack) expresses each class as
constant lane-gathers, which XLA lowers to real gather ops — slow to
compile and slow to run. Every class layout is actually *structured* (it came
from SIMD code operating on 8-byte vectors), so each decodes with static
slices and broadcasting only. These functions are the hot versions; tests
pin them to the table-driven forms.

All functions take int32 windows (N, MAX_LEN) and return int32 (N, BLOCK).
"""

from __future__ import annotations

import jax.numpy as jnp


# -- modern codec (64 outputs; layouts from RawData.cpp:112-408) -------------


def _m1(w):
    b = w[:, :8]  # (N, 8)
    m = jnp.arange(8, dtype=jnp.int32).reshape(1, 8, 1)
    return ((b[:, None, :] >> m) & 1).reshape(-1, 64)


def _m2(w):
    b = w[:, :16].reshape(-1, 2, 1, 8)
    m = (2 * jnp.arange(4, dtype=jnp.int32)).reshape(1, 1, 4, 1)
    return ((b >> m) & 3).reshape(-1, 64)


def _m3(w):
    p0, p1, p2 = w[:, :8], w[:, 8:16], w[:, 16:24]
    rows = [
        p0 & 7,
        (p0 >> 3) & 7,
        ((p0 >> 6) & 3) | (((p2 >> 6) & 1) << 2),
        p1 & 7,
        (p1 >> 3) & 7,
        ((p1 >> 6) & 3) | (((p2 >> 7) & 1) << 2),
        p2 & 7,
        (p2 >> 3) & 7,
    ]
    return jnp.concatenate(rows, axis=1)


def _m4(w):
    b = w[:, :32].reshape(-1, 4, 1, 8)
    m = (4 * jnp.arange(2, dtype=jnp.int32)).reshape(1, 1, 2, 1)
    return ((b >> m) & 15).reshape(-1, 64)


def _m5(w):
    p0, p1, p2 = w[:, :8], w[:, 8:16], w[:, 16:24]
    p3, p4 = w[:, 24:32], w[:, 32:40]
    rows = [
        p0 & 31,
        p1 & 31,
        p2 & 31,
        p3 & 31,
        p4 & 31,
        ((p0 >> 5) & 7) | (((p3 >> 5) & 3) << 3),
        ((p1 >> 5) & 7) | (((p4 >> 5) & 3) << 3),
        ((p2 >> 5) & 7) | (((p3 >> 7) & 1) << 3) | (((p4 >> 7) & 1) << 4),
    ]
    return jnp.concatenate(rows, axis=1)


def _m6(w):
    p = [w[:, 8 * k : 8 * k + 8] for k in range(6)]
    rows = [x & 63 for x in p]
    rows.append(
        ((p[0] >> 6) & 3) | (((p[1] >> 6) & 3) << 2) | (((p[2] >> 6) & 3) << 4)
    )
    rows.append(
        ((p[3] >> 6) & 3) | (((p[4] >> 6) & 3) << 2) | (((p[5] >> 6) & 3) << 4)
    )
    return jnp.concatenate(rows, axis=1)


def _m8(w):
    return w[:, :64]


def _m10(w):
    lo1 = w[:, :32].reshape(-1, 4, 8)
    hi1 = w[:, 32:40]
    lo2 = w[:, 40:72].reshape(-1, 4, 8)
    hi2 = w[:, 72:80]
    m = (2 * jnp.arange(4, dtype=jnp.int32)).reshape(1, 4, 1)
    out1 = lo1 | (((hi1[:, None, :] >> m) & 3) << 8)
    out2 = lo2 | (((hi2[:, None, :] >> m) & 3) << 8)
    return jnp.concatenate([out1.reshape(-1, 32), out2.reshape(-1, 32)], axis=1)


def _m16(w):
    b = w[:, :128].reshape(-1, 64, 2)
    return b[:, :, 0] | (b[:, :, 1] << 8)


# class id -> fn, in MODERN_CLASSES order (class 0 omitted: contributes zeros)
MODERN_STRUCTURED = {
    1: _m1, 2: _m2, 3: _m3, 4: _m4, 5: _m5, 6: _m6, 8: _m8, 10: _m10, 16: _m16,
}


# -- legacy codec (16 outputs; layouts from RawData_Legacy.cpp:38-370) --------


def _l1(w):
    b = w[:, :2]
    m = (7 - jnp.arange(8, dtype=jnp.int32)).reshape(1, 1, 8)
    return ((b[:, :, None] >> m) & 1).reshape(-1, 16)


def _l2(w):
    b = w[:, :4]
    m = (6 - 2 * jnp.arange(4, dtype=jnp.int32)).reshape(1, 1, 4)
    return ((b[:, :, None] >> m) & 3).reshape(-1, 16)


def _l3(w):
    B = w[:, :6].reshape(-1, 2, 3)
    b0, b1, b2 = B[:, :, 0], B[:, :, 1], B[:, :, 2]
    outs = [
        (b0 >> 5) & 7,
        (b0 >> 2) & 7,
        ((b0 & 3) << 1) | ((b1 >> 7) & 1),
        (b1 >> 4) & 7,
        (b1 >> 1) & 7,
        ((b1 & 1) << 2) | ((b2 >> 6) & 3),
        (b2 >> 3) & 7,
        b2 & 7,
    ]
    return jnp.stack(outs, axis=2).reshape(-1, 16)


def _l4(w):
    b = w[:, :8]
    return jnp.stack([(b >> 4) & 15, b & 15], axis=2).reshape(-1, 16)


def _l5(w):
    B = w[:, :10].reshape(-1, 2, 5)
    b = [B[:, :, i] for i in range(5)]
    outs = [
        (b[0] >> 3) & 31,
        ((b[0] & 7) << 2) | ((b[1] >> 6) & 3),
        (b[1] >> 1) & 31,
        ((b[1] & 1) << 4) | ((b[2] >> 4) & 15),
        ((b[2] & 15) << 1) | ((b[3] >> 7) & 1),
        (b[3] >> 2) & 31,
        ((b[3] & 3) << 3) | ((b[4] >> 5) & 7),
        b[4] & 31,
    ]
    return jnp.stack(outs, axis=2).reshape(-1, 16)


def _l6(w):
    B = w[:, :12].reshape(-1, 4, 3)
    b0, b1, b2 = B[:, :, 0], B[:, :, 1], B[:, :, 2]
    outs = [
        (b0 >> 2) & 63,
        ((b0 & 3) << 4) | ((b1 >> 4) & 15),
        ((b1 & 15) << 2) | ((b2 >> 6) & 3),
        b2 & 63,
    ]
    return jnp.stack(outs, axis=2).reshape(-1, 16)


def _l7(w):
    B = w[:, :14].reshape(-1, 2, 7)
    b = [B[:, :, i] for i in range(7)]
    outs = [
        (b[0] >> 1) & 0x7F,
        ((b[0] & 1) << 6) | ((b[1] >> 2) & 0x3F),
        ((b[1] & 3) << 5) | ((b[2] >> 3) & 0x1F),
        ((b[2] & 7) << 4) | ((b[3] >> 4) & 0x0F),
        ((b[3] & 15) << 3) | ((b[4] >> 5) & 0x07),
        ((b[4] & 31) << 2) | ((b[5] >> 6) & 0x03),
        ((b[5] & 63) << 1) | ((b[6] >> 7) & 0x01),
        b[6] & 0x7F,
    ]
    return jnp.stack(outs, axis=2).reshape(-1, 16)


def _l8(w):
    return w[:, :16]


def _l9(w):
    B = w[:, :18].reshape(-1, 2, 9)
    b = [B[:, :, i] for i in range(9)]
    outs = [
        (b[0] << 1) | ((b[1] >> 7) & 1),
        ((b[1] & 0x7F) << 2) | ((b[2] >> 6) & 3),
        ((b[2] & 0x3F) << 3) | ((b[3] >> 5) & 7),
        ((b[3] & 0x1F) << 4) | ((b[4] >> 4) & 15),
        ((b[4] & 0x0F) << 5) | ((b[5] >> 3) & 0x1F),
        ((b[5] & 0x07) << 6) | ((b[6] >> 2) & 0x3F),
        ((b[6] & 0x03) << 7) | ((b[7] >> 1) & 0x7F),
        ((b[7] & 0x01) << 8) | b[8],
    ]
    return jnp.stack(outs, axis=2).reshape(-1, 16)


def _l10(w):
    B = w[:, :20].reshape(-1, 4, 5)
    b = [B[:, :, i] for i in range(5)]
    outs = [
        (b[0] << 2) | ((b[1] >> 6) & 3),
        ((b[1] & 0x3F) << 4) | ((b[2] >> 4) & 15),
        ((b[2] & 0x0F) << 6) | ((b[3] >> 2) & 0x3F),
        ((b[3] & 0x03) << 8) | b[4],
    ]
    return jnp.stack(outs, axis=2).reshape(-1, 16)


def _l16(w):
    b = w[:, :32].reshape(-1, 16, 2)
    return (b[:, :, 0] << 8) | b[:, :, 1]  # big-endian (RawData_Legacy.cpp:360-370)


LEGACY_STRUCTURED = {
    1: _l1, 2: _l2, 3: _l3, 4: _l4, 5: _l5, 6: _l6, 7: _l7, 8: _l8,
    9: _l9, 10: _l10, 16: _l16,
}
