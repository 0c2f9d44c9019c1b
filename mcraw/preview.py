"""On-device preview pipeline: packed payload -> display-ready RGB.

New capability beyond the reference (BASELINE config 5 — live RAW playback):
decode -> black/white normalize -> white balance -> demosaic (mask-normalized
bilinear, or Malvar-He-Cutler) -> camera->sRGB color transform -> gamma, all
in jitted `jax.numpy` programs, so XLA fuses the epilogue and the frame never
round-trips to the host between stages.

Color model: full dual-illuminant DNG rendering math — the camera->XYZ(D50)
forward matrix is interpolated between forwardMatrix1 (D65) and
forwardMatrix2 (Standard A) at the as-shot white point's correlated color
temperature, with the DNG spec's self-consistent white-point iteration
(mcraw/color.py; the reference example only *copies* both matrix pairs
into DNG tags, example.cpp:69-72 + :117-124 — consumers do this math).
Then Bradford D50->D65 adaptation and the sRGB primaries matrix. The one
remaining simplification: no ProfileHueSatMap/LookTable handling — the
container format carries no such tags, so there is nothing to apply.

Precision: the develop runs in float32. Its one matrix product (the 3x3
color matrices) is taken at Precision.HIGHEST, because a float32 product on
a GPU may otherwise run in TF32; the per-pixel color transform is
elementwise scalar arithmetic. Against the float64 scalar model
(:func:`develop_f64`) every 8-bit channel stays within 1 LSB — float32
rounding against float64, and `pow` in the sRGB curve, can move a value
that sits on a rounding boundary. tests/test_preview.py pins the bound.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .metadata import ContainerMetadata, FrameMetadata

# XYZ (D50) -> linear sRGB (D65), Bradford-adapted.
_XYZ_D50_TO_SRGB = np.array(
    [
        [3.1338561, -1.6168667, -0.4906146],
        [-0.9787684, 1.9161415, 0.0334540],
        [0.0719453, -0.2289914, 1.4052427],
    ],
    dtype=np.float32,
)

# CFA channel index per 2x2 position, from the CFA pattern bytes
# (0=R, 1=G, 2=B; example.cpp:96-105).


def _phase_masks(height: int, width: int, cfa: tuple[int, ...]):
    """(3, H, W) one-hot masks for R/G/B sites of a 2x2 CFA."""
    yy = np.arange(height)[:, None] % 2
    xx = np.arange(width)[None, :] % 2
    chan = np.empty((height, width), dtype=np.int32)
    for py in range(2):
        for px in range(2):
            chan[(yy == py) & (xx == px)] = cfa[2 * py + px]
    return np.stack([(chan == c).astype(np.float32) for c in range(3)])


def _conv2same(x: jnp.ndarray, k: np.ndarray) -> jnp.ndarray:
    """Single-channel 3x3 'same' convolution (zero padded) as shifted
    adds, which XLA fuses into one elementwise pass."""
    h, w = x.shape
    p = jnp.pad(x, 1)
    acc = None
    for dy in range(3):
        for dx in range(3):
            wgt = float(k[dy, dx])
            if wgt == 0.0:
                continue
            t = p[dy : dy + h, dx : dx + w]
            t = t * wgt if wgt != 1.0 else t
            acc = t if acc is None else acc + t
    return acc


_K_CROSS = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=np.float32)
_K_FULL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float32)

def _np_conv2same(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    h, w = x.shape
    p = np.pad(x, 1)
    acc = np.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            if k[dy, dx]:
                acc += k[dy, dx] * p[dy : dy + h, dx : dx + w]
    return acc


def _malvar_f64(x: np.ndarray, chan: np.ndarray, hc: np.ndarray):
    """Malvar-He-Cutler 5x5 gradient-corrected demosaic on a
    white-balanced mosaic (float64, zero-padded taps, per-pixel
    site-class select). Returns (R, G, B) planes (unclipped).

    x: normalized+WB mosaic; chan: per-site channel (0/1/2); hc: channel
    of the HORIZONTALLY adjacent site (disambiguates the two G phases).
    """
    h, w = x.shape
    p = np.pad(x, 2)

    def sh(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    h1 = sh(0, 1) + sh(0, -1)
    v1 = sh(1, 0) + sh(-1, 0)
    h2 = sh(0, 2) + sh(0, -2)
    v2 = sh(2, 0) + sh(-2, 0)
    d1 = sh(1, 1) + sh(1, -1) + sh(-1, 1) + sh(-1, -1)
    # The four MHC estimators (x 1/8): G at a chroma site; chroma with
    # its same-color neighbors in-ROW; in-COLUMN; and diagonal.
    k1 = (4.0 * x + 2.0 * (h1 + v1) - (h2 + v2)) * 0.125
    k2 = (5.0 * x + 4.0 * h1 - d1 - h2 + 0.5 * v2) * 0.125
    k3 = (5.0 * x + 4.0 * v1 - d1 - v2 + 0.5 * h2) * 0.125
    k4 = (6.0 * x + 2.0 * d1 - 1.5 * (h2 + v2)) * 0.125

    g = np.where(chan == 1, x, k1)
    r = np.where(
        chan == 0, x,
        np.where(chan == 1, np.where(hc == 0, k2, k3), k4),
    )
    b = np.where(
        chan == 2, x,
        np.where(chan == 1, np.where(hc == 2, k2, k3), k4),
    )
    return r, g, b


def develop_f64(raw, black, white, neutral, fwd, cfa,
                demosaic: str = "bilinear") -> np.ndarray:
    """Scalar float64 model of the EXACT preview pipeline (normalize ->
    WB folded into the demosaic normalizer -> mask-normalized bilinear
    demosaic -> fwd matrix -> XYZ(D50)->sRGB -> gamma -> quantize).
    Returns (H, W, 3) int64 u8 channel values.

    demosaic="malvar": the Malvar-He-Cutler 5x5 gradient-corrected
    kernels instead of bilinear. WB is applied BEFORE the demosaic (the
    MHC correction terms mix channels, so the gains must be on-site);
    border taps are zero-padded (the 2px ring is clip-darkened — the
    device develop implements identical semantics). Bilinear keeps its original
    WB-after-normalized-conv form (channels never mix there).

    This is the ground truth the device develop is bounded against
    (<= 1 LSB per channel): tests/test_preview.py pins the bound on small
    frames, and chip_smoke.py re-checks full 4K frames on the GPU."""
    h, w = raw.shape
    yy = np.arange(h)[:, None] % 2
    xx = np.arange(w)[None, :] % 2
    b = np.asarray(black, np.float64)
    bl = np.where(yy == 0, np.where(xx == 0, b[0], b[1]),
                  np.where(xx == 0, b[2], b[3]))
    x = np.clip((raw.astype(np.float64) - bl) / (float(white) - bl), 0, 1)
    gains = 1.0 / np.asarray(neutral, np.float64)
    if demosaic == "malvar":
        cfa = tuple(cfa)
        pos = yy * 2 + xx
        chan = np.choose(pos, cfa)
        hc = np.choose(pos ^ 1, cfa)
        xm = x * gains[chan]
        r, g, gb = _malvar_f64(xm, chan, hc)
        rgb = np.clip(np.stack([r, g, gb], -1), 0, 1)
    else:
        masks = _phase_masks(h, w, tuple(cfa)).astype(np.float64)
        chans = []
        for c, k in ((0, _K_FULL), (1, _K_CROSS), (2, _K_FULL)):
            k = k.astype(np.float64)
            num = _np_conv2same(x * masks[c], k)
            den = _np_conv2same(masks[c], k)
            chans.append(num / den * gains[c])
        rgb = np.clip(np.stack(chans, -1), 0, 1)
    m = _XYZ_D50_TO_SRGB.astype(np.float64) @ np.asarray(fwd, np.float64)
    rgb = np.clip(rgb @ m.T, 0, 1)
    rgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                   1.055 * np.power(rgb, 1 / 2.4) - 0.055)
    return np.round(np.clip(rgb, 0, 1) * 255.0).astype(np.int64)


def _site_channel(y_even, x_even, cfa: tuple[int, ...]):
    """CFA channel of each site from its row/column parity."""
    return jnp.where(
        y_even,
        jnp.where(x_even, cfa[0], cfa[1]),
        jnp.where(x_even, cfa[2], cfa[3]),
    )


def _mask_normalizer(height: int, width: int, cfa: tuple[int, ...],
                     c: int, k: np.ndarray) -> jnp.ndarray:
    """conv2same(mask_c, k) in closed form, built from iotas in-graph.

    Each tap's shifted mask is a parity select and the zero padding an
    in-range test, so the normalizer costs a few fused integer ops per
    pixel instead of a stored (3, H, W) table. The sums are small exact
    integers in float32, so the result equals the table bit for bit."""
    y = jnp.arange(height)[:, None]
    x = jnp.arange(width)[None, :]
    den = None
    for dy in range(3):
        for dx in range(3):
            wgt = float(k[dy, dx])
            if wgt == 0.0:
                continue
            yy, xx = y + (dy - 1), x + (dx - 1)
            hit = (
                (_site_channel(yy % 2 == 0, xx % 2 == 0, cfa) == c)
                & (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
            )
            t = jnp.where(hit, jnp.float32(wgt), jnp.float32(0.0))
            den = t if den is None else den + t
    return den


def _bilinear(x, chan, gains, height, width, cfa):
    """Mask-normalized bilinear demosaic; white balance (per-channel
    gains) folds into the normalizer, since it commutes with the
    per-channel linear conv. Returns (H, W, 3)."""
    out = []
    for c, k in ((0, _K_FULL), (1, _K_CROSS), (2, _K_FULL)):
        num = _conv2same(jnp.where(chan == c, x, 0.0), k)
        inv = 1.0 / _mask_normalizer(height, width, cfa, c, k)
        out.append(num * (inv * gains[c]))
    return jnp.stack(out, axis=-1)


def _malvar(xm, chan, hc):
    """Malvar-He-Cutler 5x5 gradient-corrected demosaic, the float32
    twin of _malvar_f64 (same estimators, zero-padded taps, per-site
    class select) on a white-balanced mosaic. Returns (H, W, 3)."""
    h, w = xm.shape
    p = jnp.pad(xm, 2)

    def sh(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    h1 = sh(0, 1) + sh(0, -1)
    v1 = sh(1, 0) + sh(-1, 0)
    h2 = sh(0, 2) + sh(0, -2)
    v2 = sh(2, 0) + sh(-2, 0)
    d1 = sh(1, 1) + sh(1, -1) + sh(-1, 1) + sh(-1, -1)
    k1 = (4.0 * xm + 2.0 * (h1 + v1) - (h2 + v2)) * 0.125
    k2 = (5.0 * xm + 4.0 * h1 - d1 - h2 + 0.5 * v2) * 0.125
    k3 = (5.0 * xm + 4.0 * v1 - d1 - v2 + 0.5 * h2) * 0.125
    k4 = (6.0 * xm + 2.0 * d1 - 1.5 * (h2 + v2)) * 0.125

    g = jnp.where(chan == 1, xm, k1)
    r = jnp.where(
        chan == 0, xm,
        jnp.where(chan == 1, jnp.where(hc == 0, k2, k3), k4),
    )
    b = jnp.where(
        chan == 2, xm,
        jnp.where(chan == 1, jnp.where(hc == 2, k2, k3), k4),
    )
    return jnp.stack([r, g, b], axis=-1)


def color_matrix(forward_matrix: jnp.ndarray) -> jnp.ndarray:
    """Camera -> linear sRGB: XYZ(D50)->sRGB times the forward matrix, at
    Precision.HIGHEST (a float32 product may otherwise run in TF32)."""
    return jnp.matmul(
        jnp.asarray(_XYZ_D50_TO_SRGB),
        forward_matrix.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )


@functools.partial(
    jax.jit, static_argnames=("height", "width", "cfa", "demosaic")
)
def develop(
    raw_u16: jnp.ndarray,
    black_level: jnp.ndarray,  # (4,) per CFA position
    white_level: jnp.ndarray,  # scalar
    as_shot_neutral: jnp.ndarray,  # (3,)
    forward_matrix: jnp.ndarray,  # (3, 3) camera -> XYZ D50
    *,
    height: int,
    width: int,
    cfa: tuple[int, ...],
    demosaic: str = "bilinear",
) -> jnp.ndarray:
    """(H, W) uint16 Bayer -> (H, W, 3) uint8 sRGB preview.

    demosaic: "bilinear" (mask-normalized) or "malvar" (Malvar-He-Cutler
    5x5 gradient-corrected; white balance applied before the demosaic,
    since its correction terms mix channels). Masks, per-site levels and
    normalizers are all built in-graph from parity iotas.
    """
    if demosaic not in ("bilinear", "malvar"):
        raise ValueError(f"unknown demosaic {demosaic!r}")
    y_even = jnp.arange(height)[:, None] % 2 == 0
    x_even = jnp.arange(width)[None, :] % 2 == 0
    chan = _site_channel(y_even, x_even, cfa)

    # Per-site black level (blackLevel is 2x2, BlackLevelRepeatDim 2x2) and
    # the per-site reciprocal of (white - black), arranged by parity selects.
    b = black_level.astype(jnp.float32)
    wf = white_level.astype(jnp.float32)
    bl = jnp.where(
        y_even,
        jnp.where(x_even, b[0], b[1]),
        jnp.where(x_even, b[2], b[3]),
    )
    inv_scale = jnp.where(
        y_even,
        jnp.where(x_even, 1.0 / (wf - b[0]), 1.0 / (wf - b[1])),
        jnp.where(x_even, 1.0 / (wf - b[2]), 1.0 / (wf - b[3])),
    )
    x = jnp.clip((raw_u16.astype(jnp.float32) - bl) * inv_scale, 0.0, 1.0)

    # White balance: divide by AsShotNeutral (G == 1).
    gains = 1.0 / as_shot_neutral.astype(jnp.float32)
    if demosaic == "malvar":
        site_gain = jnp.where(
            chan == 0, gains[0], jnp.where(chan == 1, gains[1], gains[2])
        )
        hc = _site_channel(y_even, ~x_even, cfa)
        rgb = _malvar(x * site_gain, chan, hc)
    else:
        rgb = _bilinear(x, chan, gains, height, width, cfa)
    rgb = jnp.clip(rgb, 0.0, 1.0)

    # Camera -> XYZ(D50) -> linear sRGB as elementwise scalar muls.
    m = color_matrix(forward_matrix)
    rgb = jnp.stack(
        [
            m[r, 0] * rgb[:, :, 0]
            + m[r, 1] * rgb[:, :, 1]
            + m[r, 2] * rgb[:, :, 2]
            for r in range(3)
        ],
        axis=-1,
    )
    rgb = jnp.clip(rgb, 0.0, 1.0)

    # sRGB transfer curve.
    rgb = jnp.where(
        rgb <= 0.0031308,
        12.92 * rgb,
        1.055 * jnp.power(rgb, 1.0 / 2.4) - 0.055,
    )
    return jnp.round(jnp.clip(rgb, 0.0, 1.0) * 255.0).astype(jnp.uint8)


def pack_rgba(rgb: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) uint8 -> (...) uint32 RGBA8888 with alpha 255."""
    r = rgb.astype(jnp.uint32)
    return (
        r[..., 0] | (r[..., 1] << 8) | (r[..., 2] << 16)
        | jnp.uint32(0xFF000000)
    )


@functools.partial(
    jax.jit, static_argnames=("height", "width", "cfa", "demosaic")
)
def develop_rgba(raw_u16, black_level, white_level, as_shot_neutral,
                 forward_matrix, *, height: int, width: int,
                 cfa: tuple[int, ...], demosaic: str = "bilinear"):
    """:func:`develop` packed to (H, W) uint32 RGBA8888."""
    return pack_rgba(
        develop.__wrapped__(
            raw_u16, black_level, white_level, as_shot_neutral,
            forward_matrix, height=height, width=width, cfa=cfa,
            demosaic=demosaic,
        )
    )


@functools.partial(
    jax.jit, static_argnames=("height", "width", "cfa", "demosaic")
)
def develop_rgba_batch(raws, black_level, white_level, as_shot_neutrals,
                       forward_matrices, *, height: int, width: int,
                       cfa: tuple[int, ...], demosaic: str = "bilinear"):
    """(F, H, W) frames -> (F, H, W) RGBA8888 in one program (vmap of
    :func:`develop_rgba`). Levels are per container; neutrals (F, 3) and
    forward matrices (F, 3, 3) are per frame."""
    one = functools.partial(
        develop_rgba.__wrapped__, height=height, width=width, cfa=cfa,
        demosaic=demosaic,
    )
    return jax.vmap(one, in_axes=(0, None, None, 0, 0))(
        raws, black_level, white_level, as_shot_neutrals, forward_matrices
    )


def _frame_params(fm: FrameMetadata, cm: ContainerMetadata):
    """(black, white, neutral, forward matrix) for one frame, host-side."""
    from .color import interpolated_matrices

    fwd, _, _ = interpolated_matrices(cm, fm.as_shot_neutral)
    return (
        np.asarray(cm.black_level, np.float32),
        np.float32(cm.white_level),
        np.asarray(fm.as_shot_neutral, np.float32),
        fwd.astype(np.float32),
    )


def preview_frame_rgba(decoder, timestamp: int,
                       demosaic: str = "bilinear") -> jax.Array:
    """Decode + develop on-device; returns (H, W) uint32 RGBA8888."""
    img, meta = decoder.load_frame_device(timestamp)
    cm = ContainerMetadata(decoder.container_metadata)
    fm = FrameMetadata(meta)
    return develop_rgba(
        img, *map(jnp.asarray, _frame_params(fm, cm)),
        height=fm.height, width=fm.width, cfa=tuple(cm.cfa_pattern),
        demosaic=demosaic,
    )


def preview_frame(decoder, timestamp: int,
                  demosaic: str = "bilinear") -> jax.Array:
    """Decode + develop one frame fully on-device; returns (H, W, 3) uint8.
    Prefer preview_frame_rgba for playback (one packed plane per frame)."""
    rgba = preview_frame_rgba(decoder, timestamp, demosaic=demosaic)
    return jnp.stack(
        [
            (rgba & 0xFF).astype(jnp.uint8),
            ((rgba >> 8) & 0xFF).astype(jnp.uint8),
            ((rgba >> 16) & 0xFF).astype(jnp.uint8),
        ],
        axis=-1,
    )


def preview_clip(decoder, timestamps=None, batch_frames: int = 8,
                 demosaic: str = "bilinear"):
    """Playback pipeline: yields (timestamp, (H, W) uint32 RGBA8888 device
    array) for each frame, decoding in batched launches and developing
    each batch in one vmapped program. The whole chain stays on device; a
    display loop reads back or blits each RGBA plane."""
    if timestamps is None:
        timestamps = decoder.frames
    cm = ContainerMetadata(decoder.container_metadata)
    cfa = tuple(cm.cfa_pattern)
    i = 0
    for imgs, metas in decoder.decode_batch_iter(
        timestamps, chunk_frames=batch_frames
    ):
        fms = [FrameMetadata(m) for m in metas]
        params = [_frame_params(fm, cm) for fm in fms]
        rgba = develop_rgba_batch(
            imgs,
            jnp.asarray(params[0][0]),
            jnp.asarray(params[0][1]),
            jnp.asarray(np.stack([p[2] for p in params])),
            jnp.asarray(np.stack([p[3] for p in params])),
            height=fms[0].height, width=fms[0].width, cfa=cfa,
            demosaic=demosaic,
        )
        for k in range(len(fms)):
            yield timestamps[i], rgba[k]
            i += 1
