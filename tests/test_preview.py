"""Preview (decode -> demosaic -> tonemap) pipeline sanity tests."""

import numpy as np
import pytest

pytest.importorskip("jax")

from mcraw import encode as E  # noqa: E402
from mcraw.metadata import (  # noqa: E402
    example_container_metadata,
    example_frame_metadata,
)
from mcraw.pipeline import Decoder  # noqa: E402
from mcraw.preview import preview_frame  # noqa: E402


def _clip_with_flat_color(r, g, b, sensor="rggb", h=16, w=64):
    """A constant-color Bayer mosaic (values already white-balanced away)."""
    cm = example_container_metadata(
        sensor=sensor, black_level=(0, 0, 0, 0), white_level=1023.0
    )
    # A white-preserving forward matrix: camera (1,1,1) -> XYZ of D50 white.
    # (An identity matrix is not white-preserving — equal XYZ is not white.)
    # BOTH illuminants' matrices, so the dual-illuminant interpolation
    # (mcraw/color.py) is white-preserving at any as-shot CCT.
    cm["forwardMatrix1"] = [0.9642, 0, 0, 0, 1.0, 0, 0, 0, 0.8249]
    cm["forwardMatrix2"] = cm["forwardMatrix1"]
    writer = E.ContainerWriter(cm)
    img = np.zeros((h, w), dtype=np.uint16)
    from mcraw.metadata import CFA_PATTERNS

    cfa = CFA_PATTERNS[sensor]
    vals = {0: r, 1: g, 2: b}
    for py in range(2):
        for px in range(2):
            img[py::2, px::2] = vals[cfa[2 * py + px]]
    fm = example_frame_metadata(w, h)
    fm["asShotNeutral"] = [1.0, 1.0, 1.0]
    writer.add_frame(1, E.encode_modern(img), fm)
    return writer.finish()


def test_flat_grey_is_grey():
    blob = _clip_with_flat_color(512, 512, 512)
    d = Decoder(blob, backend="jax")
    rgb = np.asarray(preview_frame(d, 1))
    assert rgb.shape == (16, 64, 3)
    assert rgb.dtype == np.uint8
    inner = rgb[2:-2, 2:-2]
    # identity forward matrix -> grey stays grey and channels stay equal
    assert np.all(np.abs(inner.astype(int) - inner[:, :, :1].astype(int)) <= 1)
    # ~sqrt-ish sRGB curve of 0.5 is ~188
    assert 170 <= int(inner.mean()) <= 200


def test_pure_red_scene():
    blob = _clip_with_flat_color(800, 0, 0)
    d = Decoder(blob, backend="jax")
    rgb = np.asarray(preview_frame(d, 1))
    inner = rgb[2:-2, 2:-2]
    assert inner[:, :, 0].mean() > 3 * max(1.0, inner[:, :, 2].mean())


def test_cfa_patterns_consistent():
    """The same physical scene must develop identically under every CFA."""
    outs = []
    for sensor in ["rggb", "bggr", "grbg", "gbrg"]:
        blob = _clip_with_flat_color(600, 300, 150, sensor=sensor)
        d = Decoder(blob, backend="jax")
        outs.append(np.asarray(preview_frame(d, 1))[4:-4, 4:-4].astype(int))
    for other in outs[1:]:
        assert np.max(np.abs(outs[0] - other)) <= 1


_BLACK = np.array([16, 20, 24, 28], np.float32)
_NEUTRAL = np.array([0.55, 1.0, 0.71], np.float32)
_FWD = np.array(
    [0.6, 0.2, 0.16, 0.25, 0.7, 0.05, 0.02, 0.18, 0.62], np.float32
).reshape(3, 3)


def _rgb_of(rgba):
    rgba = np.asarray(rgba)
    return np.stack(
        [rgba & 0xFF, (rgba >> 8) & 0xFF, (rgba >> 16) & 0xFF], axis=-1
    ).astype(np.int64)


def test_fused_rgba_matches_xla_develop():
    """develop_rgba == develop packed to RGBA8888 (alpha 255), and both
    sit within 1 LSB of the f64 model."""
    import jax.numpy as jnp
    from mcraw import preview as P

    rng = np.random.default_rng(5)
    h, w = 24, 256
    raw = rng.integers(0, 1024, size=(h, w), dtype=np.uint16)
    white = np.float32(1023.0)
    cfa = (0, 1, 1, 2)
    args = (jnp.asarray(raw), _BLACK, white, _NEUTRAL, _FWD)
    rgb = np.asarray(P.develop(*args, height=h, width=w, cfa=cfa))
    rgba = np.asarray(P.develop_rgba(*args, height=h, width=w, cfa=cfa))
    assert np.all((rgba >> 24) == 0xFF)
    assert np.array_equal(_rgb_of(rgba), rgb.astype(np.int64))
    want = P.develop_f64(raw, _BLACK, white, _NEUTRAL, _FWD, cfa)
    assert np.max(np.abs(rgb.astype(np.int64) - want)) <= 1


@pytest.mark.parametrize("sensor", ["rggb", "bggr", "grbg", "gbrg"])
def test_fused_rgba_all_cfas(sensor):
    """The develop handles every CFA within 1 LSB of the f64 model (odd
    height exercises the bottom border)."""
    import jax.numpy as jnp
    from mcraw import preview as P
    from mcraw.metadata import CFA_PATTERNS

    rng = np.random.default_rng(9)
    h, w = 30, 128
    raw = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    black = np.array([8, 10, 12, 14], np.float32)
    white = np.float32(4095.0)
    neutral = np.array([0.8, 1.0, 0.9], np.float32)
    fwd = np.array(
        [0.7, 0.15, 0.11, 0.2, 0.75, 0.05, 0.03, 0.12, 0.67], np.float32
    ).reshape(3, 3)
    cfa = tuple(CFA_PATTERNS[sensor])
    rgba = P.develop_rgba(
        jnp.asarray(raw), black, white, neutral, fwd,
        height=h, width=w, cfa=cfa,
    )
    want = P.develop_f64(raw, black, white, neutral, fwd, cfa)
    assert np.max(np.abs(_rgb_of(rgba) - want)) <= 1, sensor


@pytest.mark.parametrize(
    "shape,sensor",
    [
        ((24, 256), "rggb"),
        ((30, 100), "bggr"),  # odd height + ragged width
        ((66, 128), "grbg"),
    ],
)
def test_develop_inkernel_normalizer_bitwise_equals_table(shape, sensor):
    """The closed-form in-graph normalizer must be BITWISE equal to the
    conv(mask) table it replaced, not just <= 1 LSB: the conv over the 0/1
    mask sums small exact integers, so 1/den rounds identically. Any
    drift means the border or parity predicate is wrong."""
    from mcraw import preview as P
    from mcraw.metadata import CFA_PATTERNS

    h, w = shape
    cfa = tuple(CFA_PATTERNS[sensor])
    masks = P._phase_masks(h, w, cfa)
    for c, k in ((0, P._K_FULL), (1, P._K_CROSS), (2, P._K_FULL)):
        table = (1.0 / P._np_conv2same(masks[c], k)).astype(np.float32)
        got = 1.0 / np.asarray(P._mask_normalizer(h, w, cfa, c, k))
        assert np.array_equal(got, table), c


def test_preview_frame_rgba_end_to_end():
    """Decoder -> preview_frame_rgba pipeline."""
    blob = _clip_with_flat_color(512, 512, 512)
    d = Decoder(blob, backend="jax")
    from mcraw.preview import preview_frame_rgba

    rgba = np.asarray(preview_frame_rgba(d, 1))
    assert rgba.shape == (16, 64)
    assert rgba.dtype == np.uint32
    assert np.all((rgba >> 24) == 0xFF)
    inner = rgba[2:-2, 2:-2]
    r, g, b = inner & 0xFF, (inner >> 8) & 0xFF, (inner >> 16) & 0xFF
    assert np.all(np.abs(r.astype(int) - g.astype(int)) <= 1)
    assert np.all(np.abs(g.astype(int) - b.astype(int)) <= 1)


def test_preview_clip_playback():
    """Batched decode + batched develop playback iterator."""
    from mcraw import encode as E2
    from mcraw.metadata import example_frame_metadata
    from mcraw.preview import preview_clip

    cm = example_container_metadata(
        black_level=(0, 0, 0, 0), white_level=1023.0
    )
    cm["forwardMatrix1"] = [0.9642, 0, 0, 0, 1.0, 0, 0, 0, 0.8249]
    writer = E2.ContainerWriter(cm)
    rng = np.random.default_rng(3)
    imgs = []
    for t in range(3):
        img = rng.integers(0, 1024, size=(16, 128), dtype=np.uint16)
        imgs.append(img)
        fm = example_frame_metadata(128, 16)
        fm["asShotNeutral"] = [1.0, 1.0, 1.0]
        writer.add_frame(t + 1, E2.encode_modern(img), fm)
    d = Decoder(writer.finish(), backend="jax")
    frames = list(preview_clip(d, batch_frames=2))
    assert [t for t, _ in frames] == [1, 2, 3]
    for _, rgba in frames:
        a = np.asarray(rgba)
        assert a.shape == (16, 128) and a.dtype == np.uint32
        assert np.all((a >> 24) == 0xFF)


@pytest.mark.parametrize("shape", [(24, 4032), (24, 200), (16, 132)])
def test_fused_rgba_unaligned_widths(shape):
    """Develop at non-128-multiple widths (4032 = the dominant phone
    full-res width) stays within 1 LSB of the f64 model."""
    import jax.numpy as jnp
    from mcraw import preview as P

    h, w = shape
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 1024, size=(h, w), dtype=np.uint16)
    white = np.float32(1023.0)
    cfa = (0, 1, 1, 2)
    rgba = np.asarray(
        P.develop_rgba(
            jnp.asarray(raw), _BLACK, white, _NEUTRAL, _FWD,
            height=h, width=w, cfa=cfa,
        )
    )
    assert rgba.shape == (h, w)
    assert np.all((rgba >> 24) == 0xFF)
    want = P.develop_f64(raw, _BLACK, white, _NEUTRAL, _FWD, cfa)
    assert np.max(np.abs(_rgb_of(rgba) - want)) <= 1


# ---------------------------------------------------------------------------
# Dual-illuminant color math + preview fidelity bound (VERDICT r2 #8)
# ---------------------------------------------------------------------------

# Plausible phone-sensor profile: XYZ->camera at D65 / StdA and the
# corresponding (white-balanced camera)->XYZ(D50) forward matrices.
_CM1 = np.array([[0.79, -0.23, -0.07], [-0.43, 1.32, 0.05],
                 [-0.07, 0.18, 0.54]])
_CM2 = np.array([[0.92, -0.31, -0.01], [-0.50, 1.42, 0.08],
                 [-0.04, 0.22, 0.42]])
_FM1 = np.array([[0.62, 0.22, 0.12], [0.26, 0.72, 0.02],
                 [0.03, 0.12, 0.67]])
_FM2 = np.array([[0.68, 0.18, 0.10], [0.30, 0.68, 0.02],
                 [0.05, 0.10, 0.67]])


def _xyz_of_xy(xy):
    x, y = xy
    return np.array([x / y, 1.0, (1 - x - y) / y])


def test_cct_known_illuminants():
    from mcraw.color import cct_from_xy

    assert abs(cct_from_xy((0.3127, 0.3290)) - 6504) < 15   # D65
    assert abs(cct_from_xy((0.4476, 0.4074)) - 2856) < 15   # Standard A
    assert abs(cct_from_xy((0.3457, 0.3585)) - 5000) < 15   # D50


def test_interpolation_weight_endpoints_and_midpoint():
    """Camera neutrals synthesized AT each calibration illuminant must
    pull the weight to that endpoint; a D50-ish neutral lands between,
    and the self-consistent iteration converges."""
    from mcraw.color import interpolated_matrices

    cm = example_container_metadata()
    cm["colorMatrix1"], cm["colorMatrix2"] = _CM1.ravel().tolist(), _CM2.ravel().tolist()
    cm["forwardMatrix1"], cm["forwardMatrix2"] = _FM1.ravel().tolist(), _FM2.ravel().tolist()

    n_d65 = _CM1 @ _xyz_of_xy((0.3127, 0.3290))
    fwd, _, g = interpolated_matrices(cm, n_d65 / n_d65[1])
    assert g > 0.97
    assert np.allclose(fwd, _FM1, atol=0.02)

    n_a = _CM2 @ _xyz_of_xy((0.4476, 0.4074))
    fwd, _, g = interpolated_matrices(cm, n_a / n_a[1])
    assert g < 0.03
    assert np.allclose(fwd, _FM2, atol=0.02)

    mid_cm = 0.5 * (_CM1 + _CM2)
    n_d50 = mid_cm @ _xyz_of_xy((0.3457, 0.3585))
    _, _, g = interpolated_matrices(cm, n_d50 / n_d50[1])
    assert 0.3 < g < 0.9  # strictly interior

    # single-illuminant container: weight pins to 1 / forwardMatrix1
    cm1only = example_container_metadata()
    cm1only["forwardMatrix1"] = _FM1.ravel().tolist()
    cm1only.pop("colorMatrix2", None)
    cm1only.pop("forwardMatrix2", None)
    fwd, _, g = interpolated_matrices(cm1only, [0.5, 1.0, 0.6])
    assert g == 1.0 and np.allclose(fwd, _FM1)


def _develop_f64(raw, black, white, neutral, fwd, cfa):
    """Shared scalar f64 ground-truth model (mcraw.preview.develop_f64 —
    also used by bench.py's preview-leg hardware gate)."""
    from mcraw.preview import develop_f64

    return develop_f64(raw, black, white, neutral, fwd, cfa)


def test_preview_fidelity_bound_vs_f64_model():
    """The device develop, fed the dual-illuminant interpolated forward
    matrix, stays within 1/255 per channel of the full-precision f64
    scalar model on realistic metadata — the documented preview fidelity
    guarantee."""
    from mcraw import preview as P
    from mcraw.color import interpolated_matrices

    rng = np.random.default_rng(11)
    h, w = 24, 256
    raw = rng.integers(0, 1024, size=(h, w), dtype=np.uint16)
    black = np.array([64, 63, 62, 61], np.float32)
    white = np.float32(1023.0)
    neutral = np.array([0.4831, 1.0, 0.6517], np.float32)
    cfa = (0, 1, 1, 2)

    cm = example_container_metadata()
    cm["colorMatrix1"], cm["colorMatrix2"] = _CM1.ravel().tolist(), _CM2.ravel().tolist()
    cm["forwardMatrix1"], cm["forwardMatrix2"] = _FM1.ravel().tolist(), _FM2.ravel().tolist()
    fwd, _, g = interpolated_matrices(cm, neutral)
    assert 0.0 < g < 1.0  # genuinely interpolated on this metadata

    want = _develop_f64(raw, black, white, neutral, fwd, cfa)
    import jax.numpy as jnp

    rgba = np.asarray(P.develop_rgba(
        jnp.asarray(raw), black, white, neutral, fwd.astype(np.float32),
        height=h, width=w, cfa=cfa,
    ))
    got = np.stack(
        [rgba & 0xFF, (rgba >> 8) & 0xFF, (rgba >> 16) & 0xFF], axis=-1
    ).astype(np.int64)
    dev = np.max(np.abs(got - want))
    assert dev <= 1, f"preview deviation {dev}/255 exceeds the 1-LSB bound"


def test_preview_frame_uses_interpolated_matrix(rng):
    """End-to-end: with FM1 != FM2 and a warm (StdA-ish) neutral, the
    preview must NOT equal an FM1-only rendering and must match the f64
    model built on the interpolated matrix."""
    from mcraw import preview as P
    from mcraw.color import interpolated_matrices
    from mcraw.metadata import ContainerMetadata, FrameMetadata

    h, w = 16, 128
    cmd = example_container_metadata(black_level=(0, 0, 0, 0),
                                     white_level=1023.0)
    cmd["colorMatrix1"], cmd["colorMatrix2"] = _CM1.ravel().tolist(), _CM2.ravel().tolist()
    cmd["forwardMatrix1"], cmd["forwardMatrix2"] = _FM1.ravel().tolist(), _FM2.ravel().tolist()
    writer = E.ContainerWriter(cmd)
    img = rng.integers(0, 1024, size=(h, w), dtype=np.uint16)
    fmeta = example_frame_metadata(w, h)
    n_a = _CM2 @ _xyz_of_xy((0.4476, 0.4074))
    fmeta["asShotNeutral"] = (n_a / n_a[1]).tolist()
    writer.add_frame(1, E.encode_modern(img), fmeta)
    d = Decoder(writer.finish(), backend="jax")

    got = np.asarray(preview_frame(d, 1)).astype(np.int64)
    cm = ContainerMetadata(d.container_metadata)
    fm = FrameMetadata(d.load_frame(1)[1])
    fwd, _, g = interpolated_matrices(cm, fm.as_shot_neutral)
    assert g < 0.03  # warm neutral -> StdA end
    want = _develop_f64(img, cm.black_level, cm.white_level,
                        fm.as_shot_neutral, fwd, tuple(cm.cfa_pattern))
    assert np.max(np.abs(got - want)) <= 1
    want_fm1 = _develop_f64(img, cm.black_level, cm.white_level,
                            fm.as_shot_neutral, _FM1, tuple(cm.cfa_pattern))
    assert np.max(np.abs(want - want_fm1)) > 2  # interpolation matters


@pytest.mark.parametrize(
    "shape,sensor",
    [((40, 256), "rggb"), ((36, 250), "bggr"), ((64, 128), "grbg"),
     ((48, 320), "gbrg")],
)
def test_malvar_kernel_matches_f64_model(shape, sensor):
    """Malvar-He-Cutler demosaic (r5 beyond-reference feature): the
    float32 develop's malvar path vs the f64 scalar model, <= 1 LSB
    across CFAs, ragged widths, and the zero-padded 2px border."""
    import jax.numpy as jnp

    from mcraw import preview as P
    from mcraw.metadata import CFA_PATTERNS

    h, w = shape
    cfa = tuple(CFA_PATTERNS[sensor])
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    black = np.array([64, 60, 70, 64], np.float32)
    white = 4095.0
    neutral = np.array([0.61, 1.0, 0.72], np.float32)
    fwd = np.array(
        [[0.86, 0.08, 0.02], [0.04, 0.91, 0.05], [0.01, 0.06, 0.76]],
        np.float32,
    )
    rgba = np.asarray(
        P.develop_rgba(
            jnp.asarray(raw), black, np.float32(white), neutral, fwd,
            height=h, width=w, cfa=cfa, demosaic="malvar",
        )
    ).astype(np.int64)
    model = P.develop_f64(
        raw, black, white, neutral, fwd, cfa, demosaic="malvar"
    )
    assert int(np.abs(_rgb_of(rgba) - model).max()) <= 1
    assert int(((rgba >> 24) & 0xFF).min()) == 255


def test_malvar_beats_bilinear_on_gradients():
    """Quality property: on a smooth neutral-grey linear ramp (where the
    true full-RGB image is known exactly), MHC's gradient correction
    must reconstruct the interior strictly better than bilinear."""
    h, w = 64, 256
    cfa = (0, 1, 1, 2)
    # Neutral scene (R=G=B): ideal reconstruction equals the ramp itself.
    ramp = np.clip(
        np.linspace(200, 3800, w)[None, :]
        + np.linspace(0, 280, h)[:, None],
        0, 4095,
    ).astype(np.uint16)
    black = np.zeros(4, np.float32)
    white = 4095.0
    neutral = np.ones(3, np.float32)
    fwd = np.diag([0.9642, 1.0, 0.8249]).astype(np.float32)

    from mcraw.preview import develop_f64

    # On a NEUTRAL scene (every channel sees the same signal), the ideal
    # demosaic output is the mosaic value itself at every pixel for all
    # three channels — an analytic ground truth both modes are scored
    # against after the identical tonemap.
    truth = develop_f64(
        ramp, black, white, neutral, fwd, cfa, demosaic="malvar"
    )
    bil = develop_f64(ramp, black, white, neutral, fwd, cfa)
    # Analytic truth: the pipeline applied to the ramp value itself at
    # every pixel for all three channels (neutral scene, diag matrix).
    x = np.clip(ramp.astype(np.float64) / white, 0, 1)
    m = np.diag([0.9642, 1.0, 0.8249])
    from mcraw.preview import _XYZ_D50_TO_SRGB

    mm = _XYZ_D50_TO_SRGB.astype(np.float64) @ m
    rgb = np.clip(np.stack([x, x, x], -1) @ mm.T, 0, 1)
    rgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                   1.055 * np.power(rgb, 1 / 2.4) - 0.055)
    ideal = np.round(np.clip(rgb, 0, 1) * 255.0).astype(np.int64)

    interior = np.s_[4:-4, 4:-4]
    err_m = np.abs(truth[interior] - ideal[interior]).mean()
    err_b = np.abs(bil[interior] - ideal[interior]).mean()
    # On a LINEAR ramp both are near-exact; the property that matters is
    # that malvar is not WORSE, and strictly better on curvature. Add a
    # quadratic bump to create curvature:
    yy, xx = np.mgrid[0:h, 0:w]
    curved = np.clip(
        1000 + 2500 * np.sin(xx / 17.0) ** 2 + 400 * np.sin(yy / 9.0),
        0, 4095,
    ).astype(np.uint16)
    t_m = develop_f64(curved, black, white, neutral, fwd, cfa,
                      demosaic="malvar")
    t_b = develop_f64(curved, black, white, neutral, fwd, cfa)
    xc = np.clip(curved.astype(np.float64) / white, 0, 1)
    rgbc = np.clip(np.stack([xc, xc, xc], -1) @ mm.T, 0, 1)
    rgbc = np.where(rgbc <= 0.0031308, 12.92 * rgbc,
                    1.055 * np.power(rgbc, 1 / 2.4) - 0.055)
    idealc = np.round(np.clip(rgbc, 0, 1) * 255.0).astype(np.int64)
    em = np.abs(t_m[interior] - idealc[interior]).mean()
    eb = np.abs(t_b[interior] - idealc[interior]).mean()
    assert err_m <= err_b + 0.01  # ramp: no worse
    assert em < eb  # curvature: strictly better


def test_preview_cli_demosaic_flag(tmp_path, rng, capsys, monkeypatch):
    """`mcraw preview --demosaic malvar` produces a PPM that differs
    from bilinear (the modes are genuinely different pipelines) while
    both run end-to-end."""
    from mcraw import encode as E
    from mcraw.cli import main as cli_main
    from mcraw.metadata import (
        example_container_metadata,
        example_frame_metadata,
    )

    writer = E.ContainerWriter(example_container_metadata())
    img = rng.integers(0, 1024, size=(16, 256), dtype=np.uint16)
    writer.add_frame(1, E.encode_modern(img), example_frame_metadata(256, 16))
    writer.add_audio(np.zeros(32, np.int16), 500)
    clip = tmp_path / "clip.mcraw"
    clip.write_bytes(writer.finish())
    for mode in ("bilinear", "malvar"):
        out = tmp_path / mode
        rc = cli_main([
            "preview", str(clip), "--output-dir", str(out),
            "--demosaic", mode,
        ])
        capsys.readouterr()
        assert rc == 0
        assert (out / "preview_000000.ppm").exists()
    a = (tmp_path / "bilinear" / "preview_000000.ppm").read_bytes()
    b = (tmp_path / "malvar" / "preview_000000.ppm").read_bytes()
    assert a != b


@pytest.mark.parametrize(
    "shape,demosaic",
    [
        ((16, 128), "bilinear"),
        ((66, 100), "bilinear"),  # multi-band + ragged width
        ((16, 128), "malvar"),
        ((70, 200), "malvar"),
    ],
)
def test_develop_batch_exact(shape, demosaic):
    """The vmapped batch develop (preview_clip's path) must be bit-exact
    vs per-frame calls for both demosaic modes, with per-frame neutrals
    and forward matrices."""
    import jax.numpy as jnp
    from mcraw import preview as P

    h, w = shape
    rng = np.random.default_rng(7)
    ims = rng.integers(0, 4096, size=(2, h, w), dtype=np.uint16)
    black = np.zeros(4, np.float32)
    white = np.float32(4095.0)
    neutrals = np.array([[1.0, 1.0, 1.0], [0.55, 1.0, 0.71]], np.float32)
    fwds = np.stack(
        [np.diag([0.9642, 1.0, 0.8249]).astype(np.float32), _FWD]
    )
    kw = dict(height=h, width=w, cfa=(0, 1, 1, 2), demosaic=demosaic)
    singles = np.stack([
        np.asarray(
            P.develop_rgba(jnp.asarray(ims[i]), black, white, neutrals[i],
                           fwds[i], **kw)
        )
        for i in range(2)
    ])
    batched = np.asarray(
        P.develop_rgba_batch(jnp.asarray(ims), black, white, neutrals,
                             fwds, **kw)
    )
    assert batched.shape == (2, h, w)
    assert np.array_equal(batched, singles)


def test_color_matrix_full_precision():
    """The develop's one matrix product keeps float32 precision (it asks
    for HIGHEST, so a GPU cannot drop it to TF32): relative error vs the
    float64 product stays at float32 rounding, far below TF32's ~1e-3."""
    import jax.numpy as jnp
    from mcraw import preview as P

    fwd = np.array(
        [[0.62, 0.22, 0.12], [0.26, 0.72, 0.02], [0.03, 0.12, 0.67]]
    )
    want = P._XYZ_D50_TO_SRGB.astype(np.float64) @ fwd
    got = np.asarray(P.color_matrix(jnp.asarray(fwd, jnp.float32)))
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("h", [2, 3])
@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_develop_tiny_heights(h, demosaic):
    """Frames of 2 and 3 rows (once a fallback case: every row is a
    border row) develop on the one path, within 1 LSB of the f64 model."""
    import jax.numpy as jnp
    from mcraw import preview as P

    w = 64
    raw = np.random.default_rng(h).integers(0, 4096, size=(h, w),
                                            dtype=np.uint16)
    white = np.float32(4095.0)
    rgba = P.develop_rgba(
        jnp.asarray(raw), _BLACK, white, _NEUTRAL, _FWD,
        height=h, width=w, cfa=(0, 1, 1, 2), demosaic=demosaic,
    )
    want = P.develop_f64(raw, _BLACK, white, _NEUTRAL, _FWD, (0, 1, 1, 2),
                         demosaic=demosaic)
    assert want.min() >= 0 and want.max() <= 255
    assert np.max(np.abs(_rgb_of(rgba) - want)) <= 1


def test_preview_clip_mixed_geometry():
    """preview_clip over a clip that switches resolution: each homogeneous
    run develops in its own batch, frames stay in stream order."""
    from mcraw import preview as P
    from mcraw.metadata import ContainerMetadata, FrameMetadata

    cm = example_container_metadata()
    writer = E.ContainerWriter(cm)
    rng = np.random.default_rng(4)
    imgs = []
    for t, (h, w) in enumerate([(16, 128), (16, 128), (8, 64)]):
        img = rng.integers(0, 1024, size=(h, w), dtype=np.uint16)
        imgs.append(img)
        writer.add_frame(t + 1, E.encode_modern(img),
                         example_frame_metadata(w, h))
    d = Decoder(writer.finish(), backend="jax")
    cmeta = ContainerMetadata(d.container_metadata)
    frames = list(P.preview_clip(d, batch_frames=4))
    assert [t for t, _ in frames] == [1, 2, 3]
    for (ts, rgba), img in zip(frames, imgs):
        fm = FrameMetadata(d._reader.frame_payload(ts)[1])
        black, white, neutral, fwd = P._frame_params(fm, cmeta)
        want = P.develop_f64(img, black, white, neutral, fwd,
                             tuple(cmeta.cfa_pattern))
        assert np.asarray(rgba).shape == img.shape
        assert np.max(np.abs(_rgb_of(rgba) - want)) <= 1
