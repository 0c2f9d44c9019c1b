"""Card-only checks (marker `gpu`): the device decode and develop as the GPU
compiles them. They skip on the CPU; on the card they run with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py`, which is a
phase of chip_smoke.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.gpu

H, W = 1080, 1920


def _frame(seed):
    rng = np.random.default_rng(seed)
    base = (
        np.sin(np.arange(W) / 97.0)[None, :]
        * np.cos(np.arange(H) / 61.0)[:, None] * 1200 + 2000
    )
    return (base + rng.normal(0, 30, size=(H, W))).clip(0, 4095).astype(
        np.uint16
    )


@pytest.mark.parametrize("codec", [7, 6])
def test_decode_exact_on_gpu(gpu, codec):
    from mcraw import encode as E
    from mcraw.kernels import numpy_ref as R
    from mcraw.kernels import unpack as U

    img = _frame(codec)
    enc = E.encode_modern if codec == 7 else E.encode_legacy
    payload = np.frombuffer(enc(img), dtype=np.uint8)
    dec = U.decode_modern if codec == 7 else U.decode_legacy
    out = dec(payload, W, H)
    assert out.devices() == {gpu}
    oracle = (R.decode_modern if codec == 7 else R.decode_legacy)(
        payload, W, H
    )
    got = np.asarray(out)
    assert np.array_equal(got, img)
    assert np.array_equal(got, oracle)


@pytest.mark.parametrize("demosaic", ["bilinear", "malvar"])
def test_develop_within_one_lsb_on_gpu(gpu, demosaic):
    import jax.numpy as jnp

    from mcraw import preview as P

    raw = _frame(3)
    black = np.array([64, 60, 70, 64], np.float32)
    neutral = np.array([0.61, 1.0, 0.72], np.float32)
    fwd = np.array(
        [[0.86, 0.08, 0.02], [0.04, 0.91, 0.05], [0.01, 0.06, 0.76]],
        np.float32,
    )
    cfa = (0, 1, 1, 2)
    rgba = P.develop_rgba(
        jax.device_put(raw, gpu), jnp.asarray(black), jnp.float32(4095.0),
        jnp.asarray(neutral), jnp.asarray(fwd),
        height=H, width=W, cfa=cfa, demosaic=demosaic,
    )
    assert rgba.devices() == {gpu}
    rgba = np.asarray(rgba).astype(np.int64)
    got = np.stack(
        [rgba & 0xFF, (rgba >> 8) & 0xFF, (rgba >> 16) & 0xFF], axis=-1
    )
    want = P.develop_f64(raw, black, 4095.0, neutral, fwd, cfa,
                         demosaic=demosaic)
    assert int(np.abs(got - want).max()) <= 1


def test_color_matrix_not_tf32_on_gpu(gpu):
    import jax.numpy as jnp

    from mcraw import preview as P

    fwd = np.array(
        [[0.62, 0.22, 0.12], [0.26, 0.72, 0.02], [0.03, 0.12, 0.67]]
    )
    want = P._XYZ_D50_TO_SRGB.astype(np.float64) @ fwd
    got = np.asarray(jax.jit(P.color_matrix)(jnp.asarray(fwd, jnp.float32)))
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
