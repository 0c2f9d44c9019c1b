"""The plain-XLA device decode against the NumPy oracle and the encoder's
source planes: every bit width, ragged geometries, the benchmark content
mixes, batches, meshes, the payload bucket ladder (one compiled program per
clip geometry), the device checksum, and the entry points' device rules."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mcraw import encode as E  # noqa: E402
from mcraw.kernels import numpy_ref as R  # noqa: E402
from mcraw.kernels import unpack as U  # noqa: E402
from mcraw.metadata import (  # noqa: E402
    example_container_metadata,
    example_frame_metadata,
)
from mcraw.pipeline import Decoder  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _encode(img, codec):
    enc = E.encode_modern if codec == 7 else E.encode_legacy
    return np.frombuffer(enc(img), dtype=np.uint8)


def _device_decode(payload, w, h, codec):
    dec = U.decode_modern if codec == 7 else U.decode_legacy
    return np.asarray(dec(payload, w, h))


def _oracle(payload, w, h, codec):
    dec = R.decode_modern if codec == 7 else R.decode_legacy
    return dec(payload, w, h)


def content(rng, kind, h, w):
    """A seeded plane of one of the benchmark's content mixes
    (mcraw.encode.synthetic_plane: mix12, worst, all16)."""
    return E.synthetic_plane(kind, h, w, int(rng.integers(1 << 31)))


@pytest.mark.parametrize("codec", [7, 6])
@pytest.mark.parametrize("bits", list(range(17)))
def test_every_bit_width_matches_oracle(rng, bits, codec):
    """Content confined to `bits` bits drives every block class the codec
    has; the device decode equals the oracle and the source exactly."""
    h, w = 8, 128
    img = rng.integers(0, 1 << bits, size=(h, w), dtype=np.uint16)
    payload = _encode(img, codec)
    got = _device_decode(payload, w, h, codec)
    assert np.array_equal(got, _oracle(payload, w, h, codec))
    assert np.array_equal(got, img)


@pytest.mark.parametrize("codec", [7, 6])
@pytest.mark.parametrize(
    "shape", [(5, 50), (10, 64), (7, 129), (13, 300), (6, 4032), (3, 66)]
)
def test_ragged_geometries(rng, shape, codec):
    """Heights and widths that are not multiples of 4 (modern tile rows)
    or 32 (legacy padded width), incl. the 4032-wide phone sensor."""
    h, w = shape
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = _encode(img, codec)
    got = _device_decode(payload, w, h, codec)
    assert got.shape == (h, w)
    assert np.array_equal(got, img)


@pytest.mark.parametrize("codec", [7, 6])
@pytest.mark.parametrize("kind", ["mix12", "worst", "all16"])
def test_content_mixes(rng, kind, codec):
    h, w = 16, 256
    img = content(rng, kind, h, w)
    payload = _encode(img, codec)
    got = _device_decode(payload, w, h, codec)
    assert np.array_equal(got, _oracle(payload, w, h, codec))
    assert np.array_equal(got, img)


@pytest.mark.parametrize("codec", [7, 6])
def test_mixed_classes_in_one_frame(rng, codec):
    """Stripes of every even bit width side by side in one frame."""
    h, w = 16, 640
    img = np.zeros((h, w), dtype=np.uint16)
    for i, b in enumerate(range(0, 17, 2)):
        lo = 0 if b == 0 else 1 << (b - 1)
        img[:, i * 64 : (i + 1) * 64] = rng.integers(
            lo, (1 << b) if b else 1, size=(h, 64)
        )
    img[:, 576:] = rng.integers(0, 128, size=(h, 64))
    assert np.array_equal(_device_decode(_encode(img, codec), w, h, codec), img)


@pytest.mark.parametrize("codec", [7, 6])
def test_large_frame(rng, codec):
    h, w = 128, 2048
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    assert np.array_equal(_device_decode(_encode(img, codec), w, h, codec), img)


def test_modern_cropped_encoded_width(rng):
    img = rng.integers(0, 4096, size=(8, 100), dtype=np.uint16)
    payload = np.frombuffer(
        E.encode_modern(img, encoded_width=192), dtype=np.uint8
    )
    assert np.array_equal(np.asarray(U.decode_modern(payload, 100, 8)), img)


# -- payload bucket ladder ----------------------------------------------------


@pytest.mark.parametrize(
    "need,full",
    [(1, 1 << 20), (100_000, 1 << 20), ((1 << 20) + 7, 1 << 20),
     (777, 0), (25 << 20, 25 << 20)],
)
def test_payload_bucket_ladder(need, full):
    """A rung holds the need, is 512-aligned, and is a whole number of
    steps of full/8; a need within the geometry's worst case lands on one
    of PAYLOAD_BUCKETS rungs."""
    got = U.payload_bucket(need, full)
    step = U.payload_bucket(1, full)
    assert got >= need and got % 512 == 0 and got % step == 0
    assert got - need < step
    if need <= full:
        assert got // step <= U.PAYLOAD_BUCKETS


@pytest.mark.parametrize("codec", [7, 6])
def test_payload_sizes_share_a_rung(rng, codec):
    """Frames of one content class differ in payload size but pad to the
    same rung, so they share one jitted program."""
    h, w = 16, 256
    prep = U.prepare_modern if codec == 7 else U.prepare_legacy
    sizes, padded = set(), set()
    for _ in range(6):
        payload = _encode(content(rng, "mix12", h, w), codec)
        sizes.add(len(payload))
        padded.add(len(prep(payload, w, h).payload))
    assert len(sizes) > 1
    assert len(padded) == 1


def test_prepare_window_and_copy_agree(rng):
    """Zero-copy window padding == copy padding; trailing bytes past the
    payload are never addressed."""
    img = rng.integers(0, 4096, size=(16, 256), dtype=np.uint16)
    payload = _encode(img, 7)
    big = np.random.default_rng(9).integers(
        0, 256, size=len(payload) + (1 << 20)
    ).astype(np.uint8)
    big[: len(payload)] = payload
    a = U.prepare_modern(payload, 256, 16, window=big)
    b = U.prepare_modern(payload, 256, 16)
    assert len(a.payload) == len(b.payload)
    assert np.array_equal(a.offsets, b.offsets)
    for plan in (a, b):
        out = U.decode_modern_device(
            jnp.asarray(plan.payload), jnp.asarray(plan.offsets),
            jnp.asarray(plan.cls), jnp.asarray(plan.refs),
            tiles_y=plan.tiles_y, tiles_x=plan.tiles_x, width=256, height=16,
        )
        assert np.array_equal(np.asarray(out), img)


def test_prepare_modern_validation(rng):
    from mcraw.errors import DecodeError

    payload = _encode(rng.integers(0, 65536, size=(8, 64), dtype=np.uint16), 7)
    with pytest.raises(DecodeError):
        U.prepare_modern(payload[: len(payload) // 2], 64, 8)
    with pytest.raises(DecodeError):
        U.prepare_modern(payload, 128, 8)  # width > encodedWidth


def _clip(rng, codec, n=6, h=16, w=256):
    writer = E.ContainerWriter(example_container_metadata())
    imgs = []
    for i in range(n):
        img = content(rng, "mix12", h, w)
        imgs.append(img)
        enc = E.encode_modern if codec == 7 else E.encode_legacy
        writer.add_frame(100 + i, enc(img), example_frame_metadata(w, h, codec))
    return writer.finish(), imgs


@pytest.mark.parametrize("codec", [7, 6])
def test_one_program_per_clip_geometry(rng, codec):
    """A clip whose frames vary in payload size compiles ONE decode
    program per path: per-frame jit, FrameDecoder, and the batch."""
    blob, imgs = _clip(rng, codec, h=16, w=320)
    d = Decoder(blob, backend="jax")
    dec = U.decode_modern_device if codec == 7 else U.decode_legacy_device
    dec.clear_cache()
    for ts, img in zip(d.frames, imgs):
        out, _ = d.load_frame_device(ts)
        assert np.array_equal(np.asarray(out), img)
    assert dec._cache_size() == 1
    fd = d.make_frame_decoder()
    for ts, img in zip(d.frames, imgs):
        assert np.array_equal(np.asarray(fd(ts)[0]), img)
    assert fd.num_programs == 1
    from mcraw.parallel import batched_decoder

    batched = batched_decoder(d._plan(d.frames[0])[0])
    batched.clear_cache()
    for imgs_b, _ in d.decode_batch_iter(chunk_frames=3):
        assert imgs_b.shape[0] == 3
    assert batched._cache_size() == 1


@pytest.mark.parametrize("codec", [7, 6])
def test_batch_equals_per_frame(rng, codec):
    blob, imgs = _clip(rng, codec, n=4)
    d = Decoder(blob, backend="jax")
    out, metas = d.decode_batch()
    assert len(metas) == 4
    assert np.array_equal(np.asarray(out), np.stack(imgs))


@pytest.mark.parametrize("codec", [7, 6])
def test_eight_device_mesh(rng, codec):
    """decode_batch over the 8-device virtual mesh: sharded on all 8,
    every frame exact."""
    from mcraw.parallel import default_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    blob, imgs = _clip(rng, codec, n=8)
    d = Decoder(blob, backend="jax")
    out, _ = d.decode_batch(mesh=default_mesh())
    assert len(out.sharding.device_set) == 8
    assert np.array_equal(np.asarray(out), np.stack(imgs))


# -- device checksum ---------------------------------------------------------


@pytest.mark.parametrize(
    "shape,dt",
    [((96, 128), np.uint16), ((120, 256), np.uint16), ((64, 256), np.uint32),
     ((7, 128), np.uint16), ((16, 100), np.uint16)],
)
def test_device_checksum_exact(rng, shape, dt):
    """The checksum == int64 sum mod 2^32, incl. uint32 wrap-around."""
    from mcraw.kernels.checksum import device_checksum

    x = rng.integers(0, np.iinfo(dt).max, size=shape, dtype=dt)
    want = int(x.astype(np.int64).sum() & 0xFFFFFFFF)
    assert int(device_checksum(jnp.asarray(x))) == want
    full = np.full((256, 256), 0xFFFF, dtype=np.uint16)
    want = int(full.astype(np.int64).sum() & 0xFFFFFFFF)
    assert int(device_checksum(jnp.asarray(full))) == want


# -- device rules: platform helper, compile cache, no-GPU entry points --------


def test_platform_info_reports_jax_devices():
    from mcraw.device import platform_info

    platform, kind, count = platform_info()
    assert platform == jax.devices()[0].platform == "cpu"
    assert kind == jax.devices()[0].device_kind
    assert count == len(jax.devices())


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, monkeypatch, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's reading of it decides and
    the helper sets no other directory; unset, the cache goes to the fixed
    gitignored directory in the checkout."""
    from mcraw import device

    saved = {
        k: getattr(jax.config, k)
        for k in ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")
    }
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            assert device.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = device.enable_compile_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            ignored = (REPO / ".gitignore").read_text().split()
            assert ".jax_cache/" in ignored
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_scripts_fail_without_gpu(script):
    """Without a GPU the chip check and the benchmark exit nonzero and
    print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_chip_smoke_main_nonzero_in_process(capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("enc_h", [17, 19, 24])
def test_modern_encoded_height_padding(rng, enc_h):
    """encodedHeight above the frame height (and not a multiple of 4):
    the decode runs whole 4-row tiles and crops to the frame."""
    h, w = 16, 192
    img = rng.integers(0, 4096, size=(h, w), dtype=np.uint16)
    payload = np.frombuffer(
        E.encode_modern(img, encoded_height=enc_h), dtype=np.uint8
    )
    got = np.asarray(U.decode_modern(payload, w, h))
    assert np.array_equal(got, img)
    assert np.array_equal(got, R.decode_modern(payload, w, h))


@pytest.mark.parametrize("codec", [7, 6])
def test_frame_decoder_ragged_geometry(rng, codec):
    """The AOT frame decoder at a geometry that is neither tile- nor
    32-aligned: exact, one program."""
    blob, imgs = _clip(rng, codec, n=3, h=13, w=300)
    d = Decoder(blob, backend="jax")
    fd = d.make_frame_decoder()
    for ts, img in zip(d.frames, imgs):
        assert np.array_equal(np.asarray(fd(ts)[0]), img)
    assert fd.num_programs == 1
