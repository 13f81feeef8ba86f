"""The port's backend registry (``snappy_tpu_torch.api``): the cases of
tests/test_api.py over the port's registry, with "torch" in the role of
"jnp", plus the default backend, a cross-backend matrix against the JAX
package's registry, and "torch" streams against the JAX device codec
with its id engine forced.  Tolerance: 0 (byte-exact)."""

import functools

import numpy as np
import pytest

import snappy_tpu_torch
from snappy_tpu import api as japi
from snappy_tpu import native as jnative
from snappy_tpu_torch import native
from snappy_tpu_torch.errors import SnappyError
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu_torch import api
from snappy_tpu_torch.runtime import device_codec as dc


@pytest.fixture
def no_env_backend(monkeypatch):
    monkeypatch.delenv("SNAPPY_TPU_BACKEND", raising=False)


@pytest.fixture
def jax_id_engine(monkeypatch):
    """The JAX device codec with its id engine forced (off the TPU it
    would pick the jnp encoder, whose emission differs)."""
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")


def _data(rng):
    return (b"matrix " * 500)[:3000] + rng.randbytes(1000)


def test_available_backends_complete():
    names = api.available_backends()
    for want in ("oracle", "np", "native", "torch"):
        assert want in names, names
    assert "jnp" not in names  # the JAX package's registry is not touched


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        api.compress(b"x", backend="definitely-not-a-backend")


def test_env_backend_selection(monkeypatch, rng):
    monkeypatch.setenv("SNAPPY_TPU_BACKEND", "oracle")
    data = rng.randbytes(2000)
    c = api.compress(data)  # backend=None -> env
    assert api._resolve("compress", None) is api._BACKENDS["oracle"]["compress"]
    assert api.decompress(c) == data


def test_default_backend_is_torch(no_env_backend, rng):
    """With neither backend= nor SNAPPY_TPU_BACKEND the port runs its
    device codec, where the JAX package's "auto" would run the native
    host codec; backend="auto" keeps the JAX preference."""
    fn = api._resolve("compress_framed", None, "cpu")
    assert isinstance(fn, functools.partial)
    assert fn.func is dc.compress_framed and fn.keywords == {"device": "cpu"}
    assert api._resolve("compress_framed", "auto") is native.compress_framed
    assert japi._resolve("compress_framed", None) is jnative.compress_framed
    data = _data(rng)
    assert api.compress_framed(data) == native.compress_framed(data)
    # device= reaches "torch" only: a device the port refuses raises
    # there, and the host backends ignore it
    with pytest.raises(ValueError, match="unsupported device"):
        api.compress_framed(data, device="meta")
    assert api.compress_framed(data, backend="native", device="meta") == \
        native.compress_framed(data)


def test_register_custom_backend(rng):
    calls = []

    def fake_compress(data):
        calls.append(len(data))
        from snappy_tpu.spec import reference

        return reference.compress(data)

    api.register_backend("test-custom", compress=fake_compress)
    try:
        data = rng.randbytes(500)
        c = api.compress(data, backend="test-custom")
        assert calls == [500]
        assert api.decompress(c, backend="oracle") == data
        # ops not provided by the custom backend fail loudly
        with pytest.raises(ValueError):
            api.decompress(c, backend="test-custom")
        assert "test-custom" not in japi.available_backends()
    finally:
        api._BACKENDS.pop("test-custom", None)


def test_cross_backend_matrix(rng):
    """Every backend's framed and raw output decodes on every other
    backend, the port's and the JAX package's host backends alike."""
    data = _data(rng)
    backends = ("oracle", "np", "native", "torch")
    blobs = {b: api.compress_framed(data, backend=b, device="cpu")
             for b in backends}
    raws = {b: api.compress(data, backend=b, device="cpu") for b in backends}
    for src in backends:
        for dst in backends:
            assert api.decompress_framed(blobs[src], backend=dst,
                                         device="cpu") == data, (src, dst)
            assert api.decompress(raws[src], backend=dst,
                                  device="cpu") == data, (src, dst)
    for jb in ("native", "np"):
        assert japi.decompress_framed(blobs["torch"], backend=jb) == data, jb
        assert japi.decompress(raws["torch"], backend=jb) == data, jb
        assert api.decompress_framed(japi.compress_framed(data, backend=jb),
                                     backend="torch", device="cpu") == data
        assert api.decompress(japi.compress(data, backend=jb),
                              backend="torch", device="cpu") == data
    # the same host backend gives the same bytes in both registries
    for b in ("oracle", "np", "native"):
        assert blobs[b] == japi.compress_framed(data, backend=b), b
        assert raws[b] == japi.compress(data, backend=b), b


def test_torch_matches_jax_device_codec(jax_id_engine, nprng):
    text = b"from the registry, framed " * 9000
    for data in (b"", b"x", text[:1000], nprng.bytes(70_000),
                 (text[:130_000] + nprng.bytes(1000))[:140_000]):
        fr = api.compress_framed(data, backend="torch", device="cpu")
        assert fr == jdc.compress_framed(data) == native.compress_framed(data)
        assert api.decompress_framed(fr, backend="torch", device="cpu") == data
        raw = api.compress(data, backend="torch", device="cpu")
        assert raw == jdc.compress(data) == native.compress(data)
        assert api.decompress(raw, backend="torch", device="cpu") == data


def test_verify_checksums_passes_through(rng):
    data = rng.randbytes(5000)
    bad = bytearray(native.compress_framed(data))
    bad[14] ^= 0x01  # the first chunk's CRC field
    for b in ("oracle", "native", "torch"):
        with pytest.raises(SnappyError):
            api.decompress_framed(bytes(bad), backend=b, device="cpu")
        assert api.decompress_framed(bytes(bad), False, backend=b,
                                     device="cpu") == data, b


def test_into_entry_points(rng):
    """decompress_into / decompress_framed_into: the reused-buffer path,
    the same as the allocating entries, bounds checked."""
    data = (b"api into " * 5000 + rng.randbytes(20_000))[:60_000]
    raw = api.compress(data, backend="np")
    fr = api.compress_framed(data, backend="np")
    out = np.empty(len(data) + 7, np.uint8)
    assert snappy_tpu_torch.decompress_into(raw, out) == len(data)
    assert out[: len(data)].tobytes() == data
    out[:] = 0
    assert snappy_tpu_torch.decompress_framed_into(fr, out) == len(data)
    assert out[: len(data)].tobytes() == data
    with pytest.raises(Exception):
        api.decompress_into(raw, np.empty(5, np.uint8))


def test_into_without_native(monkeypatch, rng):
    """Without the native library the into-entries decode through
    "auto" (the oracle there) and copy, as the JAX package's do."""
    monkeypatch.delenv("SNAPPY_TPU_BACKEND", raising=False)
    data = rng.randbytes(3000) + b"abc" * 1000
    raw, fr = native.compress(data), native.compress_framed(data)
    monkeypatch.setattr(native, "available", lambda: False)
    api.available_backends()
    monkeypatch.setattr(api, "_BACKENDS", {
        k: v for k, v in api._BACKENDS.items() if k != "native"})
    assert api._resolve("decompress", "auto") is \
        api._BACKENDS["oracle"]["decompress"]
    out = np.zeros(len(data), np.uint8)
    assert api.decompress_into(raw, out) == len(data)
    assert out.tobytes() == data
    out[:] = 0
    assert api.decompress_framed_into(fr, out) == len(data)
    assert out.tobytes() == data
    with pytest.raises(ValueError):
        api.decompress_framed_into(fr, np.empty(5, np.uint8))


def test_into_without_native_honours_env(monkeypatch, rng):
    """Without the native library the into-entries decode on the
    backend ``SNAPPY_TPU_BACKEND`` names, as the JAX package's
    ``decompress(data)`` does."""
    from snappy_tpu.spec import framing, reference

    data = rng.randbytes(2000) + b"env " * 700
    raw, fr = native.compress(data), native.compress_framed(data)
    calls = []

    def spy(fn, op):
        def run(*args):
            calls.append(op)
            return fn(*args)
        return run

    monkeypatch.setattr(native, "available", lambda: False)
    api.available_backends()
    monkeypatch.setattr(api, "_BACKENDS", {
        k: v for k, v in api._BACKENDS.items() if k != "native"})
    api.register_backend(
        "test-env", decompress=spy(reference.decompress, "raw"),
        decompress_framed=spy(framing.decompress_framed, "framed"))
    monkeypatch.setenv("SNAPPY_TPU_BACKEND", "test-env")
    out = np.zeros(len(data), np.uint8)
    assert api.decompress_into(raw, out) == len(data)
    assert out.tobytes() == data
    out[:] = 0
    assert api.decompress_framed_into(fr, out) == len(data)
    assert out.tobytes() == data
    assert calls == ["raw", "framed"]


def test_lazy_exports():
    st = snappy_tpu_torch
    from snappy_tpu_torch import checkpoint
    from snappy_tpu_torch.runtime import stream

    assert st.FramedReader is stream.FramedReader
    assert st.FramedWriter is stream.FramedWriter
    assert st.checkpoint is checkpoint
    assert st.decompress_into is api.decompress_into
    with pytest.raises(AttributeError):
        st.register_backend  # lives in snappy_tpu_torch.api
