"""The port's checkpoints (``snappy_tpu_torch.checkpoint``) against the
JAX package's with its id engine forced: round trips per dtype, the
same container bytes, cross-loading in both directions, the stream
valid to foreign decoders, corruption, and the port's CorruptError
where the JAX package raises other errors.  Tolerance: 0 (byte-exact)."""

import contextlib
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappy_tpu import checkpoint as jck
from snappy_tpu import native
from snappy_tpu import errors as jerr
from snappy_tpu_torch.errors import ChecksumError, CorruptError
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu.spec import framing
from snappy_tpu.spec.format import STREAM_ID_CHUNK
from snappy_tpu_torch import checkpoint as ck
from snappy_tpu_torch.runtime import device_codec as dc


@pytest.fixture(autouse=True)
def jax_id_engine(monkeypatch):
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")


# the cases of tests/test_checkpoint.py, plus float16, int64 and 0-dim
CASES = [
    ("float32", (1000, 33)),
    ("bfloat16", (64, 129)),
    ("int32", (70_001,)),
    ("uint8", (200_000,)),
    ("int8", (4097,)),
    ("bool", (513,)),
    ("float32", (0,)),
    ("float16", (333, 7)),
    ("int64", (5000,)),
    ("float32", ()),
]


def _host(name, shape, seed=7):
    """A numpy array of dtype ``name`` (bfloat16: ml_dtypes' numpy type,
    which jax registers) from a seed, as the JAX tests make them."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape, dtype=np.int64))
    if name == "bool":
        return rng.integers(0, 2, n).astype(bool).reshape(shape)
    if name in ("float32", "bfloat16", "float16"):
        vals = np.arange(n, dtype=np.float32) * 0.37 - 11.0
        return vals.astype(jnp.dtype(name)).reshape(shape)
    raw = rng.integers(0, 256, n * np.dtype(name).itemsize, dtype=np.uint8)
    return raw.view(name).reshape(shape)


def _to_torch(host: np.ndarray) -> torch.Tensor:
    dt = ck.DTYPES[str(host.dtype)]
    if not host.size:
        return torch.empty(host.shape, dtype=dt)
    u8 = torch.from_numpy(np.ascontiguousarray(host).reshape(-1)
                          .view(np.uint8).copy())
    t = u8.to(torch.bool) if dt == torch.bool else u8.view(dt)
    return t.reshape(host.shape)


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _x64(name):
    """int64 needs jax's 64-bit mode (else jnp makes it int32)."""
    return (jax.enable_x64(True) if name == "int64"
            else contextlib.nullcontext())


def _same(t: torch.Tensor, ref: np.ndarray) -> None:
    assert ck.DTYPES[str(ref.dtype)] == t.dtype
    assert tuple(t.shape) == ref.shape
    assert _bytes(t) == _bytes(ref)


@pytest.mark.parametrize("name,shape", CASES)
def test_roundtrip_dtypes(name, shape):
    t = _to_torch(_host(name, shape))
    blob = ck.save_array(t)
    back = ck.load_array(blob)
    assert back.dtype == t.dtype and back.shape == t.shape
    assert torch.equal(back, t), (name, shape)
    host_back = ck.load_array(blob, to_device=False)
    assert host_back.device.type == "cpu" and torch.equal(host_back, t)


@pytest.mark.parametrize("name,shape", CASES)
def test_container_bytes_match_jax(name, shape):
    host = _host(name, shape)
    with _x64(name):
        want = jck.save_array(jax.device_put(host))
    assert ck.save_array(_to_torch(host)) == want


@pytest.mark.parametrize("name,shape", CASES)
def test_jax_saves_port_loads(name, shape):
    host = _host(name, shape)
    with _x64(name):
        blob = jck.save_array(jax.device_put(host))
    _same(ck.load_array(blob), host)
    _same(ck.load_array(blob, to_device=False), host)


@pytest.mark.parametrize("name,shape", CASES)
def test_port_saves_jax_loads(name, shape):
    host = _host(name, shape)
    blob = ck.save_array(_to_torch(host))
    with _x64(name):
        on_dev = jck.load_array(blob)
        on_host = jck.load_array(blob, to_device=False)
    assert on_dev.dtype == host.dtype and on_dev.shape == host.shape
    assert _bytes(on_dev) == _bytes(host)
    assert on_host.dtype == host.dtype and _bytes(on_host) == _bytes(host)


def test_bool_loads_by_value():
    """int8 keeps its byte values; a bool byte other than 0 and 1 loads
    as True, as the JAX package's astype does."""
    t = torch.tensor([-128, -1, 0, 1, 127], dtype=torch.int8)
    assert torch.equal(ck.load_array(ck.save_array(t)), t)
    blob = ck.save_array(torch.tensor([0, 1, 2, 255], dtype=torch.uint8))
    blob = _with_manifest(blob, json.dumps(
        {"dtype": "bool", "shape": [4], "v": 1}, sort_keys=True).encode())
    want = torch.tensor([False, True, True, True])
    assert torch.equal(ck.load_array(blob), want)
    assert np.array_equal(np.asarray(jck.load_array(blob)), want.numpy())


def test_dtype_names():
    for name in ("float64", "float32", "float16", "bfloat16", "int64",
                 "int32", "int16", "int8", "uint8", "bool", "complex64",
                 "complex128"):
        assert str(ck.DTYPES[name]) == f"torch.{name}"
    for name, dt in ck.DTYPES.items():
        blob = ck.save_array(torch.zeros(3, dtype=dt))
        assert ck._split_meta(blob) == {"dtype": name, "shape": [3], "v": 1}
        assert b"torch" not in blob
        assert ck.load_array(blob).dtype == dt
    with pytest.raises(ValueError):
        ck.save_array(torch.zeros(2, dtype=torch.float8_e4m3fn))


def test_complex_roundtrip(nprng):
    """complex64/128 round-trip through the port (the JAX package cannot
    save them: bitcast_convert_type refuses complex values)."""
    for dt in (torch.complex64, torch.complex128):
        t = torch.from_numpy(nprng.standard_normal((40, 9))).to(dt) * 1j
        blob = ck.save_array(t)
        assert torch.equal(ck.load_array(blob), t)
        assert framing.decompress_framed(blob) == _bytes(t)


def test_stream_is_foreign_valid(nprng):
    """A checkpoint is a valid framed stream: decoders skip the manifest
    chunk and give the tensor's bytes."""
    host = np.frombuffer(nprng.bytes(70_000), np.uint8)
    blob = ck.save_array(torch.from_numpy(host.copy()))
    assert native.decompress_framed(blob) == host.tobytes()
    assert framing.decompress_framed(blob) == host.tobytes()
    assert jdc.decompress_framed(blob) == host.tobytes()
    assert dc.decompress_framed(blob, device="cpu") == host.tobytes()
    # the stream after the manifest is the tensor's native framed stream
    n = int.from_bytes(blob[11:14], "little")
    assert blob[10] == ck.CHUNK_META
    assert blob[:10] + blob[14 + n:] == native.compress_framed(host.tobytes())


def test_corruption_detected():
    t = torch.arange(100_000, dtype=torch.float32)
    blob = bytearray(ck.save_array(t))
    blob[200] ^= 0xFF  # payload byte
    with pytest.raises(ChecksumError):
        ck.load_array(bytes(blob))
    with pytest.raises(ChecksumError):
        ck.load_array(bytes(blob), to_device=False)
    with pytest.raises(CorruptError):
        ck.load_array(b"\xff\x06\x00\x00sNaPpY")  # no manifest
    with pytest.raises(CorruptError):  # fewer bytes than the manifest says
        ck.load_array(ck.save_array(t).replace(b"[100000]", b"[100001]"))


def _tree():
    return {
        "w": torch.arange(5000, dtype=torch.float32),
        "b": torch.from_numpy(np.frombuffer(bytes(range(64)), np.uint8).copy()),
        "step": torch.tensor([7], dtype=torch.int32),
        "half": torch.linspace(-2, 2, 999).to(torch.bfloat16),
    }


def test_pytree_container():
    tree = _tree()
    blob = ck.save_pytree(tree)
    back = ck.load_pytree(blob)
    assert sorted(back) == sorted(tree)
    for k in tree:
        assert torch.equal(back[k], tree[k]), k
    on_host = ck.load_pytree(blob, to_device=False)
    assert all(torch.equal(on_host[k], tree[k]) for k in tree)
    with pytest.raises(CorruptError):
        ck.load_pytree(blob + b"x")
    with pytest.raises(CorruptError):
        ck.load_pytree(b"NOTACKPT" + blob[8:])
    names = [name for name, _, _ in ck.container_entries(blob)]
    assert names == sorted(tree)


def test_pytree_cross_load():
    tree = _tree()
    jtree = {k: jax.device_put(
        np.asarray(v.view(torch.int16).numpy()).view(jnp.bfloat16)
        if v.dtype == torch.bfloat16 else v.numpy()) for k, v in tree.items()}
    jblob = jck.save_pytree(jtree)
    blob = ck.save_pytree(tree)
    assert blob == jblob
    back = ck.load_pytree(jblob)
    jback = jck.load_pytree(blob)
    for k in tree:
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
        assert _bytes(jback[k]) == _bytes(tree[k]), k


@pytest.mark.parametrize("cut", [9, 10, 13, 15, 20, -1, "half"])
def test_truncated_container_raises_corrupt(cut):
    """The port raises CorruptError for every truncation; the JAX package
    raises a bare struct.error where a length field is cut."""
    blob = ck.save_pytree(_tree())
    cut = len(blob) // 2 if cut == "half" else cut
    with pytest.raises(CorruptError):
        ck.load_pytree(blob[:cut])
    if cut in (9, 10, 13, 15):  # inside a count or name-length field
        with pytest.raises(struct.error):
            jck.load_pytree(blob[:cut])


def _with_manifest(blob: bytes, payload: bytes) -> bytes:
    n = int.from_bytes(blob[11:14], "little")
    m = len(payload)
    return (blob[:10] + bytes((ck.CHUNK_META, m & 255, (m >> 8) & 255,
                               m >> 16)) + payload + blob[14 + n:])


# malformed manifests, and what the JAX package raises for each
MANIFESTS = [
    (b"not json", jerr.CorruptError),
    (b"\xff\xfe", jerr.CorruptError),
    (b"[1, 2]", AttributeError),
    (json.dumps({"dtype": "float32", "shape": [4], "v": 2}).encode(),
     jerr.CorruptError),
    (json.dumps({"dtype": "float99", "shape": [4], "v": 1}).encode(),
     TypeError),
    (json.dumps({"dtype": "float32", "shape": 4, "v": 1}).encode(),
     TypeError),
    (json.dumps({"dtype": "float32", "v": 1}).encode(), KeyError),
]


@pytest.mark.parametrize("payload,jax_exc", MANIFESTS)
def test_malformed_manifest_raises_corrupt(payload, jax_exc):
    blob = _with_manifest(ck.save_array(torch.ones(4)), payload)
    with pytest.raises(CorruptError):
        ck.load_array(blob)
    with pytest.raises(jax_exc):
        jck.load_array(blob)


def test_manifest_past_the_end():
    blob = ck.save_array(torch.ones(4))
    with pytest.raises(CorruptError):
        ck.load_array(blob[:10] + bytes((ck.CHUNK_META, 200, 0, 0)) + b"{}")


def test_save_moves_cpu_tensor_to_default_device(monkeypatch):
    """A CPU tensor goes to the resolved default device before its bytes
    are compressed (on a GPU machine, cuda:0); a device tensor stays."""
    seen = []

    def spy(flat):
        seen.append(flat.device)
        return bytes(STREAM_ID_CHUNK)

    monkeypatch.setattr(ck, "compress_framed_from_device", spy)
    monkeypatch.setattr(ck, "resolve", lambda device: torch.device("meta"))
    ck.save_array(torch.ones(3))
    ck.save_array(np.ones(3, np.float32))
    ck.save_array(torch.ones(3, device="meta"))
    assert [d.type for d in seen] == ["meta"] * 3


@pytest.mark.parametrize("n_shards", [8, 2])
def test_sharded_array_roundtrip(n_shards):
    """tests/test_checkpoint.py's sharded case: rows laid out over a mesh
    save to the bytes of the gathered tensor and of JAX's save_array of
    the same values on its mesh, and load back."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from snappy_tpu.dist import mesh as jmesh
    from snappy_tpu_torch.dist import mesh as tmesh

    if len(jax.devices()) < n_shards:
        pytest.skip(f"needs {n_shards} jax devices")
    host = np.arange(8 * 40_000, dtype=np.float32).reshape(8, 40_000)
    rows = tmesh.shard_rows(tmesh.make_mesh(devices=["cpu"] * n_shards),
                            host)
    blob = ck.save_array(rows)
    assert blob == ck.save_array(torch.from_numpy(host))
    assert blob == jck.save_array(jax.device_put(
        host, NamedSharding(jmesh.make_mesh(n_shards), P("d"))))
    back = ck.load_array(blob)
    assert back.shape == (8, 40_000) and back.dtype == torch.float32
    _same(back, host)


def _gpt2_shaped(n_layer: int, d: int, vocab: int, ctx: int, seed: int):
    """A state dict with GPT-2's tensor shapes, values as at
    initialisation: weights normal(0, 0.02), LayerNorm weights ones,
    biases zeros."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    state = {"wte.weight": w(vocab, d), "wpe.weight": w(ctx, d),
             "ln_f.weight": torch.ones(d), "ln_f.bias": torch.zeros(d)}
    for i in range(n_layer):
        p = f"h.{i}."
        state.update({
            p + "ln_1.weight": torch.ones(d), p + "ln_1.bias": torch.zeros(d),
            p + "attn.c_attn.weight": w(d, 3 * d),
            p + "attn.c_attn.bias": torch.zeros(3 * d),
            p + "attn.c_proj.weight": w(d, d),
            p + "attn.c_proj.bias": torch.zeros(d),
            p + "ln_2.weight": torch.ones(d), p + "ln_2.bias": torch.zeros(d),
            p + "mlp.c_fc.weight": w(d, 4 * d),
            p + "mlp.c_fc.bias": torch.zeros(4 * d),
            p + "mlp.c_proj.weight": w(4 * d, d),
            p + "mlp.c_proj.bias": torch.zeros(d),
        })
    return state


def test_gpt2_medium_shaped_state():
    """GPT-2 medium's tensor layout at 2 layers, d_model 64, vocab 512:
    the container's bytes equal the JAX package's, each stream after its
    manifest equals native.compress_framed of the tensor's bytes, and it
    loads in both packages."""
    state = _gpt2_shaped(2, 64, 512, 128, seed=3)
    assert len(state) == 4 + 12 * 2
    blob = ck.save_pytree(state)
    jblob = jck.save_pytree({k: jax.device_put(v.numpy())
                             for k, v in state.items()})
    assert blob == jblob
    for name, lo, hi in ck.container_entries(blob):
        entry = blob[lo:hi]
        n = int.from_bytes(entry[11:14], "little")
        assert entry[:10] + entry[14 + n:] == native.compress_framed(
            _bytes(state[name])), name
    back = ck.load_pytree(blob)
    jback = jck.load_pytree(blob)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
        assert _bytes(jback[k]) == _bytes(v), k


def test_seq_engine_checkpoint(monkeypatch):
    """Under the device LZ engine the container bytes are the same."""
    state = _gpt2_shaped(1, 32, 300, 64, seed=4)
    want = ck.save_pytree(state)
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", False)
    blob = ck.save_pytree(state)
    assert blob == want
    back = ck.load_pytree(blob)
    assert all(torch.equal(back[k], v) for k, v in state.items())
