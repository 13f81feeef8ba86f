"""The port's multi-host codec (``snappy_tpu_torch.dist.multihost``)
against the JAX package's (``snappy_tpu.dist.multihost``) with its id
engine forced: the planners, the per-host compress records, decompress
ranges, the to-device loader and the from-device encode on a CPU mesh,
on the same seeded inputs; and ``python -m
snappy_tpu_torch.dist.multihost`` run as two processes over gloo on the
CPU.  The cases of tests/test_multihost.py.  Tolerance: 0 (byte-exact)."""

import json
import os
import random
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from snappy_tpu.dist import mesh as jmesh
from snappy_tpu.dist import multihost as jmh
from snappy_tpu.runtime import device_codec as jdc
from snappy_tpu_torch import native
from snappy_tpu_torch.bench.corpus import make_corpus
from snappy_tpu_torch.dist import mesh as tmesh
from snappy_tpu_torch.dist import multihost as mh
from snappy_tpu_torch.errors import ChecksumError, CorruptError
from snappy_tpu_torch.runtime import device_codec as dc
from snappy_tpu_torch.spec.format import STREAM_ID_CHUNK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def jax_id_engine(monkeypatch):
    monkeypatch.setattr(jdc, "_pallas_cache", True)
    monkeypatch.setattr(jdc, "FLAT_MODE", "id")


@pytest.fixture
def rng():
    return random.Random(1234)


def _jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} jax devices")
    return jmesh.make_mesh(n)


@pytest.mark.parametrize("total", [0, 1, 65535, 65536, 65537,
                                   65536 * 10 + 5, 65536 * 33])
@pytest.mark.parametrize("hosts", [1, 2, 3, 4, 7])
def test_plan_ranges(total, hosts):
    r = mh.plan_ranges(total, hosts)
    assert r == jmh.plan_ranges(total, hosts)
    assert mh.plan_ranges(total, hosts, 4096) == jmh.plan_ranges(
        total, hosts, 4096)
    counts = [c for _, c in r]
    assert max(counts) - min(counts) <= 1
    for (s1, c1), (s2, _) in zip(r, r[1:]):
        assert s2 == s1 + c1


@pytest.mark.parametrize("n_chunks", [0, 1, 2, 11, 64, 16384])
@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_plan_chunk_ranges(n_chunks, hosts):
    r = mh.plan_chunk_ranges(n_chunks, hosts)
    assert r == jmh.plan_chunk_ranges(n_chunks, hosts)
    assert sum(c for _, c in r) == n_chunks


def _assemble(host_compress, data, n_hosts, chunk_size=65536, **kw):
    parts = []
    for start, cnt in mh.plan_ranges(len(data), n_hosts, chunk_size):
        lo = start * chunk_size
        hi = min(len(data), (start + cnt) * chunk_size)
        bodies, lengths = host_compress(data[lo:hi], start, chunk_size, **kw)
        assert list(lengths) == [len(b) for b in bodies]
        parts.append(bodies)
    return parts


def test_two_host_assembly_parity(rng):
    data = (b"multi host corpus " * 9000)[:100000] + rng.randbytes(120000)
    single = dc.compress_framed(data, device="cpu")
    assert single == native.compress_framed(data)
    parts = _assemble(mh.host_compress_framed, data, 2, device="cpu")
    assert parts == _assemble(jmh.host_compress_framed, data, 2)
    for bodies in parts:
        lengths = np.array([len(b) for b in bodies], np.int64)
        assert mh.gather_lengths(lengths) is lengths  # 1-process path
    assembled = bytes(STREAM_ID_CHUNK) + b"".join(b"".join(p) for p in parts)
    assert assembled == single
    assert dc.decompress_framed(assembled, device="cpu") == data


@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_host_decompress_parity(rng, n_hosts):
    """N-way decompress split reassembles bit for bit, each host's piece
    equal to JAX's, with per-host stats."""
    data = (b"decompress side " * 9000)[:110000] + rng.randbytes(130000) + b"tail"
    framed = native.compress_framed(data)
    out = bytearray()
    for pid in range(n_hosts):
        base, blob, total, stats = mh.host_decompress_framed(
            framed, pid, n_hosts, device="cpu")
        jbase, jblob, jtotal, jstats = jmh.host_decompress_framed(
            framed, pid, n_hosts)
        assert (base, blob, total) == (jbase, jblob, jtotal)
        assert {k: stats[k] for k in ("host", "chunks", "bytes")} == \
            {k: jstats[k] for k in ("host", "chunks", "bytes")}
        assert total == len(data) and stats["bytes"] == len(blob)
        assert base == len(out)  # contiguous, ordered
        out += blob
    assert bytes(out) == data


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_host_decompress_hybrid_engine(rng, monkeypatch, n_hosts):
    """The per-host decompress under the hybrid engine (the port's FLAT=0
    with HOST_PARSE=1, JAX with its kernel engines off), at BATCH 2 so
    that each host runs several batches: each host's piece equals JAX's
    and a flipped CRC raises on the host that holds the chunk."""
    monkeypatch.setattr(dc, "FLAT", False)
    monkeypatch.setattr(dc, "HOST_PARSE", True)
    monkeypatch.setattr(jdc, "_pallas_cache", False)
    monkeypatch.setattr(jdc, "HOST_PARSE", True)
    monkeypatch.setattr(dc, "BATCH", 2)
    data = (b"hybrid hosts " * 30000)[:300000] + rng.randbytes(70000)
    framed = native.compress_framed(data)
    out = bytearray()
    for pid in range(n_hosts):
        base, blob, total, _stats = mh.host_decompress_framed(
            framed, pid, n_hosts, device="cpu")
        assert (base, blob, total) == jmh.host_decompress_framed(
            framed, pid, n_hosts)[:3]
        out += blob
    assert bytes(out) == data
    bad = bytearray(framed)
    bad[14] ^= 1  # the first chunk's CRC: host 0's
    with pytest.raises(ChecksumError):
        mh.host_decompress_framed(bytes(bad), 0, n_hosts, device="cpu")


@pytest.mark.parametrize("chunk_size", [65536, 20000])
def test_two_host_parity_flat_engines(rng, monkeypatch, chunk_size):
    """Per-host compress and decompress ranges stay bit-identical to the
    single-process stream and to JAX's with the port's classify engine
    (the flat kernel's plain version: the encode replay and the plan
    decode)."""
    monkeypatch.setattr(dc, "FLAT_MODE", "classify")
    data = (b"flat multihost " * 4000)[:50000] + rng.randbytes(40000)
    single = dc.compress_framed(data, chunk_size, device="cpu")
    parts = _assemble(mh.host_compress_framed, data, 2, chunk_size,
                      device="cpu")
    assert parts == _assemble(jmh.host_compress_framed, data, 2, chunk_size)
    assert bytes(STREAM_ID_CHUNK) + b"".join(
        b"".join(p) for p in parts) == single

    out = bytearray(len(data))
    for pid in range(2):
        base, blob, total, _ = mh.host_decompress_framed(single, pid, 2,
                                                         device="cpu")
        assert total == len(data)
        out[base : base + len(blob)] = blob
    assert bytes(out) == data


def test_host_decompress_detects_corruption(rng):
    data = rng.randbytes(140000)
    framed = bytearray(native.compress_framed(data))
    framed[-1] ^= 0xFF
    # the corrupted tail chunk lands in the last host's range
    with pytest.raises((ChecksumError, CorruptError)):
        mh.host_decompress_framed(bytes(framed), 1, 2, device="cpu")
    # the first host's range is clean, as in JAX
    got = mh.host_decompress_framed(bytes(framed), 0, 2, device="cpu")
    assert got[:3] == jmh.host_decompress_framed(bytes(framed), 0, 2)[:3]


def test_host_decompress_framed_to_device_partition(rng):
    """Per-host device-resident chunk ranges tile the stream exactly,
    rows equal to JAX's on its 2-device mesh, no collective."""
    jm = _jax_mesh(2)
    data = (b"multihost loader " * 9000)[:150_000] + rng.randbytes(80_000)
    fr = native.compress_framed(data)
    tm = tmesh.make_mesh(devices=["cpu"] * 2)
    got = {}
    for pid in range(2):
        rows, dlens, lo, cnt = mh.host_decompress_framed_to_device(
            fr, pid, 2, mesh=tm)
        jrows, jdlens, jlo, jcnt = jmh.host_decompress_framed_to_device(
            fr, pid, 2, mesh=jm)
        assert (lo, cnt) == (jlo, jcnt)
        np.testing.assert_array_equal(dlens, jdlens)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        host = rows.numpy()
        for i in range(cnt):
            got[lo + i] = host[i, : dlens[i]].tobytes()
    assert b"".join(got[i] for i in sorted(got)) == data
    assert sorted(got) == list(range(len(got)))


def test_host_compress_from_device_full_circle(rng):
    """Each simulated host loads its chunk range onto its mesh, encodes
    it again from the device rows, and the stream assembled at the
    gathered offsets is byte-identical to the single-host stream and to
    JAX's records."""
    jm = _jax_mesh(2)
    data = (b"from-device multihost " * 9000)[:200_000] + rng.randbytes(70_000)
    fr = native.compress_framed(data)
    tm = tmesh.make_mesh(devices=["cpu"] * 2)
    out = bytearray(STREAM_ID_CHUNK)
    all_lengths = []
    for pid in range(2):
        rows, dlens, lo, cnt = mh.host_decompress_framed_to_device(
            fr, pid, 2, mesh=tm)
        bodies, lengths = mh.host_compress_framed_from_device(rows, dlens)
        jrows, jdlens, _, _ = jmh.host_decompress_framed_to_device(
            fr, pid, 2, mesh=jm)
        jbodies, jlengths = jmh.host_compress_framed_from_device(
            jrows, jdlens, mesh=jm)
        assert bodies == jbodies
        np.testing.assert_array_equal(lengths, jlengths)
        # a plain tensor laid out again over a 1-shard mesh: same records
        flat, _ = mh.host_compress_framed_from_device(
            rows.cpu(), dlens, mesh=tmesh.make_mesh(devices=["cpu"]))
        assert flat == bodies
        assert len(bodies) == cnt
        all_lengths.append(lengths)
        out += b"".join(bodies)
    assert bytes(out) == fr
    assert native.decompress_framed(bytes(out)) == data
    assert int(np.concatenate(all_lengths).sum()) == len(fr) - len(
        STREAM_ID_CHUNK)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(args_per_rank, timeout=60):
    """Run one ``python -m snappy_tpu_torch.dist.multihost`` process per
    argument list, all at once; returns each one's JSON stats line."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "snappy_tpu_torch.dist.multihost", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for args in args_per_rank]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_cli_two_processes_over_gloo(tmp_path):
    """Two processes on the CPU, gloo on 127.0.0.1: compress writes the
    single-process stream (JAX's host_compress_framed assembly), and
    decompress gives back the input."""
    data = b"".join(d for _, d in make_corpus(300_000, seed=11))
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    jparts = _assemble(jmh.host_compress_framed, data, 2)
    want = bytes(STREAM_ID_CHUNK) + b"".join(b"".join(p) for p in jparts)
    assert want == native.compress_framed(data)
    for cmd, inp, out, expect in (
            ("compress", src, tmp_path / "two.sz", want),
            ("decompress", tmp_path / "two.sz", tmp_path / "two.out", data)):
        port = _free_port()
        stats = _cli([["--device", "cpu", "--coordinator",
                       f"127.0.0.1:{port}", "--num-processes", "2",
                       "--process-id", str(i), "--timeout", "30", cmd,
                       str(inp), str(out)] for i in range(2)])
        assert [s["host"] for s in stats] == [0, 1]
        assert all(s["command"] == cmd and s["device"] == "cpu"
                   for s in stats)
        assert out.read_bytes() == expect, cmd
        one = tmp_path / f"one.{cmd}"
        _cli([["--device", "cpu", cmd, str(inp), str(one)]])
        assert one.read_bytes() == expect, cmd
