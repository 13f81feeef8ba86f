"""The port's CLI (``python -m snappy_tpu_torch``, ``tpusnappy-torch``):
the cases of tests/test_cli.py but ``bench``, driven through ``main()``
on the port's "native" and "torch" backends, each output file held byte
for byte against the JAX package's CLI under ``--backend native``, and
a fresh-interpreter run of the port's public surface without jax.
Tolerance: 0 (byte-exact)."""

import contextlib
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from snappy_tpu import native
from snappy_tpu.cli.main import main as jax_main
from snappy_tpu_torch.errors import ChecksumError, exit_code_for
from snappy_tpu.spec import framing
from snappy_tpu_torch.cli import main as cli_main
from snappy_tpu_torch.cli.main import main

# the JAX package's snappy_tpu.cli exports the function main, which
# shadows its module of the same name
jax_cli = importlib.import_module("snappy_tpu.cli.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("native", "torch")


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param


@pytest.fixture
def workdir(tmp_path, rng):
    p = tmp_path / "data.bin"
    p.write_bytes(b"cli test payload " * 2000 + rng.randbytes(5000))
    return tmp_path, p


def _jax_out(argv, path):
    """The bytes the JAX CLI writes to ``path`` for ``argv``."""
    assert jax_main(argv + ["-o", str(path), "-q", "--backend", "native"]) == 0
    return path.read_bytes()


def test_compress_verify_decompress_roundtrip(workdir, backend):
    tmp, src = workdir
    out = tmp / "data.sz"
    dec = tmp / "data.out"
    assert main(["compress", str(src), "-o", str(out), "--verify", "-q",
                 "--backend", backend]) == 0
    assert out.read_bytes() == _jax_out(["compress", str(src)],
                                        tmp / "jax.sz")
    assert main(["decompress", str(out), "-o", str(dec), "-q",
                 "--backend", backend]) == 0
    assert dec.read_bytes() == src.read_bytes()
    # no tmp droppings from atomic writes
    assert not [f for f in os.listdir(tmp) if f.startswith(".tpusnappy-")]


def test_default_output_names(workdir):
    """No -o: compress writes FILE.sz (FILE.snappy raw) and decompress
    strips the suffix, on the default backend ("torch")."""
    tmp, src = workdir
    data = src.read_bytes()
    assert main(["compress", str(src), "-q"]) == 0
    assert (tmp / "data.bin.sz").read_bytes() == native.compress_framed(data)
    assert main(["compress", str(src), "--format", "raw", "-q"]) == 0
    assert (tmp / "data.bin.snappy").read_bytes() == native.compress(data)
    src.unlink()
    assert main(["decompress", str(tmp / "data.bin.sz"), "-q"]) == 0
    assert src.read_bytes() == data


def test_verify_and_info(workdir, capsys, backend):
    tmp, src = workdir
    out = tmp / "data.sz"
    main(["compress", str(src), "-o", str(out), "-q", "--backend", backend])
    assert main(["verify", str(out), "--backend", backend, "--digest"]) == 0
    assert main(["info", str(out)]) == 0
    text = capsys.readouterr().out
    assert "framed" in text and "ratio" in text and "sha512" in text
    assert jax_main(["info", str(out)]) == 0
    jtext = capsys.readouterr().out
    assert text.split("\n", 1)[1].replace("snappy_tpu_torch", "snappy_tpu") \
        .endswith(jtext)  # same report after the verify lines


def test_corrupt_exit_code(workdir, backend):
    tmp, src = workdir
    out = tmp / "data.sz"
    main(["compress", str(src), "-o", str(out), "-q", "--backend", backend])
    blob = bytearray(out.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    bad = tmp / "bad.sz"
    bad.write_bytes(bytes(blob))
    rc = main(["verify", str(bad), "--backend", backend])
    assert rc != 0
    assert rc == jax_main(["verify", str(bad), "--backend", "native"])
    # a flipped CRC field: the checksum exit code
    crc = bytearray(out.read_bytes())
    crc[14] ^= 0x01
    bad.write_bytes(bytes(crc))
    assert main(["verify", str(bad), "--backend", backend]) == \
        exit_code_for(ChecksumError())


def test_missing_file():
    assert main(["compress", "/nonexistent/file", "-q"]) == 2


def test_raw_format_roundtrip(workdir, backend):
    tmp, src = workdir
    out = tmp / "data.snappy"
    dec = tmp / "raw.out"
    assert main(["compress", str(src), "-o", str(out), "--format", "raw",
                 "-q", "--backend", backend]) == 0
    assert out.read_bytes() == _jax_out(
        ["compress", str(src), "--format", "raw"], tmp / "jax.snappy")
    assert main(["decompress", str(out), "-o", str(dec), "-q",
                 "--backend", backend]) == 0
    assert dec.read_bytes() == src.read_bytes()


def test_streaming_compress_roundtrip(tmp_path, rng, monkeypatch, backend):
    """Slab-streamed path: bounded-memory compress + verify + decompress
    (threshold lowered so the test stays small), the same bytes as the
    JAX CLI's streamed output."""
    for mod in (cli_main, jax_cli):
        monkeypatch.setattr(mod, "STREAM_THRESHOLD", 100_000)
        monkeypatch.setattr(mod, "_SLAB", 70_000)
    src = tmp_path / "big.bin"
    data = (b"streaming payload " * 30000)[:400_000] + rng.randbytes(150_000)
    src.write_bytes(data)
    out = tmp_path / "big.sz"
    dec = tmp_path / "big.out"
    assert main(["compress", str(src), "-o", str(out), "--verify", "-q",
                 "--backend", backend]) == 0
    assert out.read_bytes() == _jax_out(["compress", str(src)],
                                        tmp_path / "jax.sz")
    assert main(["decompress", str(out), "-o", str(dec), "-q",
                 "--backend", backend]) == 0
    assert dec.read_bytes() == data
    assert framing.decompress_framed(out.read_bytes()) == data


def test_streaming_meter_records(tmp_path, rng, monkeypatch):
    """The progress meter is wired through the streaming path."""
    from snappy_tpu.utils import progress

    events = []

    class Recorder(progress.Meter):
        def start(self, label, total):
            events.append(("start", label, total))

        def set(self, done):
            events.append(("set", done))

        def finish(self):
            events.append(("finish",))

    monkeypatch.setattr(cli_main, "STREAM_THRESHOLD", 50_000)
    monkeypatch.setattr(cli_main, "_SLAB", 64 << 10)
    monkeypatch.setattr(cli_main, "_make_meter", lambda args: Recorder())
    src = tmp_path / "m.bin"
    src.write_bytes(rng.randbytes(200_000))
    out = tmp_path / "m.sz"
    assert main(["compress", str(src), "-o", str(out), "-q",
                 "--backend", "torch"]) == 0
    starts = [e for e in events if e[0] == "start"]
    sets = [e for e in events if e[0] == "set"]
    assert starts and starts[0][2] == 200_000
    assert sets and sets[-1][1] == 200_000
    assert ("finish",) in events


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _cli(args, data):
    return subprocess.run([sys.executable, "-m", "snappy_tpu_torch", *args],
                          input=data, capture_output=True, env=_env(),
                          cwd=REPO, timeout=300)


def test_pipe_streaming_roundtrip(rng):
    """`compress - -o -` / `decompress - -o -` stream framed bytes through
    stdin/stdout; a raw stream on the auto path is found by the magic
    peek; --verify on a pipe is refused."""
    data = b"pipe me " * 40000 + rng.randbytes(50_000)
    c = _cli(["compress", "-", "-o", "-", "-q"], data)
    assert c.returncode == 0, c.stderr[-300:]
    assert c.stdout == native.compress_framed(data)
    d = _cli(["decompress", "-", "-o", "-", "-q"], c.stdout)
    assert d.returncode == 0, d.stderr[-300:]
    assert d.stdout == data
    d = _cli(["decompress", "-", "-o", "-", "-q"], native.compress(data))
    assert d.returncode == 0, d.stderr[-300:]
    assert d.stdout == data
    v = _cli(["compress", "-", "-o", "-", "--verify", "-q"], data)
    assert v.returncode == 2


def test_info_shows_checkpoint_manifest(tmp_path):
    from snappy_tpu_torch import checkpoint

    p = tmp_path / "w.sz"
    p.write_bytes(checkpoint.save_array(
        torch.arange(1000, dtype=torch.int32).reshape(10, 100)))
    for fn in (main, jax_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(["info", str(p)]) == 0
        out = buf.getvalue()
        assert "checkpoint:" in out and "int32" in out and "[10, 100]" in out
    # a foreign skippable chunk where the manifest would be: no line
    blob = bytearray(p.read_bytes())
    blob[14:16] = b"[]"
    p.write_bytes(bytes(blob))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["info", str(p)]) == 0
    assert "checkpoint:" not in buf.getvalue()


def test_surface_imports_no_jax(tmp_path):
    """The port's api, stream, checkpoint and CLI run a checkpoint round
    trip and a CLI round trip in a fresh interpreter without importing
    jax (the GPU machine has none)."""
    src = tmp_path / "in.bin"
    src.write_bytes(bytes(range(256)) * 900)
    code = (
        "import io, sys, torch\n"
        "import snappy_tpu_torch.api, snappy_tpu_torch.runtime.stream\n"
        "import snappy_tpu_torch.checkpoint as ck, snappy_tpu_torch.cli.main as cm\n"
        "t = {'w': torch.randn(300, 70), 'b': torch.ones(5, dtype=torch.bfloat16)}\n"
        "back = ck.load_pytree(ck.save_pytree(t))\n"
        "assert all(torch.equal(back[k], t[k]) for k in t)\n"
        f"src = {str(src)!r}\n"
        "assert cm.main(['compress', src, '-o', src + '.sz', '-q']) == 0\n"
        "assert cm.main(['decompress', src + '.sz', '-o', src + '.out', '-q']) == 0\n"
        "assert open(src + '.out', 'rb').read() == open(src, 'rb').read()\n"
        "w = io.BytesIO()\n"
        "with snappy_tpu_torch.runtime.stream.FramedWriter(w) as f: f.write(b'x' * 99)\n"
        "assert snappy_tpu_torch.api.decompress_framed(w.getvalue()) == b'x' * 99\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert np.array_equal(np.fromfile(str(src) + ".out", np.uint8),
                          np.fromfile(src, np.uint8))
