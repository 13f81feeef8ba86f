"""The port stands alone: nothing of ``snappy_tpu`` (or jax) is imported
by ``snappy_tpu_torch`` or ``chip_smoke.py``, and the port's copies of the
JAX package's JAX-free modules (the native host codec, the CRC oracle,
the benchmark corpus) give the same bytes as the originals on the same
inputs.  Tolerance: 0 (byte-exact)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from snappy_tpu import errors as jerrors
from snappy_tpu import native as jnative
from snappy_tpu.bench.corpus import make_corpus as jmake_corpus
from snappy_tpu.spec.crc32c import _TABLE as JTABLE
from snappy_tpu.spec.crc32c import crc32c as jcrc32c
from snappy_tpu.spec.crc32c import crc_combine as jcrc_combine
from snappy_tpu.spec import framing as jframing
from snappy_tpu_torch import errors, native
from snappy_tpu_torch.bench.corpus import make_corpus
from snappy_tpu_torch.spec.crc32c import _TABLE, crc32c, crc_combine
from snappy_tpu_torch.spec import framing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "snappy_tpu_torch")

MODULES = [
    "api", "checkpoint", "cli.main", "device", "dist", "dist.mesh",
    "dist.multihost", "errors", "native",
    "runtime.device_codec", "runtime.stream",
    "kernels._build", "kernels.common_par", "kernels.crc32c",
    "kernels.decode_flat", "kernels.decode_par", "kernels.decode_pretagged",
    "kernels.decode_seq", "kernels.decode_wavegroup", "kernels.encode_flat",
    "kernels.encode_np", "kernels.encode_par", "kernels.encode_seq",
    "kernels.match",
    "spec", "spec.crc32c", "spec.format", "spec.framing", "spec.reference",
    "bench.corpus", "bench.kernel_cost", "bench.pretagged_profile",
    "bench.seq_profile",
    "utils.hostmem", "utils.log",
    "utils.progress", "utils.trace",
]


def _sources():
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_fresh_interpreter_imports_nothing_of_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module('snappy_tpu_torch.' + m)\n"
        "import snappy_tpu_torch as st\n"
        "from snappy_tpu_torch import native\n"
        "assert native.available()\n"
        "d = bytes(range(256)) * 700\n"
        "assert st.decompress_framed(st.compress_framed(d, device='cpu'),\n"
        "                            device='cpu') == d\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'snappy_tpu')\n"
        "             or m.startswith(('jax.', 'snappy_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_package(path):
    """An ``ast`` scan: no ``import snappy_tpu...`` or ``from snappy_tpu...``
    other than ``snappy_tpu_torch``, and no jax, at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("snappy_tpu", "jax", "jaxlib"):
                bad.append((node.lineno, name))
    assert not bad, bad


def test_native_builds_into_the_port():
    assert native.available()
    assert os.path.dirname(native._SO) == os.path.join(PKG, "_build")
    assert native._SRC.startswith(os.path.join(PKG, "native", "src"))
    assert not native._SO.startswith(os.path.join(REPO, "snappy_tpu", ""))


def _inputs():
    rng = np.random.default_rng(20260816)
    corpus = b"".join(d for _, d in make_corpus(1 << 20, seed=7))
    return [b"", b"x", b"abc" * 10, bytes(65536), rng.bytes(70_000),
            corpus[:300_000], corpus[-200_000:] + rng.bytes(5)]


@pytest.mark.parametrize("i", range(7))
def test_native_matches_the_jax_package(i):
    data = _inputs()[i]
    raw = native.compress(data)
    assert raw == jnative.compress(data)
    fr = native.compress_framed(data)
    assert fr == jnative.compress_framed(data)
    assert native.decompress(raw) == jnative.decompress(raw) == data
    assert native.decompress_framed(fr) == jnative.decompress_framed(fr) == data
    assert framing.compress_framed(data) == jframing.compress_framed(data)
    assert native.crc32c(data) == jnative.crc32c(data) == crc32c(data) \
        == jcrc32c(data)


def test_errors_match_the_jax_package():
    """The port raises its own classes, with the JAX package's names,
    messages and exit codes."""
    fr = bytearray(native.compress_framed(b"probe " * 3000))
    fr[14] ^= 1
    with pytest.raises(errors.ChecksumError) as got:
        native.decompress_framed(bytes(fr))
    with pytest.raises(jerrors.ChecksumError) as want:
        jnative.decompress_framed(bytes(fr))
    assert str(got.value) == str(want.value)
    assert not isinstance(got.value, jerrors.SnappyError)
    for name in ("CorruptError", "ChecksumError", "UnsupportedError",
                 "TooLargeError", "BadMagicError"):
        exc = getattr(errors, name)()
        assert errors.exit_code_for(exc) == jerrors.exit_code_for(
            getattr(jerrors, name)())
    assert crc_combine(1, 2, 3) == jcrc_combine(1, 2, 3)
    assert np.array_equal(_TABLE, JTABLE)


def test_corpus_matches_the_jax_package():
    assert make_corpus(8 << 20, seed=20260816) == \
        jmake_corpus(8 << 20, seed=20260816)


# the head note the port's copy of the native source carries, and the
# package name its path lines and imports use
_HEAD_NOTE = ("// The port's copy of snappy_tpu/native/src/snappy_native.cpp: "
              "a fix to one\n// copy is made in both.\n")


def _as_original(text: str) -> str:
    """A port copy's text as the JAX package's original would read."""
    return text.replace(_HEAD_NOTE, "").replace("snappy_tpu_torch",
                                                "snappy_tpu")


@pytest.mark.parametrize("rel", [
    "native/src/snappy_native.cpp", "spec/__init__.py", "spec/crc32c.py",
    "spec/format.py", "spec/framing.py", "spec/reference.py"])
def test_copies_equal_their_originals(rel):
    """The port's copies of the native codec (the hybrid engine's
    ``sn_parse_tags`` included) and of ``spec/`` equal the JAX package's
    files apart from the head note and the package name, so that a fix
    made to one copy and not the other fails here."""
    with open(os.path.join(PKG, rel)) as f:
        port = f.read()
    with open(os.path.join(REPO, "snappy_tpu", rel)) as f:
        original = f.read()
    if rel.endswith(".cpp"):
        assert port.startswith(port.split("\n")[0] + "\n" + _HEAD_NOTE)
    assert _as_original(port) == original
