"""Deterministic Silesia-like benchmark corpus.

The real Silesia corpus (211,938,580 bytes, snappy ratio ~2.07:1) cannot
be downloaded in this zero-egress environment, so the harness
synthesizes a corpus with the same compressibility mix: natural-ish
text (dickens/webster analogs), structured binary records (osdb/sao),
source-code-like data (samba), highly-compressible markup (xml/nci),
and incompressible image-like noise (x-ray/sao tails).  Generation is
seeded and order-stable, so numbers are comparable across runs and
machines.  If a real corpus directory is provided (--corpus), it is
used instead.
"""

from __future__ import annotations

import hashlib
import numpy as np

_WORDS = (
    b"the of and to in that it was his he for as had with you not be her "
    b"is at on by which have or from this him but all she they were my are "
    b"me one their so an said them we who would been will no when there if "
    b"more out up into do any your what has man could other than our time"
).split()


def _text_like(n: int, rng: np.random.Generator) -> bytes:
    """Zipf-ish word soup with punctuation and paragraph structure."""
    ranks = rng.zipf(1.3, size=n // 4)
    out = bytearray()
    col = 0
    while len(out) < n:
        w = _WORDS[int(ranks[len(out) % len(ranks)]) % len(_WORDS)]
        out += w
        col += len(w) + 1
        if col > 68:
            out += b".\n"
            col = 0
        else:
            out += b" "
    return bytes(out[:n])


def _records_like(n: int, rng: np.random.Generator) -> bytes:
    """Fixed-layout binary records with correlated fields (osdb/sao)."""
    rec = 32
    cnt = n // rec + 1
    ids = np.arange(cnt, dtype="<u4")
    ts = (1_700_000_000 + np.cumsum(rng.integers(0, 5, cnt))).astype("<u8")
    vals = (rng.normal(1000, 3, cnt)).astype("<f4")
    flags = rng.integers(0, 4, cnt).astype("<u2")
    pad = np.zeros(cnt, dtype="<u8")
    noise = rng.integers(0, 255, cnt).astype("u1")
    arr = np.zeros(cnt, dtype=[("id", "<u4"), ("ts", "<u8"), ("v", "<f4"),
                               ("f", "<u2"), ("p", "<u8"), ("n", "u1"),
                               ("x", "S5")])
    arr["id"], arr["ts"], arr["v"], arr["f"], arr["p"], arr["n"] = (
        ids, ts, vals, flags, pad, noise)
    return arr.tobytes()[:n]


def _xml_like(n: int, rng: np.random.Generator) -> bytes:
    out = bytearray(b"<?xml version=\"1.0\"?>\n<dataset>\n")
    i = 0
    while len(out) < n:
        out += (
            b'  <row id="%d"><name>item-%d</name><value>%d</value>'
            b"<status>active</status></row>\n" % (i, i % 997, int(rng.integers(0, 10000)))
        )
        i += 1
    out += b"</dataset>\n"
    return bytes(out[:n])


def _source_like(n: int, rng: np.random.Generator) -> bytes:
    """samba/mozilla analog: code-like with mixed-in unique identifiers
    and hex constants so the ratio lands near real source tarballs (~3x)."""
    out = bytearray()
    i = 0
    while len(out) < n:
        name = bytes(rng.integers(97, 122, rng.integers(4, 12), dtype=np.uint8))
        h1 = int(rng.integers(0, 1 << 32))
        h2 = int(rng.integers(0, 1 << 16))
        out += (
            b"static int %s_%d(struct ctx *c, const char *buf, size_t n)\n"
            b"{\n    uint32_t magic = 0x%08x;\n"
            b"    if (c == NULL || n < %d)\n        return -EINVAL;\n"
            b"    return process(c, buf, n ^ magic, %d);\n}\n\n"
            % (name, i, h1, h2 % 128, h2)
        )
        i += 1
    return bytes(out[:n])


def _noise_like(n: int, rng: np.random.Generator) -> bytes:
    """x-ray analog: high-entropy with mild local correlation."""
    base = rng.integers(0, 255, n, dtype=np.uint8)
    smooth = np.convolve(base.astype(np.float32), np.ones(3) / 3, mode="same")
    return (smooth.astype(np.uint8) ^ (base >> 3)).tobytes()[:n]


_PROFILE = (
    ("dickens", _text_like, 0.14),
    ("webster", _text_like, 0.19),
    ("xml", _xml_like, 0.08),
    ("nci", _xml_like, 0.10),
    ("samba", _source_like, 0.10),
    ("osdb", _records_like, 0.12),
    ("sao", _records_like, 0.07),
    ("xray", _noise_like, 0.10),
    ("mozilla", _source_like, 0.05),
    ("mr", _noise_like, 0.05),
)


def make_enwik_like(n: int, seed: int = 31337) -> bytes:
    """enwik9 analog: wiki-markup XML with zipf-y natural text (the
    multi-chip scaling config's corpus, BASELINE config 4)."""
    rng = np.random.default_rng(seed)
    out = bytearray(b"<mediawiki xmlns=\"http://www.mediawiki.org/xml/export-0.3/\">\n")
    i = 0
    while len(out) < n:
        title = b"Article_%d" % i
        body = _text_like(min(2000, n), rng)
        out += (
            b"<page>\n  <title>%s</title>\n  <id>%d</id>\n  <revision>\n"
            b"    <timestamp>2006-03-%02dT%02d:00:00Z</timestamp>\n"
            b"    <text xml:space=\"preserve\">%s [[Category:%d]]</text>\n"
            b"  </revision>\n</page>\n"
            % (title, i, (i % 28) + 1, i % 24, body, i % 97)
        )
        i += 1
    return bytes(out[:n])


def make_corpus(total_size: int, seed: int = 20260816) -> list[tuple[str, bytes]]:
    """Generate the synthetic corpus files summing to ~total_size."""
    out = []
    for name, gen, frac in _PROFILE:
        n = int(total_size * frac)
        if n == 0:
            continue
        rng = np.random.default_rng(
            int.from_bytes(hashlib.sha256(f"{seed}/{name}".encode()).digest()[:8], "big")
        )
        out.append((name, gen(n, rng)))
    return out
