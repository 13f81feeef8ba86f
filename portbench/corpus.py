"""A stand-in for the Silesia corpus, made from a seed in bulk NumPy
operations.

Silesia (Deorowicz) is twelve files of twelve kinds of data.  Each kind
has a generator here, written to frame with the reference encoder at
about the ratio Snappy reaches on that file (``RATIO``): English text
(dickens), a dictionary in markup (webster), Polish text in a PDF's text
operators (reymont), executables (mozilla, ooffice), C source (samba),
XML (xml), chemical structures as SD records (nci), database rows
(osdb), a star catalogue (sao), and two 16-bit medical images, an MRI
scan on a black background (mr) and an X-ray (x-ray).  The bytes are
not the corpus's; what is kept is each file's kind, its size and its
compressibility.  Nothing here imports the port.

A traffic mix names its pool's objects by kind and size
(``make_pool``); ``SILESIA`` holds the published size of each file.
Each object is made in segments of ``SEGMENT`` bytes, each from a seed
of its own, so that a pool is made on several threads and comes out the
same on any number of them.
"""

from __future__ import annotations

import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# The published size in bytes of each file of the Silesia corpus
# (sun.aei.polsl.pl/~sdeor/index.php?page=silesia): 211,938,580 in all.
SILESIA = {
    "dickens": 10_192_446, "mozilla": 51_220_480, "mr": 9_970_564,
    "nci": 33_553_445, "ooffice": 6_152_192, "osdb": 10_085_684,
    "reymont": 6_627_202, "samba": 21_606_400, "sao": 7_251_944,
    "webster": 41_458_703, "xml": 5_345_280, "x-ray": 8_474_240,
}

# The framed ratio (stream bytes over input bytes, reference encoder)
# that each generator is built to give, and the band it is held to: the
# ratios Snappy is reported to reach on the real files, rounded, since
# the files themselves cannot be read here.  Snappy saves under 12.5% on
# sao and x-ray, so the framing stores their chunks uncompressed.
RATIO = {
    "dickens": (0.62, 0.04), "mozilla": (0.52, 0.04), "mr": (0.53, 0.04),
    "nci": (0.17, 0.03), "ooffice": (0.70, 0.04), "osdb": (0.54, 0.04),
    "reymont": (0.48, 0.04), "samba": (0.28, 0.04), "sao": (1.00, 0.03),
    "webster": (0.49, 0.04), "xml": (0.23, 0.04), "x-ray": (1.00, 0.03),
}

SEGMENT = 1 << 23


def _rng(*parts) -> np.random.Generator:
    key = "/".join(str(p) for p in parts).encode()
    return np.random.default_rng(
        int.from_bytes(hashlib.sha256(key).digest()[:8], "big"))


def _decimal(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Non-negative integers as ASCII decimal: a [N, W] matrix, lengths."""
    vals = vals.astype(np.int64)
    lens = np.ones(vals.size, np.int64)
    p = 10
    while True:
        more = vals >= p
        if not more.any():
            break
        lens += more
        p *= 10
    width = int(lens.max()) if vals.size else 1
    exps = lens[:, None] - 1 - np.arange(width)[None, :]
    digits = (vals[:, None] // 10 ** np.maximum(exps, 0)) % 10
    return (digits + 48).astype(np.uint8), lens


def _lut(strings: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """A table of byte strings as a [K, W] matrix and their lengths: a
    field of ``_assemble`` is ``(mat[ids], lens[ids])``."""
    lens = np.array([len(s) for s in strings], np.int64)
    mat = np.zeros((len(strings), max(1, int(lens.max()))), np.uint8)
    for i, s in enumerate(strings):
        mat[i, : len(s)] = np.frombuffer(s, np.uint8)
    return mat, lens


def _pick(table: tuple[np.ndarray, np.ndarray], ids: np.ndarray):
    return table[0][ids], table[1][ids]


def _assemble(n_rows: int, fields) -> np.ndarray:
    """Rows of concatenated fields: each field is a constant ``bytes`` or
    a ``(matrix [N, W], lengths [N])`` pair of per-row values."""
    lens = [np.full(n_rows, len(f), np.int64) if isinstance(f, bytes)
            else f[1] for f in fields]
    row_len = np.sum(lens, axis=0)
    pos = np.cumsum(row_len) - row_len
    out = np.empty(int(row_len.sum()), np.uint8)
    for f, ln in zip(fields, lens):
        if isinstance(f, bytes):
            if f:
                out[pos[:, None] + np.arange(len(f))] = np.frombuffer(
                    f, np.uint8)
        else:
            mat, _ = f
            cols = np.arange(mat.shape[1])
            keep = cols[None, :] < ln[:, None]
            out[(pos[:, None] + cols)[keep]] = mat[keep]
        pos = pos + ln
    return out


def _pieces(n: int, row_bytes: int, piece) -> bytes:
    """Call ``piece(first_row, rows)`` for pieces of rows until n bytes
    are made; ``row_bytes`` is about a row's mean length."""
    rows = min(1 << 18, n // row_bytes + 64)
    parts, have, k = [], 0, 0
    while have < n:
        part = piece(k * rows, rows)
        parts.append(part)
        have += part.size
        k += 1
    return np.concatenate(parts)[:n].tobytes()


def _gather(tokens: list[bytes], ids: np.ndarray, rand_len: np.ndarray | None,
            rng: np.random.Generator) -> np.ndarray:
    """The tokens ``ids`` one after another, each followed by
    ``rand_len[id]`` random bytes (none where ``rand_len`` is None)."""
    mat, lens = _lut_of(tuple(tokens))
    rows = mat[ids]
    keep = np.arange(mat.shape[1])[None, :] < lens[ids][:, None]
    if rand_len is not None:
        extra = rng.integers(0, 256, (ids.size, 4), dtype=np.uint8)
        rows = np.concatenate([rows, extra], axis=1)
        keep = np.concatenate(
            [keep, np.arange(4)[None, :] < rand_len[ids][:, None]], axis=1)
    return rows[keep]


@functools.lru_cache(maxsize=16)
def _lut_of(tokens: tuple[bytes, ...]) -> tuple[np.ndarray, np.ndarray]:
    return _lut(list(tokens))


def _zipf_ids(rng: np.random.Generator, a: float, k: int, rows: int) -> np.ndarray:
    """``rows`` ranks below ``k``, drawn by Zipf's law of exponent ``a``
    (its inverse CDF in 2**20 steps, looked up)."""
    return _zipf_table(a, k)[rng.integers(0, 1 << 20, rows)]


@functools.lru_cache(maxsize=None)
def _zipf_table(a: float, k: int) -> np.ndarray:
    p = np.arange(1, k + 1, dtype=np.float64) ** -a
    cdf = np.cumsum(p / p.sum())
    u = (np.arange(1 << 20) + 0.5) / (1 << 20)
    return np.minimum(np.searchsorted(cdf, u), k - 1).astype(np.int32)


# English letters by their frequency in running text, and the letters
# of Polish (ISO 8859-2 for the diacritics) by theirs
_EN = (b"etaoinshrdlcumwfgypbvkjxqz",
       [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
        2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.2, 0.1, 0.1])
_PL = (b"aioezncrwsytkdpmuj\xb3lgbh\xea\xb1\xbf\xf3\xe6\xb6\xf1f\xbc",
       [8.9, 8.2, 7.8, 7.7, 5.6, 5.5, 4.0, 4.7, 4.7, 4.3, 3.8, 4.0, 3.5,
        3.3, 3.1, 2.8, 2.5, 2.3, 1.8, 2.1, 1.4, 1.5, 1.1, 1.1, 1.0, 0.8,
        0.8, 0.4, 0.7, 0.2, 0.3, 0.1])


@functools.lru_cache(maxsize=None)
def _words(letters: str, count: int) -> tuple[bytes, ...]:
    """``count`` distinct made-up words of a language's letters, the
    frequent ones short; the same for every seed, as a language is."""
    alphabet, weight = _LETTERS[letters]
    rng = np.random.default_rng(len(alphabet) * 1000 + count)
    p = np.array(weight) / np.sum(weight)
    out, seen = [], set()
    while len(out) < count:
        k = 2 * (count - len(out))
        lens = np.clip(rng.poisson(3 + 4 * np.arange(len(out), len(out) + k) / count),
                       1, 12)
        chars = rng.choice(np.frombuffer(alphabet, np.uint8), int(lens.sum()), p=p)
        for w in np.split(chars, np.cumsum(lens)[:-1]):
            w = w.tobytes()
            if w not in seen and len(out) < count:
                seen.add(w)
                out.append(w)
    return tuple(out)


_LETTERS = {"en": _EN, "pl": _PL}
_SEPS = [b" ", b", ", b". ", b"; "]
_SEP_CDF = np.cumsum([0.84, 0.09, 0.05, 0.02])


def _text(n: int, rng: np.random.Generator, letters: str, vocab: int,
          a: float, marks: list[bytes], line: int, wrap=(b"", b"")) -> bytes:
    """Words drawn by Zipf's law from a made-up vocabulary, each with a
    space or a punctuation mark, a share of ``marks`` (markup) among
    them, and a line break where a line passes ``line`` characters;
    each line between ``wrap``'s two strings."""
    words = _words(letters, vocab)
    head, tail = wrap
    tokens = [w + s for w in words for s in _SEPS] + marks + [tail + b"\n" + head]
    tlen = np.array([len(t) for t in tokens], np.int64)
    mark0, brk = len(words) * len(_SEPS), len(tokens) - 1

    def piece(_first, rows):
        ids = _zipf_ids(rng, a, vocab, rows) * len(_SEPS) + np.minimum(
            np.searchsorted(_SEP_CDF, rng.random(rows)), len(_SEPS) - 1)
        if marks:
            m = rng.random(rows) < 0.05
            ids[m] = mark0 + rng.integers(0, len(marks), int(m.sum()))
        col = np.cumsum(tlen[ids])
        at = np.flatnonzero((col[1:] // line) != (col[:-1] // line)) + 1
        return _gather(tokens, np.insert(ids, at, brk), None, rng)

    return _pieces(n, 6, piece)


def _dickens(n, rng):
    """Novels: English prose in lines of about 70 characters."""
    return _text(n, rng, "en", 8_000, 1.12, [], 70)


_WEBSTER_TAGS = [
    b"<p>", b"</p>", b"<hw>", b"</hw>", b"<def>", b"</def>", b"<pos>n.</pos> ",
    b"<pos>v. t.</pos> ", b"<pos>a.</pos> ", b"<i>", b"</i>", b"<sn>1.</sn> ",
    b"<sn>2.</sn> ", b"<ety>[AS.]</ety> ", b"<ety>[L. ", b"]</ety> ",
    b"<as>as, ", b"</as>", b"<cd>", b"</cd>", b"<col>", b"</col>"]


def _webster(n, rng):
    """A dictionary in markup: headwords, tags and definitions."""
    return _text(n, rng, "en", 3_000, 1.25, _WEBSTER_TAGS, 60)


def _reymont(n, rng):
    """Polish prose set in a PDF's text operators, a line each."""
    return _text(n, rng, "pl", 12_000, 1.1, [], 60,
                 (b"BT /F1 11 Tf 0 -13 Td (", b") Tj ET"))


@functools.lru_cache(maxsize=None)
def _opcodes(ops: int, longest: int, operand: float):
    """A table of ``ops`` instruction sequences of 1 to ``longest``
    bytes, a share ``operand`` of them taking an immediate or address of
    1-4 bytes."""
    rng = np.random.default_rng(ops)
    table = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(1, longest + 1, ops)]
    rand_len = np.where(rng.random(ops) < operand, rng.integers(1, 5, ops), 0)
    return table, rand_len


def _code(n: int, rng: np.random.Generator, ops: int, longest: int,
          a: float, operand: float, strings: float) -> bytes:
    """Machine code: instructions drawn by Zipf's law from a table of
    opcodes, and a share ``strings`` of the bytes in tables of
    NUL-ended symbol names."""
    table, rand_len = _opcodes(ops, longest, operand)
    names = [b"_" + w + b"\x00" for w in _words("en", 2_000)]

    def piece(_first, rows):
        code = _gather(table, _zipf_ids(rng, a, ops, rows), rand_len, rng)
        k = int(code.size * strings / (1 - strings) / 8) + 1
        text = _gather(names, _zipf_ids(rng, 0.9, len(names), k), None, rng)
        return np.concatenate([code, text])

    return _pieces(n, 4, piece)


def _mozilla(n, rng):
    """A tar of a browser's binaries."""
    return _code(n, rng, 3_000, 14, 1.3, 0.4, 0.2)


def _ooffice(n, rng):
    """An office suite's library."""
    return _code(n, rng, 4_000, 8, 1.0, 0.7, 0.1)


def _hexn(vals: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Integers as ``width`` lowercase hex digits."""
    shifts = np.arange(4 * (width - 1), -4, -4, dtype=np.int64)
    nib = (vals.astype(np.int64)[:, None] >> shifts) & 15
    mat = np.where(nib < 10, nib + 48, nib + 87).astype(np.uint8)
    return mat, np.full(vals.size, width, np.int64)


def _samba(n, rng):
    """C source: functions with their own names and hex constants, each
    under a comment."""
    words = _lut([w + b" " for w in _words("en", 3_000)])

    def piece(first, m):
        i = np.arange(first, first + m)
        name = (rng.integers(97, 123, (m, 14), dtype=np.uint8),
                rng.integers(6, 15, m))
        h1 = rng.integers(0, 1 << 32, m)
        h2 = rng.integers(0, 1 << 16, m)
        said = [_pick(words, rng.integers(0, len(words[1]), m)) for _ in range(3)]
        return _assemble(m, [
            b"/* ", *said, b"*/\nstatic int ", name, b"_", _decimal(i),
            b"(struct ctx *c, const char *buf, size_t n)\n{\n"
            b"    uint32_t magic = 0x", _hexn(h1, 8),
            b";\n    if (c == NULL || n < ", _decimal(h2 % 128),
            b")\n        return -EINVAL;\n"
            b"    return process(c, buf, n ^ magic, ", _decimal(h2),
            b");\n}\n\n"])

    return _pieces(n, 230, piece)


def _xml(n, rng):
    """XML records with a running id, names and values."""
    head = np.frombuffer(b'<?xml version="1.0"?>\n<dataset>\n', np.uint8)

    def piece(first, rows):
        i = np.arange(first, first + rows)
        out = _assemble(i.size, [
            b'  <row id="', _decimal(i), b'"><name>item-',
            _decimal(rng.integers(0, 100_000, i.size)),
            b"</name><value>", _decimal(rng.integers(0, 10**7, i.size)),
            b"</value><status>active</status></row>\n"])
        return np.concatenate([head, out]) if first == 0 else out

    return _pieces(n, 95, piece)


# a drawing's atom positions lie on a grid of bond lengths
_NCI_X = _lut([b"%10.4f" % (0.866 * i + 0.5 * j) for i in range(-12, 13)
               for j in range(6)])
_NCI_Y = _lut([b"%10.4f" % (0.5 * i + 0.25 * j) for i in range(-10, 11)
               for j in range(2)])
_NCI_EL = _lut([b"C  ", b"C  ", b"C  ", b"C  ", b"O  ", b"N  ", b"C  ",
                b"S  ", b"Cl ", b"O  "])
_NCI_I3 = _lut([b"%3d" % k for k in range(1000)])
_NCI_ATOMS = 20


def _nci(n, rng):
    """Chemical structures as SD records: a header, then each atom's 2D
    position on the drawing's grid and its element, then the bonds."""
    a = _NCI_ATOMS
    atom_tail = b"    0.0000 "
    atom_end = b"  0  0  0  0  0  0  0  0  0  0  0  0\n"

    def piece(first, mols):
        rows = mols * a
        atoms = _assemble(rows, [
            _pick(_NCI_X, rng.integers(0, len(_NCI_X[1]), rows)),
            _pick(_NCI_Y, rng.integers(0, len(_NCI_Y[1]), rows)), atom_tail,
            _pick(_NCI_EL, rng.integers(0, len(_NCI_EL[1]), rows)), atom_end])
        a1 = rng.integers(1, a, rows)
        bonds = _assemble(rows, [
            _pick(_NCI_I3, a1), _pick(_NCI_I3, a1 + rng.integers(1, 4, rows)),
            _pick(_NCI_I3, rng.integers(1, 3, rows)), b"  0  0  0  0\n"])
        atoms = atoms.reshape(mols, -1)
        bonds = bonds.reshape(mols, -1)
        full = lambda m: (m, np.full(mols, m.shape[1], np.int64))
        return _assemble(mols, [
            _decimal(np.arange(first, first + mols) + 1),
            b"\n  -OEChem-01010000002D\n\n 20 20  0     0  0  0  0  0  0999 V2000\n",
            full(atoms), full(bonds), b"M  END\n> <NSC>\n", _decimal(
                rng.integers(1, 10**6, mols)), b"\n\n$$$$\n"])

    return _pieces(n, 1500, piece)


def _osdb(n, rng):
    """A database's fixed-layout rows: ids, times, prices, flags and
    short codes."""
    rec = np.dtype([("id", "<u4"), ("ts", "<u8"), ("v", "<f8"), ("q", "<u4"),
                    ("f", "<u2"), ("c", "S10"), ("p", "<u2")])
    cnt = n // rec.itemsize + 1
    arr = np.zeros(cnt, dtype=rec)
    arr["id"] = np.arange(cnt)
    arr["ts"] = 1_700_000_000 + np.cumsum(rng.integers(0, 50, cnt))
    arr["v"] = np.round(rng.normal(1000, 300, cnt), 2)
    arr["q"] = rng.integers(0, 100_000, cnt)
    arr["f"] = rng.integers(0, 4, cnt)
    codes = np.array([b"pending", b"shipped", b"returned", b"cancelled"])
    arr["c"] = codes[rng.integers(0, 4, cnt)]
    return arr.tobytes()[:n]


def _sao(n, rng):
    """A star catalogue: each star's position in doubles, its proper
    motion, magnitude and spectral class."""
    rec = np.dtype([("ra", "<f8"), ("dec", "<f8"), ("pm", "<f4"),
                    ("mag", "<i2"), ("sp", "S2"), ("n", "<u4")])
    cnt = n // rec.itemsize + 1
    arr = np.zeros(cnt, dtype=rec)
    arr["ra"] = (np.sort(rng.random(cnt)) * 2 * np.pi).astype(np.float32)
    arr["dec"] = (rng.random(cnt) - 0.5) * np.pi
    arr["pm"] = rng.normal(0, 0.01, cnt)
    arr["mag"] = rng.normal(900, 150, cnt)
    arr["sp"] = np.array([b"A0", b"B9", b"F5", b"G0", b"K0", b"K5", b"M0"])[
        rng.integers(0, 7, cnt)]
    arr["n"] = np.arange(cnt)
    return arr.tobytes()[:n]


def _image16(n: int, rng: np.random.Generator, fill: float, noise: float,
             side: int = 256) -> bytes:
    """Slices of a 16-bit little-endian scan: a smooth body within an
    ellipse that covers ``fill`` of the slice, Gaussian noise of
    ``noise`` on it, black outside."""
    per = side * side * 2
    k = n // per + 1
    yy, xx = np.mgrid[0:side, 0:side] / side - 0.5
    out = np.empty((k, side, side), np.uint16)
    r = np.sqrt(fill / np.pi)
    for s in range(k):
        cx, cy = rng.normal(0, 0.02, 2)
        inside = ((xx - cx) / r) ** 2 + ((yy - cy) / r) ** 2 < 1
        coarse = rng.random((9, 9)) * 1500 + 300
        body = np.kron(coarse, np.ones((side // 8, side // 8)))[:side, :side]
        body = body + rng.normal(0, noise, (side, side))
        out[s] = np.where(inside if fill < 1 else True, np.clip(body, 0, 4095), 0)
    return out.tobytes()[:n]


def _mr(n, rng):
    """An MRI scan: a body on a black background."""
    return _image16(n, rng, 0.55, 12.0)


def _x_ray(n, rng):
    """An X-ray: 12-bit grey levels over the whole frame."""
    return _image16(n, rng, 1.0, 200.0)


KINDS = {
    "dickens": _dickens, "mozilla": _mozilla, "mr": _mr, "nci": _nci,
    "ooffice": _ooffice, "osdb": _osdb, "reymont": _reymont,
    "samba": _samba, "sao": _sao, "webster": _webster, "xml": _xml,
    "x-ray": _x_ray,
}


def make_kind(kind: str, size: int, seed) -> np.ndarray:
    """``size`` bytes of one kind as uint8, in segments of SEGMENT bytes
    each from its own seed."""
    return np.concatenate([_segment(kind, size, seed, s)
                           for s in range(-(-size // SEGMENT))] or
                          [np.zeros(0, np.uint8)])


def _segment(kind: str, size: int, seed, s: int) -> np.ndarray:
    n = min(SEGMENT, size - s * SEGMENT)
    return np.frombuffer(KINDS[kind](n, _rng(seed, kind, s)), np.uint8)


def pool_objects(traffic: dict) -> list[tuple[str, int]]:
    """The pool's objects in pool order, (kind, bytes) each, as the
    traffic mix lists them."""
    return [(kind, int(size)) for kind, size in traffic["objects"]]


def make_pool(traffic: dict, seed, threads: int = 4) -> list[np.ndarray]:
    """The traffic mix's objects, each of its kind and from its own seed
    (the same bytes whatever ``threads``: NumPy releases the interpreter
    lock, and every segment has its own seed)."""
    objects = pool_objects(traffic)
    jobs = [(j, s) for j, (_, size) in enumerate(objects)
            for s in range(-(-size // SEGMENT))]
    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(lambda js: _segment(
            objects[js[0]][0], objects[js[0]][1], f"{seed}/object{js[0]}", js[1]),
            jobs))
    out = [[] for _ in objects]
    for (j, _), part in zip(jobs, parts):
        out[j].append(part)
    return [np.concatenate(p) if p else np.zeros(0, np.uint8) for p in out]


def call_order(n_objects: int, seed, pass_index: int) -> np.ndarray:
    """The order of one pass of the calls through the pool: a new
    permutation each pass, drawn from the seed, so that no run rests on
    one order."""
    return _rng(seed, "order", pass_index).permutation(n_objects)
