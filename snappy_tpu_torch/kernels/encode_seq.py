"""Sequential per-block Snappy encode: the CUDA kernel and its plain version.

Counterpart of ``snappy_tpu/kernels/pallas_encode.py``.  Row ``b`` of a
uint8 ``blocks [B, bmax]`` holds one block of ``lens[b]`` bytes.
``encode_blocks_seq`` returns ``(comp uint8 [B, cap], clens int32 [B],
err int32 [B])`` with ``cap = comp_width(bmax) >= max_encoded_len(bmax)``:
``comp[b, :clens[b]]`` is the block's element stream (no varint
preamble; the runtime owns framing), byte-identical to
``spec.reference.encode_block`` (an empty block gives no bytes), and the
rest of the row is zero.  ``err[b]`` is ``ERR_LEN`` for a length outside
``[0, min(bmax, 65536)]`` (that row is all zero), else 0.

The emission is the reference greedy hash-table matcher decision for
decision: the table sized per block length and zero-filled (0 means
position 0), the hash ``(u32 * HASH_MUL) >> shift`` in unsigned 32-bit
arithmetic, ``s_limit = n - INPUT_MARGIN``, one literal for blocks under
``MIN_NON_LITERAL_BLOCK_SIZE``, the skip heuristic, the double insert
after each copy, and the reference's copy chopping.

On a CUDA tensor the wrapper launches ``csrc/seq_encode.cu`` (one warp
per block); on a CPU tensor it runs the plain version, a transcription
of the reference onto tensors.  There is no other switch.  Any ``B``
and any width are taken.
"""

from __future__ import annotations

import numpy as np
import torch

from snappy_tpu.spec.format import (
    HASH_MUL,
    INPUT_MARGIN,
    MAX_BLOCK_SIZE,
    MIN_NON_LITERAL_BLOCK_SIZE,
    max_encoded_len,
    table_shift_and_size,
)

ERR_NONE = 0
ERR_LEN = 1  # a block length outside [0, min(bmax, 65536)]

# kernel launches made by encode_blocks_seq (one per CUDA call)
launches = 0


def comp_width(bmax: int) -> int:
    """Width of the element rows for blocks of up to ``bmax`` bytes: the
    worst-case encoded length, rounded up to 16 bytes."""
    return (max_encoded_len(bmax) + 15) & ~15


def stage_encode(blocks, lens, device="cpu"):
    """The port's tensors for a batch staged as numpy arrays (the JAX
    tests' ``blocks/lens``): uint8 ``[B, bmax]`` and int32 ``[B]``."""
    return (torch.from_numpy(np.ascontiguousarray(blocks, np.uint8)).to(device),
            torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(device))


def _check(blocks, lens) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be uint8 [B, bmax], got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    nb = blocks.shape[0]
    if lens.dtype != torch.int32 or tuple(lens.shape) != (nb,):
        raise ValueError(f"lens must be int32 [{nb}], got {lens.dtype} "
                         f"{tuple(lens.shape)}")
    if lens.device != blocks.device:
        raise ValueError(f"lens on {lens.device}, blocks on {blocks.device}")


def _le32(rows: torch.Tensor) -> torch.Tensor:
    """int64 little-endian 4-byte word at every byte position of each
    row (zero past the row's end)."""
    r = torch.nn.functional.pad(rows.to(torch.int64), (0, 3))
    return r[:, :-3] | r[:, 1:-2] << 8 | r[:, 2:-1] << 16 | r[:, 3:] << 24


def _match_len(row: torch.Tensor, a: int, b: int, limit: int) -> int:
    """Length of the common prefix of row[a:] and row[b:], at most limit:
    one vectorised compare per window, windows growing 64, 256, ..."""
    done, width = 0, 64
    while done < limit:
        k = min(width, limit - done)
        ne = row[a + done : a + done + k] != row[b + done : b + done + k]
        first = int(torch.cat((ne, ne.new_ones(1))).to(torch.uint8).argmax())
        if first < k:
            return done + first
        done += k
        width *= 4
    return limit


class _Emitter:
    """Element bytes of one row: literal bodies are slice copies from the
    block, tag bytes are collected and scattered once at the end."""

    def __init__(self, row: torch.Tensor, out: torch.Tensor):
        self.row, self.out = row, out
        self.o = 0
        self.pos: list[int] = []
        self.val: list[int] = []

    def _tag(self, *vals: int) -> None:
        self.pos.extend(range(self.o, self.o + len(vals)))
        self.val.extend(vals)
        self.o += len(vals)

    def literal(self, start: int, ln: int) -> None:
        m = ln - 1
        if m < 60:
            self._tag(m << 2)
        elif m < 256:
            self._tag(60 << 2, m)
        else:  # blocks are <= 64 KiB, so m < 65536
            self._tag(61 << 2, m & 0xFF, m >> 8)
        self.out[self.o : self.o + ln] = self.row[start : start + ln]
        self.o += ln

    def copy(self, offset: int, length: int) -> None:
        lo, hi = offset & 0xFF, (offset >> 8) & 0xFF
        while length >= 68:
            self._tag((63 << 2) | 2, lo, hi)
            length -= 64
        if length > 64:
            self._tag((59 << 2) | 2, lo, hi)
            length -= 60
        if length >= 12 or offset >= 2048:
            self._tag(((length - 1) << 2) | 2, lo, hi)
        else:
            self._tag(((offset >> 8) << 5) | ((length - 4) << 2) | 1, lo)

    def finish(self) -> int:
        if self.pos:
            dev = self.out.device
            self.out[torch.tensor(self.pos, device=dev)] = torch.tensor(
                self.val, dtype=torch.uint8, device=dev)
        return self.o


def _encode_row(row: torch.Tensor, words: torch.Tensor, n: int,
                out: torch.Tensor) -> int:
    """spec.reference.encode_block of row[:n] into out; returns its
    length.  ``words`` holds the row's LE32 words; their hashes are
    computed in one pass, and the control flow reads both as lists."""
    em = _Emitter(row, out)
    if n < MIN_NON_LITERAL_BLOCK_SIZE:
        if n:
            em.literal(0, n)
        return em.finish()
    shift, size = table_shift_and_size(n)
    w = words[:n]
    load32 = w.tolist()
    hashes = (((w * HASH_MUL) & 0xFFFFFFFF) >> shift).tolist()
    table = [0] * size
    s_limit = n - INPUT_MARGIN
    next_emit = 0
    s = 1
    next_hash = hashes[s]
    while True:
        skip = 32
        next_s = s
        while True:
            s = next_s
            bytes_between = skip >> 5
            next_s = s + bytes_between
            skip += bytes_between
            if next_s > s_limit:
                if next_emit < n:
                    em.literal(next_emit, n - next_emit)
                return em.finish()
            candidate = table[next_hash]
            table[next_hash] = s
            next_hash = hashes[next_s]
            if load32[s] == load32[candidate]:
                break
        em.literal(next_emit, s - next_emit)
        while True:
            base = s
            s = base + 4 + _match_len(row, candidate + 4, base + 4,
                                      n - base - 4)
            em.copy(base - candidate, s - base)
            next_emit = s
            if s >= s_limit:
                if next_emit < n:
                    em.literal(next_emit, n - next_emit)
                return em.finish()
            # insert s-1 and probe s, as the reference does after a copy
            table[hashes[s - 1]] = s - 1
            candidate = table[hashes[s]]
            table[hashes[s]] = s
            if load32[s] != load32[candidate]:
                next_hash = hashes[s + 1]
                s += 1
                break


def encode_blocks_seq_plain(blocks, lens):
    """Plain torch version: the reference encoder, row by row."""
    _check(blocks, lens)
    nb, bmax = blocks.shape
    dev = blocks.device
    comp = torch.zeros(nb, comp_width(bmax), dtype=torch.uint8, device=dev)
    clens = [0] * nb
    err = [ERR_NONE] * nb
    words = _le32(blocks)
    for b, n in enumerate(lens.tolist()):
        if not 0 <= n <= min(bmax, MAX_BLOCK_SIZE):
            err[b] = ERR_LEN
            continue
        clens[b] = _encode_row(blocks[b], words[b], n, comp[b])
    return (comp, torch.tensor(clens, dtype=torch.int32, device=dev),
            torch.tensor(err, dtype=torch.int32, device=dev))


def encode_blocks_seq(blocks, lens):
    """Encode a batch of blocks; returns ``(comp uint8 [B, cap], clens
    int32 [B], err int32 [B])``.  CUDA tensors run the kernel, CPU
    tensors the plain version.  ``blocks`` may be a row-strided view
    (its pitch is ``blocks.stride(0)``)."""
    global launches
    _check(blocks, lens)
    if blocks.device.type == "cpu":
        return encode_blocks_seq_plain(blocks, lens)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    from snappy_tpu_torch.kernels import _build

    nb, bmax = blocks.shape
    if nb and bmax and blocks.stride(1) != 1:
        raise ValueError("blocks must be contiguous along the row")
    lens = lens.contiguous()
    cap = comp_width(bmax)
    dev = blocks.device
    comp = torch.empty(nb, cap, dtype=torch.uint8, device=dev)
    clens = torch.empty(nb, dtype=torch.int32, device=dev)
    err = torch.empty(nb, dtype=torch.int32, device=dev)
    if nb == 0:
        return comp, clens, err
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.lib().snc_seq_encode(
            blocks.data_ptr(), blocks.stride(0), bmax, lens.data_ptr(),
            comp.data_ptr(), cap, clens.data_ptr(), err.data_ptr(), nb,
            stream)
    _build.check(rc, "seq_encode")
    launches += 1
    return comp, clens, err
