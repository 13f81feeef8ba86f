"""Batched CRC-32C of chunk rows: the CUDA kernel and its plain version.

Counterpart of ``snappy_tpu/kernels/crc32c_jnp.py``.  ``crc32c_chunks``
gives the CRC-32C of each row of a uint8 ``[B, W]`` tensor (``W <=
65536``) over its first ``lengths[b]`` bytes, as int64 values in
``[0, 2**32)``.  Rows may be a strided view: the row pitch is the
tensor's ``stride(0)``, so the 64 KiB image of a 520-row staging panel
is checksummed in place (``panel[:, :65536]``).

On a CUDA tensor the wrapper launches ``csrc/crc32c.cu`` (a cluster of
two CTAs per row; each row the start of a virtual 64 KiB row, a table
CRC per 128-byte segment run as interleaved chains, each segment moved
to the virtual row's end by a GF(2) product, combined by xor, then per
row the zero suffix taken back and the init term folded in); on a CPU
tensor it runs the plain version, a transcription into torch of the JAX
package's GF(2) matrix form.  There is no other switch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snappy_tpu_torch.spec.crc32c import _TABLE, crc32c as crc_oracle, crc_shift_matrix

SEG = 256  # segment length in bytes (the plain version's GF(2) form)
NSEG = 256  # segments per 64 KiB chunk
CHUNK = SEG * NSEG

# kernel launches made by crc32c_chunks (one per CUDA call)
launches = 0


@functools.lru_cache(maxsize=None)
def _constants():
    """(B_seg[2048, 32], P_comb[NSEG*32, 32], const, minv[17, 32, 32],
    zero_crc[CHUNK+1]) of the GF(2) matrix form, rebuilt from
    spec.crc32c exactly as snappy_tpu's crc32c_jnp._constants does."""
    z = crc_oracle(b"\x00" * SEG)
    seg_m = np.zeros((SEG * 8, 32), dtype=np.uint8)
    for i in range(SEG):
        for b in range(8):
            msg = bytearray(SEG)
            msg[i] = 1 << b
            v = crc_oracle(bytes(msg)) ^ z
            for out_bit in range(32):
                seg_m[i * 8 + b, out_bit] = (v >> out_bit) & 1

    comb = np.zeros((NSEG * 32, 32), dtype=np.uint8)
    const = 0
    zb = np.array([(z >> i) & 1 for i in range(32)], dtype=np.uint8)
    for s in range(NSEG):
        m = crc_shift_matrix(8 * SEG * (NSEG - 1 - s))
        comb[s * 32 : (s + 1) * 32, :] = m.T
        vb = (m @ zb) % 2
        const ^= int(sum(int(x) << i for i, x in enumerate(vb)))

    minv = np.zeros((17, 32, 32), dtype=np.uint8)
    for j in range(17):
        m = crc_shift_matrix(8 * (1 << j))
        a = np.concatenate([m.astype(np.uint8), np.eye(32, dtype=np.uint8)],
                           axis=1)
        for col in range(32):  # GF(2) Gauss-Jordan inverse
            piv = col + np.argmax(a[col:, col])
            a[[col, piv]] = a[[piv, col]]
            for r in range(32):
                if r != col and a[r, col]:
                    a[r] ^= a[col]
        minv[j] = a[:, 32:]

    return seg_m, comb, const, minv, _zero_crc_np()


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map of uint32 words, given by ``cols`` (uint32 [32],
    the image of bit i at i), applied to each word of ``v``: four lookups
    in 256-entry byte tables."""
    byte = np.arange(256, dtype=np.uint32)
    out = np.zeros_like(v)
    for p in range(4):
        tab = np.zeros(256, dtype=np.uint32)
        for b in range(8):
            tab ^= np.where((byte >> np.uint32(b)) & 1, cols[8 * p + b],
                            np.uint32(0)).astype(np.uint32)
        out ^= tab[(v >> np.uint32(8 * p)) & np.uint32(0xFF)]
    return out


def _orbit(cols: np.ndarray, v0: int, n: int) -> np.ndarray:
    """uint32 [n + 1]: ``v0`` taken k times through the linear map
    ``cols``, at index k.  Doubling: with the first m words known and the
    map raised to the m-th power, one vectorised application gives the
    next m, and the map applied to its own columns squares it."""
    out = np.array([v0], dtype=np.uint32)
    while len(out) < n + 1:
        out = np.concatenate([out, _apply(cols, out)])
        cols = _apply(cols, cols)
    return out[: n + 1]


_BITS = np.uint32(1) << np.arange(32, dtype=np.uint32)
# one zero byte through the reflected CRC register, and its inverse (a
# table entry's top byte names its index)
_ZERO_BYTE = _TABLE[_BITS & np.uint32(0xFF)] ^ (_BITS >> np.uint32(8))
_TOP_INDEX = np.zeros(256, dtype=np.uint32)
_TOP_INDEX[_TABLE >> np.uint32(24)] = np.arange(256, dtype=np.uint32)
_ZERO_BYTE_INV = (((_BITS ^ _TABLE[_TOP_INDEX[_BITS >> np.uint32(24)]])
                   << np.uint32(8)) | _TOP_INDEX[_BITS >> np.uint32(24)])


@functools.lru_cache(maxsize=None)
def _zero_crc_np() -> np.ndarray:
    """uint32 [CHUNK + 1]: the CRC-32C of n zero bytes at index n."""
    return _orbit(_ZERO_BYTE, 0xFFFFFFFF, CHUNK) ^ np.uint32(0xFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _kernel_constants_np() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(zshift, unshift, zero_crc), uint32 [CHUNK + 1] each, in the
    reflected form (bit 31 is x^0): zshift[n] is x^(8 (CHUNK - n)) mod P,
    x^0 advanced through the CHUNK - n zero bytes that follow byte n - 1
    of a virtual 64 KiB row (a zero byte is a product by x^8);
    unshift[n] is its inverse, x^0 taken back through those bytes;
    zero_crc[n] is the CRC-32C of n zero bytes."""
    zshift = _orbit(_ZERO_BYTE, 1 << 31, CHUNK)[::-1].copy()
    unshift = _orbit(_ZERO_BYTE_INV, 1 << 31, CHUNK)[::-1].copy()
    return zshift, unshift, _zero_crc_np()


_dev_consts: dict = {}


def _kernel_constants(device: torch.device):
    if device not in _dev_consts:
        _dev_consts[device] = tuple(
            torch.from_numpy(a.view(np.int32).copy()).to(device)
            for a in _kernel_constants_np())
    return _dev_consts[device]


def crc32c_chunks_plain(rows: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch version: GF(2) matmuls in float32 (every sum is at
    most 8192 of 0/1 products, so float32 is exact)."""
    seg_np, comb_np, const, minv_np, zero_np = _constants()
    dev = rows.device
    nb, width = rows.shape
    lengths = lengths.to(device=dev, dtype=torch.int64).clamp(0, width)
    pos = torch.arange(width, device=dev)
    data = torch.where(pos[None, :] < lengths[:, None], rows,
                       torch.zeros((), dtype=torch.uint8, device=dev))
    if width < CHUNK:
        data = torch.nn.functional.pad(data, (0, CHUNK - width))

    d32 = data.to(torch.int32).reshape(nb, NSEG, SEG)
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    bits = ((d32[..., None] >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(nb, NSEG, SEG * 8)
    seg_m = torch.from_numpy(seg_np).to(device=dev, dtype=torch.float32)
    seg = torch.matmul(bits, seg_m).to(torch.int32) & 1  # [B, NSEG, 32]
    comb = torch.from_numpy(comb_np).to(device=dev, dtype=torch.float32)
    crc_bits = torch.matmul(seg.reshape(nb, NSEG * 32).to(torch.float32),
                            comb).to(torch.int32) & 1
    const_bits = torch.tensor([(const >> i) & 1 for i in range(32)],
                              dtype=torch.int32, device=dev)
    crc_bits = crc_bits ^ const_bits[None, :]

    # remove the k = CHUNK - length zero-suffix bytes
    k = CHUNK - lengths
    zero_crc = torch.from_numpy(zero_np.astype(np.int64)).to(dev)
    zc = zero_crc[k.clamp(0, CHUNK)]
    bit_idx = torch.arange(32, dtype=torch.int64, device=dev)
    c = crc_bits ^ ((zc[:, None] >> bit_idx[None, :]) & 1).to(torch.int32)
    minv = torch.from_numpy(minv_np).to(device=dev, dtype=torch.float32)
    for j in range(17):
        apply = ((k >> j) & 1) == 1
        nxt = torch.matmul(c.to(torch.float32), minv[j].T).to(torch.int32) & 1
        c = torch.where(apply[:, None], nxt, c)
    return (c.to(torch.int64) << bit_idx[None, :]).sum(dim=1)


def crc32c_chunks(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-32C of each row of uint8 ``rows [B, W]`` over its first
    ``lengths[b]`` bytes; returns int64 ``[B]``.  CUDA tensors run the
    kernel, CPU tensors the plain version."""
    global launches
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be uint8 [B, W], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    nb, width = rows.shape
    if width > CHUNK:
        raise ValueError(f"row width {width} exceeds {CHUNK}")
    if lengths.shape != (nb,):
        raise ValueError(f"lengths must be [{nb}], got {tuple(lengths.shape)}")
    if rows.device.type == "cpu":
        return crc32c_chunks_plain(rows, lengths)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    from snappy_tpu_torch.kernels import _build

    dev = rows.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return crc32c_chunks(rows, lengths)
    if nb and rows.stride(1) != 1:
        raise ValueError("rows must be contiguous along the row")
    if (lengths.dtype != torch.int32 or lengths.device != dev
            or not lengths.is_contiguous()):
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    if nb == 0:
        return out
    zshift, unshift, zero_crc = _kernel_constants(dev)
    rc = _build.lib().snc_crc32c_rows(
        rows.data_ptr(), rows.stride(0), width, lengths.data_ptr(),
        zshift.data_ptr(), unshift.data_ptr(), zero_crc.data_ptr(),
        out.data_ptr(), nb, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "crc32c_rows")
    launches += 1
    return out
