"""L0: pure-Python format spec + oracle codec (SURVEY.md §7.1).

Everything here is jax-free and deliberately simple: it is the ground
truth that the device kernels and the C++ native codec are validated
against.
"""

from snappy_tpu_torch.spec import format as format  # noqa: PLC0414
from snappy_tpu_torch.spec.crc32c import crc32c, crc_combine
from snappy_tpu_torch.spec.format import mask_crc, max_encoded_len, unmask_crc
from snappy_tpu_torch.spec.framing import compress_framed, decompress_framed
from snappy_tpu_torch.spec.reference import compress, decode_block, decompress, encode_block

__all__ = [
    "compress",
    "decompress",
    "encode_block",
    "decode_block",
    "compress_framed",
    "decompress_framed",
    "crc32c",
    "crc_combine",
    "mask_crc",
    "unmask_crc",
    "max_encoded_len",
    "format",
]
