"""Flat-plan encode emission: the host matcher's element replayed on
the device by the shared flat executor (``decode_flat``).

Counterpart of ``snappy_tpu/kernels/encode_flat.py``.  The native
stager (``sn_stage_flat_enc_batch``) runs the matcher and derives a
dependency-free piece plan from the emitted element: literal bytes
gather straight from the input block, tag and short-literal bytes from
a tag buffer.  The device emits the element byte for byte, so the
compressed size is the host encoder's by construction.

B-buffer row layout (uint8 rows of 128):
  row 0          zero pad
  rows 1..512    the input block (64 KiB span, zero padded)
  rows 513..1024 tag buffer (TAG_ROWS rows)
  last rows      guard + rounding to 8 rows
"""

from __future__ import annotations

import numpy as np
import torch

from snappy_tpu_torch.kernels.decode_flat import (
    VEC,
    decode_blocks_flat,
    decode_blocks_flat_plain,
    execute_flat_np,
)

SRC_SPAN = 65536           # input block span in B (bytes)
TAG_ROWS = 512             # tag buffer rows (64 KiB)
ENC_TRIP_CAP = 24          # trips per block (host emission past this)
# pad row + input span + tag rows + guard, rounded to 8 rows
RB_ENC = ((1 + SRC_SPAN // VEC + TAG_ROWS + 1) + 7) & ~7
# output panel: the worst-case compressed length of a 64 KiB block
# (76,475 B) fits in 5 full 128-row bins
OUT_ROWS_ENC = 640
ENC_DST_MAX = OUT_ROWS_ENC * VEC


def replay_enc_np(meta: np.ndarray, starts: np.ndarray, n_trips: int,
                  b_bytes: np.ndarray, comp_len: int) -> np.ndarray:
    """Numpy contract: the packed encode plan replayed by the shared
    flat executor reproduces the host encoder's element exactly."""
    return execute_flat_np(meta, starts, n_trips, b_bytes, comp_len,
                           out_rows=OUT_ROWS_ENC)


def encode_blocks_flat_plain(b_u8, meta, starts, ntrips) -> torch.Tensor:
    """Plain torch counterpart of ``replay_enc_np`` over a batch."""
    return decode_blocks_flat_plain(b_u8, meta, starts, ntrips,
                                    dst_max=ENC_DST_MAX,
                                    out_rows=OUT_ROWS_ENC)


def encode_blocks_flat(b_u8, meta, starts, ntrips) -> torch.Tensor:
    """Emit packed encode plans through the flat executor.

    b_u8: uint8 ``[B, RB_ENC*128]``; meta: int32 ``[B, 8*ENC_TRIP_CAP,
    128]``; starts: int32 ``[B, 8, 128]``; ntrips: int32 ``[B]``.
    Returns uint8 ``[B, OUT_ROWS_ENC*128]`` elements (callers slice to
    the lengths the host planner reported)."""
    return decode_blocks_flat(b_u8, meta, starts, ntrips,
                              dst_max=ENC_DST_MAX, out_rows=OUT_ROWS_ENC)
