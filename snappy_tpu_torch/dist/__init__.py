"""L3 distribution: sharding of independent 64 KiB blocks over devices
and hosts, on PyTorch.

Counterpart of ``snappy_tpu/dist/``.  Snappy is dictionary-free per
block, so the only parallel axis is data parallelism over blocks: no
state is ever broadcast; the cross-device steps are the per-block
length exclusive-scan and the ordered gather of outputs.

``mesh``       a 1-D mesh of ``torch.device``s and the per-shard codec
               forms (each shard's work on its own device, no collective)
``multihost``  per-process chunk ranges over ``torch.distributed`` (gloo):
               the record-length all-gather is the codec's one collective
"""
