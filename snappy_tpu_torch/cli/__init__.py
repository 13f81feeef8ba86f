"""The ``tpusnappy-torch`` command-line tool (``python -m
snappy_tpu_torch``, ``python -m snappy_tpu_torch.cli``); the code is in
``snappy_tpu_torch.cli.main``."""
