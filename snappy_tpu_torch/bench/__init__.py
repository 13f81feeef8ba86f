"""The benchmark corpus (a copy of ``snappy_tpu/bench/corpus.py``)."""
