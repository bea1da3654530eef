"""Tooling: the profiling utilities (`profiling.py`), as in `alchemy_tpu/utils/`."""
