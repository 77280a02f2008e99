"""Hand-written CUDA kernels of the PyTorch port and their plain versions
(``ops/flash_attention.py``; sources in ``ops/csrc``, built by
``ops/_build.py``)."""
