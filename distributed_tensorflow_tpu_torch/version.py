"""Version of the PyTorch port.

Copied from ``distributed_tensorflow_tpu/version.py``: the port carries the
reference's version.
"""

__version__ = "0.1.0"
