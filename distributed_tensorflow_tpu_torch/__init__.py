"""distributed_tensorflow_tpu_torch: the PyTorch/CUDA port of
``distributed_tensorflow_tpu`` for NVIDIA Hopper.

It imports ``torch`` and never JAX or the JAX package.  So far it holds the
GPT-2 training path (``train_lib``) on the hand-written flash-attention
kernels (``ops/flash_attention.py``, ``ops/csrc``).  Entry points run on
``cuda`` unless the caller asks for ``cpu``.
"""
