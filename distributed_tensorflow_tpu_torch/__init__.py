"""distributed_tensorflow_tpu_torch: the PyTorch/CUDA port of
``distributed_tensorflow_tpu`` for NVIDIA Hopper.

It imports ``torch`` and never JAX or the JAX package, and does what the
JAX package does: the five model families (MNIST, ResNet-50, BERT,
Wide&Deep/DLRM, GPT-2), the last two on the hand-written flash-attention
kernels (``ops/flash_attention.py``, ``ops/csrc``); the runtime
(``train_lib``, the record loader, checkpoints, evaluation, fault
tolerance, observability, the TF-compat surface and the data service);
every mesh axis (``data``, ``fsdp``, ``tensor``, ``pipe``, ``expert``);
serving on one rank and on a mesh (``serve``: the engine's CUDA-graph
programs, the continuous scheduler, the fleet, the gateway); the bench
(``bench``); and dttlint (``analysis``), its static analysis.  Entry
points run on ``cuda`` unless the caller asks for ``cpu``.
"""

from distributed_tensorflow_tpu_torch.version import __version__

__all__ = ["__version__"]
