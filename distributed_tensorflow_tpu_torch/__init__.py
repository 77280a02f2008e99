"""distributed_tensorflow_tpu_torch: the PyTorch/CUDA port of
``distributed_tensorflow_tpu`` for NVIDIA Hopper.

It imports ``torch`` and never JAX or the JAX package.  So far it holds the
training paths (``train_lib``) of MNIST, ResNet-50, BERT and GPT-2, the
last two on the hand-written flash-attention kernels
(``ops/flash_attention.py``, ``ops/csrc``), and the train-mode bench
(``bench``).  Entry points run on ``cuda`` unless the caller asks for
``cpu``.
"""
