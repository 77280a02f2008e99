"""Training runtime of the PyTorch port: state, step, loop, metrics."""

from distributed_tensorflow_tpu_torch.training.loop import Hook, LoggingHook, NanHook, TrainLoop
from distributed_tensorflow_tpu_torch.training.step import make_eval_step, make_train_step
from distributed_tensorflow_tpu_torch.training.train_state import (
    BF16,
    FP32,
    Precision,
    TrainState,
    sgd_nesterov,
)
