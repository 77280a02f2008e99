"""MNIST 2-layer CNN of the PyTorch port.

Port of ``distributed_tensorflow_tpu/models/mnist_cnn.py``: two 3x3 'SAME'
convolutions (32 and 64 channels, stride 1, so the padding is symmetric),
each followed by ReLU and a 2x2 max-pool, then fc1 (128) and float32
logits; log-softmax NLL.  The reference is NHWC; here the image arrives
NHWC and is viewed as NCHW in ``channels_last`` memory, and the flatten
before fc1 is taken in NHWC order so fc1's weight is the flax kernel's.
Conv and fc1 run in ``dtype`` (input, weight and bias cast); the logits
layer runs in float32.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.data.pipeline import synthetic_image_classification
from distributed_tensorflow_tpu_torch.models import Workload
from distributed_tensorflow_tpu_torch.models.layers import dense, lecun_normal_


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.bfloat16, *,
                 device=None, seed: int = 0):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=device)
        self.fc1 = nn.Linear(7 * 7 * 64, 128, device=device)
        self.logits = nn.Linear(128, num_classes, device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """flax's initializers: lecun_normal kernels (fan_in), zero biases."""
        gen = torch.Generator(device=self.conv1.weight.device)
        gen.manual_seed(seed)
        for m in (self.conv1, self.conv2, self.fc1, self.logits):
            lecun_normal_(m.weight, math.prod(m.weight.shape[1:]), gen)
            m.bias.zero_()

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(B, 28, 28, 1) NHWC images -> (B, num_classes) float32 logits."""
        dt = self.dtype
        x = image.to(dt).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        for conv in (self.conv1, self.conv2):
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        x = F.relu(dense(self.fc1, x, dt))
        return dense(self.logits, x, torch.float32)


def _loss_fn(module: MnistCNN, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], seed):
    logits = torch.func.functional_call(module, params, (batch["image"],))
    labels = batch["label"].long()
    loss = F.nll_loss(F.log_softmax(logits, dim=-1), labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": acc}


def make_workload(*, batch_size: int = 256, num_classes: int = 10, device="cuda",
                  **_unused) -> Workload:
    module = MnistCNN(num_classes=num_classes, device=device)
    return Workload(
        name="mnist",
        module=module,
        loss_fn=functools.partial(_loss_fn, module),
        init_batch={"image": np.zeros((2, 28, 28, 1), np.float32),
                    "label": np.zeros((2,), np.int32)},
        data_fn=lambda per_host_bs: synthetic_image_classification(
            batch_size=per_host_bs, image_size=(28, 28, 1), num_classes=num_classes),
        eval_data_fn=lambda per_host_bs: synthetic_image_classification(
            batch_size=per_host_bs, image_size=(28, 28, 1), num_classes=num_classes,
            holdout=True),
        batch_size=batch_size,
        learning_rate=1e-3,
        example_key="image",
    )
