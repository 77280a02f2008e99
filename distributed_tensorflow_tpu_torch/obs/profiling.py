"""Profiling: ``torch.profiler`` in the shape of tf.profiler.experimental.

Port of ``distributed_tensorflow_tpu/obs/profiling.py``'s ``Profile``: a
context manager around a trace window (tf.profiler.experimental.Profile,
profiler_v2.py:184 equivalent) that writes the window's Chrome trace
(host ops and, on a GPU, its CUDA kernels) into ``log_dir`` as
``<host>_<pid>.<time>.pt.trace.json``, the layout TensorBoard's PyTorch
profiler plugin reads.  ``training.loop.ProfilerHook`` covers the scripted
step-window case.  The reference's ``start_profiler_server`` (an
on-demand remote-capture endpoint of ``jax.profiler``) has no torch
counterpart and is not carried.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


class Profile:
    """``with Profile(logdir):`` traces the enclosed steps into ``logdir``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities,
                             on_trace_ready=tensorboard_trace_handler(self.log_dir))
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        prof, self._prof = self._prof, None
        prof.__exit__(exc_type, exc, tb)
        return False
