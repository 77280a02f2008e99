"""Checkpoints of the PyTorch port: ``manager.CheckpointManager`` over
``torch.distributed.checkpoint``.  The TF-checkpoint reader
(``tf_compat``) comes with the training runtime's part B."""
