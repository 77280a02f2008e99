"""The reference's example scripts, ported: ``tf1_ps_launcher`` (the TF1
between-graph PS launcher) and ``migrate_from_tf`` (a TF checkpoint and a
tf.data pipeline brought over).  Run them with ``python -m
distributed_tensorflow_tpu_torch.examples.<name>``."""
