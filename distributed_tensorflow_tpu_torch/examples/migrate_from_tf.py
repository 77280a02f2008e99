"""Migrate a reference (TensorFlow) workload into the port, end to end.

Port of ``examples/migrate_from_tf.py``, step for step.  The two arrival
artifacts a reference user brings are (1) a TF checkpoint (tensor-bundle
``.index``/``.data``) and (2) a ``tf.data`` input pipeline.  This script
runs the whole bridge:

  1. writes a REAL TF1-Saver checkpoint with the MNIST CNN's variable
     names and shapes (the reference's flax paths and layouts, from
     ``convert.variables_to_flax``; standing in for the user's trained
     model — in a real migration this file already exists),
  2. reads it back with ``checkpoint.load_tf_variables`` (pure-python
     tensor-bundle parser — works without tensorflow installed; this demo
     forces it to prove the point),
  3. places the weights into the live module with ``assign_into_tree``,
  4. trains onward feeding batches from a genuine ``tf.data.Dataset``
     through ``data.tf_dataset_data_fn``,
  5. re-runs the same training through the TF2 idiom — ``model.fit(dataset,
     epochs=, callbacks=)`` via ``compat.fit.Model`` — so BOTH reference
     training-loop styles (TF1 MonitoredTrainingSession in
     ``examples.tf1_ps_launcher``, TF2 Keras fit here) have a demonstrated
     port with the loop call intact.

Run (needs tensorflow for steps 1, 4 and 5, as the reference's does)::

    python -m distributed_tensorflow_tpu_torch.examples.migrate_from_tf [--device=cpu]
"""

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    import tensorflow as tf

    from distributed_tensorflow_tpu_torch.checkpoint import assign_into_tree, load_tf_variables
    from distributed_tensorflow_tpu_torch.compat.fit import Model
    from distributed_tensorflow_tpu_torch.convert import variables_to_flax
    from distributed_tensorflow_tpu_torch.data import (
        DevicePrefetchIterator,
        per_host_batch_size,
        tf_dataset_data_fn,
    )
    from distributed_tensorflow_tpu_torch.models import get_workload
    from distributed_tensorflow_tpu_torch.train_lib import build_state_and_step, resolve_device
    from distributed_tensorflow_tpu_torch.training import LoggingHook, TrainLoop

    p = argparse.ArgumentParser(description="migrate a TF checkpoint and tf.data input")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    workload = get_workload("mnist", batch_size=32, device=device)

    # --- 1. the "reference checkpoint": TF variables with the model's
    # names and shapes (your trained Saver checkpoint in a real migration)
    flat = {}

    def _walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                _walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    _walk("", variables_to_flax(workload.module, dict(workload.module.named_parameters()))
          ["params"])
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory(prefix="tf_migrate_") as tmpdir:
        g = tf.Graph()
        with g.as_default():
            for name, val in flat.items():
                tf.compat.v1.get_variable(
                    name, initializer=(rng.randn(*val.shape) * 0.05).astype(np.float32))
            saver = tf.compat.v1.train.Saver()
            with tf.compat.v1.Session(graph=g) as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                prefix = saver.save(sess, os.path.join(tmpdir, "model.ckpt"),
                                    write_meta_graph=False)
        print(f"[1] TF checkpoint written: {prefix}")

        # --- 2+3. read the bundle (no-TF parser) and map into the module
        tf_vars = load_tf_variables(prefix, force_pure_python=True)
    print(f"[2] read {len(tf_vars)} variables via the pure-python tensor-bundle parser")

    # --- 4. train onward from a real tf.data pipeline -------------------
    def input_fn(batch_size):
        images = rng.rand(512, 28, 28, 1).astype(np.float32)
        labels = rng.randint(0, 10, size=512).astype(np.int32)
        return tf.data.Dataset.from_tensor_slices(
            {"image": images, "label": labels}
        ).shuffle(512, seed=0).batch(batch_size, drop_remainder=True)

    workload.data_fn = tf_dataset_data_fn(input_fn)
    state, train_step = build_state_and_step(workload, total_steps=10)
    assign_into_tree(workload.module, tf_vars)
    print("[3] weights placed into the live module")
    data_iter = DevicePrefetchIterator(
        workload.data_fn(per_host_batch_size(workload.batch_size)), device, prefetch=2)
    loop = TrainLoop(train_step, state, data_iter, hooks=[LoggingHook(every_steps=5)],
                     examples_per_step=workload.batch_size, metrics_every=5)
    final = loop.run(10)
    data_iter.close()
    loss = loop.last_logged_metrics.get("loss")
    print(f"[4] custom-loop training done: step={final.step} loss={loss}")

    # --- 5. the TF2 style: the fit call ports intact --------------------
    dataset = input_fn(32)  # the user's dataset, as in their TF2 script
    model = Model("mnist", batch_size=32, device=device)
    model.compile(learning_rate=1e-3)
    history = model.fit(dataset, epochs=2, steps_per_epoch=5)
    fit_loss = history.history["loss"][-1]
    print(f"[5] model.fit ported intact: epochs={history.epoch} loss={fit_loss:.4f}")
    print(f"MIGRATE_FROM_TF_DONE step={final.step} loss={loss}", flush=True)
    return loss


if __name__ == "__main__":
    main()
