"""Parallelism layer of the PyTorch port: so far the embedding tables in
their single-device form (``embedding``, ``embedding_config``); meshes,
collectives, pipelines and ring attention come with the parallelism slice."""
