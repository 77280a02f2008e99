"""Parallelism layer of the PyTorch port: the sharding rules and the
parameters' layouts on a mesh (``sharding``), the named-axis collectives
(``collectives``), FSDP's sharded optimizer (``fsdp``), ring attention
over the context axis (``ring_attention``), and the embedding tables in
their single-device form (``embedding``, ``embedding_config``); pipelines
and the expert axis come with the parallelism slice, part B."""
