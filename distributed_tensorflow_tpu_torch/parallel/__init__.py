"""Parallelism layer of the PyTorch port: the sharding rules and the
parameters' layouts on a mesh (``sharding``), the named-axis collectives
(``collectives``), FSDP's sharded optimizer (``fsdp``), ring attention
over the context axis (``ring_attention``), GPipe and 1F1B over the pipe
axis (``pipeline``), and the embedding tables row-sharded over a mesh
axis (``embedding``, ``embedding_config``)."""
