"""Multi-process parallelism over torch.distributed (counterpart of the
JAX package's ``parallel/``): the sharded patch DB with its min+argmin and
packed-champion all-reduces, the ring argmin, the mesh level step, the
query-parallel wavefront and frame-sharded video.

JAX runs one controller over a mesh of local devices; PyTorch runs one
process per rank, so the port is SPMD over processes: rank r sits at
(data = r // db_shards, db = r % db_shards), and each mesh axis has its
process groups (``mesh.py``).  Every rank of a ``db`` group runs the whole
scan loop on the full query set against its own DB shard, so every rank
ends a run with the same result; rank 0 alone writes files.

Start a world with ``torchrun`` (``distributed.initialize_distributed``
reads its environment), with the CLI's ``--coordinator/--num-processes/
--process-id``, or in one script with ``launch.spawn_local``.
"""
