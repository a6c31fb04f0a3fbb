"""Data and gene-head parallelism: in-process device meshes and
``torch.distributed`` ranks (counterpart of ``sequoia_tpu/parallel/``)."""

from sequoia_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, shard_batch_arrays, shard_params)
