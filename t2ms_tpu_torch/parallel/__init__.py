"""The parallel layer on torch.distributed (counterpart of
t2ms_tpu/parallel/): the (data, model) mesh and batch placement, the
differentiable collectives, ring attention, the GPipe pipeline and the
tensor-parallel DiT. JAX's ``parallel/compat.py`` has no counterpart: it
shims two ``shard_map`` spellings across JAX versions, and PyTorch has one
API."""

from t2ms_tpu_torch.parallel.mesh import (data_sharding,
                                          host_local_batch_size, make_mesh,
                                          replicated, shard_batch)
from t2ms_tpu_torch.parallel.pp import pipeline_apply

__all__ = [
    "data_sharding",
    "host_local_batch_size",
    "make_mesh",
    "pipeline_apply",
    "replicated",
    "shard_batch",
]
