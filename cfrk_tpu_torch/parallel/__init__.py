"""Scale-out across processes: the counterpart of ``cfrk_tpu/parallel``.

Only the multi-process half is here so far (:mod:`.distributed`): a
``torch.distributed`` group started from the JAX package's coordinator
variables, and one input split by record-aligned byte ranges across its
processes.  The device mesh of the JAX package (``mesh``, ``sharded``,
``bucket``, ``seqpar``) is not ported yet.
"""

from .distributed import host_shard, maybe_initialize_distributed

__all__ = ["host_shard", "maybe_initialize_distributed"]
