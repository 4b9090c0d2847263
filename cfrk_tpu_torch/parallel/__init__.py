"""Scale-out: the counterpart of ``cfrk_tpu/parallel``.

* :mod:`.mesh`, :mod:`.sharded`, :mod:`.bucket`, :mod:`.seqpar`: one
  process driving a mesh of devices (rows over dp, spectrum bins over
  tp, k-mer keys routed to their owner device, positions over sp), with
  the collectives as tensor copies and sums between devices;
* :mod:`.distributed`: a ``torch.distributed`` group started from the
  JAX package's coordinator variables, one input split by record-aligned
  byte ranges across its processes, or several inputs dealt round-robin.
"""

from .bucket import sparse_spectrum_sharded
from .distributed import host_shard, maybe_initialize_distributed
from .mesh import DP_AXIS, TP_AXIS, batch_sharding, make_mesh, table_sharding
from .seqpar import SP_AXIS, count_perread_seqpar, make_seq_mesh, spectrum_seqpar
from .sharded import (
    count_perread_sharded,
    count_perread_sparse_sharded,
    shard_batch,
    spectrum_sharded,
)

__all__ = [
    "sparse_spectrum_sharded",
    "count_perread_sparse_sharded",
    "host_shard",
    "maybe_initialize_distributed",
    "DP_AXIS",
    "TP_AXIS",
    "SP_AXIS",
    "make_mesh",
    "make_seq_mesh",
    "batch_sharding",
    "table_sharding",
    "shard_batch",
    "count_perread_sharded",
    "spectrum_sharded",
    "count_perread_seqpar",
    "spectrum_seqpar",
]
