"""Device-mesh parallelism: doc-axis sharding and the replicated step.

Counterpart of ``fluidframework_tpu/parallel``: a ``Mesh`` of
``torch.device``s with ``"replica"`` and ``"docs"`` axes, doc-row
sharding of the four store families (``sharded.py``) and the replicated
apply with cross-replica digest agreement (``replicated.py``).
"""

from .mesh import DOC_AXIS, REPLICA_AXIS, Mesh, make_mesh
from .replicated import (
    ReplicatedState, make_replicated_step, shard_ops, shard_state,
)
from .sharded import make_doc_mesh

__all__ = [
    "DOC_AXIS", "REPLICA_AXIS", "Mesh", "make_mesh", "make_doc_mesh",
    "ReplicatedState", "make_replicated_step", "shard_ops", "shard_state",
]
