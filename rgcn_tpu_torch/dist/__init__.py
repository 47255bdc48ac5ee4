"""Edge-sharded multi-device training over ``torch.distributed``
(counterpart of ``rgcn_tpu/dist/``): one process per rank, the graph's
edge tiles split over the ranks, parameters replicated, exact against one
device by the manual-AD collectives of :mod:`rgcn_tpu_torch.ops.collectives`.

```
mesh.py        Mesh, make_mesh, shard_edge_set, the per-shard layouts and pairs
multihost.py   initialize_distributed, make_mesh_2d, spawn (ranks on this host)
train.py       the sharded NC and LP steps
host.py        the LP epoch's per-shard host inputs
evaluate.py    candidate-sharded filtered ranking
checkpoint.py  rank 0 writes, every rank restores
driver.py      train_node_classifier_sharded, train_link_predictor_sharded
```

``train.py``'s :func:`make_sharded_lp_step` builds each epoch on the
ranks' devices (the JAX in-jit step); the drivers build on the host.
"""

from rgcn_tpu_torch.dist.mesh import EDGE_AXIS, make_mesh, shard_edge_set
from rgcn_tpu_torch.dist.multihost import initialize_distributed, make_mesh_2d, spawn
from rgcn_tpu_torch.dist.train import (
    make_sharded_lp_step,
    make_sharded_nc_step,
    pad_to_multiple,
)

__all__ = [
    "EDGE_AXIS",
    "initialize_distributed",
    "make_mesh",
    "make_mesh_2d",
    "make_sharded_lp_step",
    "make_sharded_nc_step",
    "pad_to_multiple",
    "shard_edge_set",
    "spawn",
]
