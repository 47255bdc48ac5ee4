"""PyTorch/CUDA port of rgcn_tpu for NVIDIA Hopper (H100, sm_90a).

The JAX package ``rgcn_tpu`` is the reference; this package imports nothing
of it and no JAX. Modules keep the reference's names so a reader can find
each counterpart:

```
config.py           NC and LP experiment configs over a YAML-subset reader
data/               NC and LP data containers, synthetic graphs
graph/              EdgeSet builders (numpy) with .to(device), merged frames,
                    the LP training subgraphs (dynamic.py)
ops/aggregate.py    K1  destination aggregation over a DstLayout (autograd Function)
ops/fused.py        K2  fused relation-quantum SpMM over a FusedLayout
ops/rel_spmm.py     K3  per-tile messages, the K2-or-K3+K1 dispatch, its backward
ops/basis.py        K4, K5  the aggregation-first basis path
ops/spmm.py         plain index_add_ oracle paths (dense, block, featureless)
ops/distmult_train.py  the structured DistMult training scorer (K4 + K1 backward)
kernels/            CUDA C++ sources, nvcc build, ctypes bindings
nn/, models/        RGCNConv (dense, basis, block), NodeClassifier, LinkPredictor
serve.py            NC and LP servers, load_nc_server, load_lp_server
serve_nodes.py      python -m rgcn_tpu_torch.serve_nodes
serve_links.py      python -m rgcn_tpu_torch.serve_links (lp-WN18, lp-FB-toy)
train/, utils/      make_optimizer, metrics, samplers, negatives, the NC and LP
                    trainers; ScalarLogger
classify_nodes.py   python -m rgcn_tpu_torch.classify_nodes (trains the NC configs)
predict_links.py    python -m rgcn_tpu_torch.predict_links (trains lp-WN18, lp-FB-toy)
```

Entry points run on the card unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper takes its plain PyTorch version.
"""

from rgcn_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
