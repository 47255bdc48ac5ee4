"""The CLIs' dataset dispatch (counterpart of ``rgcn_tpu/data/dispatch.py``).

Every entry point, training or serving, NC or LP, resolves its dataset
here: the files under ``data_root`` through
:mod:`rgcn_tpu_torch.data.loaders`, or with ``synthetic`` the
scale-matched stand-in the JAX CLIs' ``--synthetic`` picks. One place for
both keeps a serving CLI on exactly the data its training CLI used.
"""

from __future__ import annotations

from typing import Optional

from rgcn_tpu_torch.data.loaders import (
    LinkPredictionData,
    NodeClassificationData,
    load_link_prediction,
    load_node_classification,
)
from rgcn_tpu_torch.data.synthetic import synthetic_lp_data, synthetic_nc_data

__all__ = ["load_lp_data", "load_nc_data"]


def load_lp_data(cfg, synthetic: bool, data_root: Optional[str] = None,
                 verbose: bool = True) -> LinkPredictionData:
    """The link-prediction dataset of ``cfg`` (a LinkPredictionExperiment)."""
    if synthetic:
        data = synthetic_lp_data(cfg.dataset.name)
        if verbose:
            print(f"[synthetic] {cfg.dataset.name}-like graph: N={data.num_nodes} "
                  f"R={data.num_relations} E={len(data.train)}")
        return data
    return load_link_prediction(cfg.dataset.name, final_run=cfg.evaluation.final_run,
                                data_root=data_root)


def load_nc_data(cfg, synthetic: bool, data_root: Optional[str] = None,
                 verbose: bool = True) -> NodeClassificationData:
    """The node-classification dataset of ``cfg`` (a
    NodeClassificationExperiment)."""
    if synthetic:
        data = synthetic_nc_data(cfg.dataset.name)
        if verbose:
            print(f"[synthetic] {cfg.dataset.name}-like graph: N={data.num_nodes} "
                  f"R={data.num_relations} E={len(data.triples)}")
        return data
    return load_node_classification(cfg.dataset.name,
                                    final_run=cfg.evaluation.final_run,
                                    prune=cfg.dataset.prune, data_root=data_root)
