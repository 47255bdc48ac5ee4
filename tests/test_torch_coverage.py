"""The port's public surface against the JAX package's, read from source.

Every name in the ``__all__`` of every ``rgcn_tpu/**/*.py`` must be one of:

* **same name**: public in the same-path module of ``rgcn_tpu_torch/``
  (in its ``__all__`` or a top-level definition);
* **renamed**: in :data:`RENAMED`, which maps it to
  ``rgcn_tpu_torch/<file>::<name>``, a top-level definition there
  (an autograd Function may be private);
* **not ported**: in :data:`NOT_PORTED`, with its reason (ROADMAP's "Not
  ported on purpose", entry for entry). A key is ``<module>::<name>`` or a
  whole ``<module>``; a subpackage ``__init__`` re-export is covered by the
  entry of the module it is imported from.

Both tables are checked the other way too: an entry whose JAX name is no
longer public (``__all__`` or a top-level definition), whose target is
gone, or that the port now has under the same name, fails. Nothing here
imports JAX or the JAX package: the modules are read with ``ast``.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "rgcn_tpu")
PORT_PKG = os.path.join(ROOT, "rgcn_tpu_torch")

# JAX "<module>::<name>" -> port "<file>::<name>"
RENAMED = {
    "ops/pallas_aggregate.py::DstLayout": "ops/aggregate.py::DstLayout",
    "ops/pallas_aggregate.py::build_dst_layout": "ops/aggregate.py::build_dst_layout",
    "ops/pallas_aggregate.py::aggregate_presorted_pallas":
        "ops/aggregate.py::aggregate_presorted",
    "ops/pallas_aggregate.py::aggregate_sorted_pallas": "ops/aggregate.py::aggregate_sorted",
    "ops/pallas_aggregate.py::aggregate_messages_ad": "ops/aggregate.py::aggregate_sorted",
    "ops/pallas_basis.py::weighted_aggregate_pallas": "ops/basis.py::weighted_aggregate",
    "ops/pallas_basis.py::rel_spmm_basis_ad": "ops/basis.py::_BasisAD",
    "ops/pallas_basis.py::rel_spmm_basis_merged_ad": "ops/basis.py::_BasisMergedAD",
    "ops/pallas_basis.py::rel_spmm_featureless_basis_ad":
        "ops/basis.py::_FeaturelessBasisAD",
    "ops/pallas_diag.py::rel_spmm_diag_ad": "ops/diag.py::rel_spmm_diag_ad",
    "ops/pallas_distmult.py::build_batch_layouts":
        "ops/distmult_train.py::build_batch_layouts",
    "ops/pallas_distmult.py::build_structured_layouts":
        "ops/distmult_train.py::build_structured_layouts",
    "ops/pallas_distmult.py::distmult_score_agg_ad":
        "ops/distmult_train.py::distmult_score_agg",
    "ops/pallas_distmult.py::distmult_score_spenalty_agg_ad":
        "ops/distmult_train.py::distmult_score_spenalty_agg",
    "ops/pallas_distmult.py::distmult_structured_agg_ad":
        "ops/distmult_train.py::structured_scores",
    "ops/pallas_fused.py::FusedLayout": "ops/fused.py::FusedLayout",
    "ops/pallas_fused.py::build_fused_layout": "ops/fused.py::build_fused_layout",
    "ops/pallas_fused.py::build_fused_layout_dynamic":
        "ops/fused.py::build_fused_layout_dynamic",
    "ops/pallas_fused.py::rel_spmm_fused": "ops/fused.py::rel_spmm_fused",
    "ops/pallas_spmm.py::rel_spmm_messages": "ops/rel_spmm.py::rel_spmm_messages",
    "ops/pallas_spmm.py::rel_spmm_pallas": "ops/rel_spmm.py::fwd_spmm",
    "ops/pallas_spmm.py::rel_spmm_pallas_full": "ops/rel_spmm.py::rel_spmm_full",
    "ops/pallas_spmm.py::rel_spmm_pallas_ad": "ops/rel_spmm.py::rel_spmm_ad",
    "train/link_prediction.py::build_lp_model":
        "models/link_prediction.py::build_lp_model",
}

# JAX "<module>::<name>" or "<module>" -> why the port leaves it out
NOT_PORTED = {
    "train/evaluate.py::scan_ranks":
        "an XLA scan over the batches: the port ranks batch by batch",
    "train/evaluate.py::batched_eval_arrays":
        "the scan's padded batches: the port ranks batch by batch",
    "train/evaluate.py::evaluate_ranking":
        "the scanned evaluation: evaluate_link_predictor ranks batch by batch",
    "utils/exe_cache.py": "serialised XLA executables",
    "utils/compile_cache.py::enable":
        "XLA's compile cache: the kernel and host builds cache by source hash",
    "ops/gather.py": "a TPU gather probe",
    "ops/pallas_basis.py::rel_spmm_basis_blocks_ad":
        "a TPU gather experiment that measured slower; from_jax_params joins "
        "its blocks",
    "graph/native.py::native_available":
        "probes for a numpy fallback the port does not have",
    "data/native_nt.py::native_nt_available":
        "probes for a numpy fallback the port does not have",
    "ops/__init__.py":
        "the port's ops package re-exports nothing by design "
        "(rgcn_tpu_torch/ops/__init__.py)",
}


def _jax_modules():
    out = []
    for d, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), JAX_PKG))
    return sorted(out)


def _read(path):
    """(``__all__`` or None, top-level definitions, re-exports
    ``{name: JAX module path}``) of a module file."""
    tree = ast.parse(open(path).read(), filename=path)
    all_names, defined, sources = None, set(), {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    all_names = list(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    defined.add(t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("rgcn_tpu."):
            source = os.path.join(*node.module.split(".")[1:]) + ".py"
            for alias in node.names:
                sources[alias.asname or alias.name] = source
    return all_names, defined, sources


def _public(pkg, module):
    """``__all__`` and the public top-level definitions of a module."""
    path = os.path.join(pkg, module)
    if not os.path.isfile(path):
        return set()
    all_names, defined, _ = _read(path)
    return set(all_names or ()) | {n for n in defined if not n.startswith("_")}


def _not_ported(module, name):
    return module in NOT_PORTED or f"{module}::{name}" in NOT_PORTED


JAX_MODULES = _jax_modules()


@pytest.mark.parametrize("module", JAX_MODULES)
def test_jax_public_names_have_a_counterpart(module):
    all_names, _, sources = _read(os.path.join(JAX_PKG, module))
    port = _public(PORT_PKG, module)
    missing = []
    for name in all_names or ():
        key = f"{module}::{name}"
        if name in port or key in RENAMED or _not_ported(module, name):
            continue
        # a subpackage re-export is covered where its source module is
        source = sources.get(name)
        if source is not None and _not_ported(source, name):
            continue
        missing.append(name)
    assert not missing, (
        f"rgcn_tpu/{module}: {missing} have no counterpart in rgcn_tpu_torch/{module}, "
        "no RENAMED and no NOT_PORTED entry")


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_entries_are_live(key):
    module, name = key.split("::")
    assert name in _public(JAX_PKG, module), f"{key} is no longer public in rgcn_tpu"
    assert name not in _public(PORT_PKG, module), (
        f"{key}: the port has it under the same name; drop the RENAMED entry")
    target_file, target = RENAMED[key].split("::")
    path = os.path.join(PORT_PKG, target_file)
    assert os.path.isfile(path), f"{key} -> {RENAMED[key]}: no such file"
    assert target in _read(path)[1], f"{key} -> {RENAMED[key]}: no such definition"


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_entries_are_live(key):
    assert NOT_PORTED[key].strip(), f"{key}: no reason given"
    module, _, name = key.partition("::")
    public = _public(JAX_PKG, module)
    if not name:
        assert public, f"{key}: no such JAX module, or it has no public name"
        return
    assert name in public, f"{key} is no longer public in rgcn_tpu"
    assert name not in _public(PORT_PKG, module), (
        f"{key}: the port has it under the same name; drop the NOT_PORTED entry")
    assert key not in RENAMED, f"{key} is both renamed and not ported"
