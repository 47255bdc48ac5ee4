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
gone, or that the port now has under the same name, fails.

Arguments too: every parameter of a public JAX function (and every field
of a flax module or dataclass) with a counterpart must be a parameter of
that counterpart (its ``__init__`` for a module class, its ``forward``
for an autograd Function), an entry of :data:`RENAMED_ARGS` (framework
plumbing the port takes in another form) or of :data:`ARGS_NOT_PORTED`
(with its reason). A key there is a bare argument name (wherever it
appears) or ``<module>::<name>::<argument>``; a stale entry fails.
Nothing here imports JAX or the JAX package: the modules are read with
``ast``.
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
    "ops/pallas_spmm.py::rel_spmm_pallas": "ops/rel_spmm.py::rel_spmm_pallas",
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


# --- arguments -----------------------------------------------------------

# JAX argument -> the port's form of it. Bare keys: framework plumbing,
# wherever the argument appears (text). "<module>::<name>::<argument>"
# keys: the port's parameters that take it (each must be one).
RENAMED_ARGS = {
    "axis_name": "the torch.distributed group: group=/decoder_group= on the "
                 "modules, the mesh's groups on steps, drivers and builders",
    "decoder_axis_name": "decoder_group=",
    "edge_axis": "the mesh's edge group",
    "axis": "the mesh's groups",
    "key": "a torch.Generator (generator=)",
    "dropout_key": "a torch.Generator (generator=)",
    "params": "the module, which holds its parameters",
    "tx": "a torch.optim optimizer (optimizer=)",
    "mesh": "the mesh's rank, device and groups, passed as they are needed",
    "devices": "device=",
    "dist/multihost.py::initialize_distributed::coordinator_address": ("init_method",),
    "dist/multihost.py::initialize_distributed::num_processes": ("world_size",),
    "dist/multihost.py::initialize_distributed::process_id": ("rank",),
    "dist/multihost.py::initialize_distributed::local_device_ids": ("local_rank", "device"),
    "dist/multihost.py::make_mesh_2d::replica_axis": ("device",),
    "dist/checkpoint.py::save_checkpoint_replicated::state": ("model", "optimizer"),
    "dist/evaluate.py::make_sharded_rank_sweep::model": ("method",),
    "dist/train.py::make_sharded_lp_step_hosted::num_nodes": ("decoder_group",),
    "dist/train.py::make_sharded_lp_step_hosted::structural_self_keep": ("decoder_group",),
    "dist/train.py::make_sharded_lp_step_hosted_structured::num_nodes": ("decoder_group",),
    "dist/train.py::make_sharded_lp_step_hosted_structured::structural_self_keep":
        ("decoder_group",),
    "nn/layers.py::TorchLinear::features": ("out_features",),
    "ops/pallas_aggregate.py::aggregate_messages_ad::edges": ("layout", "num_nodes", "dst"),
    "ops/pallas_basis.py::weighted_aggregate_pallas::xg_sorted": ("x", "src"),
    "ops/pallas_basis.py::weighted_aggregate_pallas::weights": ("w",),
    "ops/pallas_basis.py::weighted_aggregate_pallas::compute_dtype": ("x",),
    "ops/pallas_basis.py::rel_spmm_featureless_basis_ad::bases_rows": ("bases",),
    "ops/pallas_diag.py::rel_spmm_diag_ad::diag_weights": ("dw",),
    "train/link_prediction.py::build_lp_model::**extra":
        ("group", "decoder_group", "feature_blocks"),
}

# JAX argument -> why the port has no counterpart; keys as RENAMED_ARGS'
ARGS_NOT_PORTED = {
    "interpret": "Pallas' interpreter: the port runs a kernel on the card, "
                 "its plain version on the CPU",
    "input_fusion": "XLA fusing a producer into a Pallas kernel's input pipeline",
    "exe_cache_dir": "serialised XLA executables: PyTorch compiles nothing per step",
    "exe_search": "serialised XLA executables: PyTorch compiles nothing per step",
    "dist/evaluate.py::make_sharded_rank_sweep::tag":
        "names the sweep's entry in the XLA executable cache (exe_cache_dir)",
    "backend": "the JAX package's XLA routes: the port always takes its kernels",
    "like": "orbax's restore template: the port restores into the module",
    "partial": "orbax's partial restore: the port's restore_checkpoint takes "
               "partial_keys",
    "pallas_train_step": "the XLA training step (segment sums, no kernel): "
                         "the port trains on its kernels only",
}


def _params(args: ast.arguments, skip_first: bool = False):
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if skip_first:
        names = names[1:]
    if args.vararg:
        names.append("*" + args.vararg.arg)
    if args.kwarg:
        names.append("**" + args.kwarg.arg)
    return names


def _signatures(path):
    """``{name: parameters}`` of a module's top-level functions and classes:
    a class's ``__init__`` parameters, else an autograd Function's
    ``forward`` (after ``ctx``), else its annotated fields, those of its
    bases in the module included; a name imported from another port
    module maps to ``("import", file)``."""
    tree = ast.parse(open(path).read(), filename=path)
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def class_params(node):
        methods = {b.name: b for b in node.body if isinstance(b, ast.FunctionDef)}
        if "__init__" in methods:
            return _params(methods["__init__"].args, skip_first=True)
        if "forward" in methods and any(
                ast.unparse(b).endswith("Function") for b in node.bases):
            return _params(methods["forward"].args, skip_first=True)
        fields = [b.target.id for b in node.body
                  if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)]
        for base in node.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                fields = class_params(classes[base.id]) + fields
        return fields

    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node.args)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = class_params(node)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("rgcn_tpu_torch."):
            for alias in node.names:
                out.setdefault(alias.asname or alias.name, (
                    "import", os.path.join(*node.module.split(".")[1:]) + ".py"))
    return out


def _port_params(file, name):
    """The parameters of the port's ``file::name``, following imports."""
    for _ in range(4):
        path = os.path.join(PORT_PKG, file)
        if not os.path.isfile(path):
            return None
        found = _signatures(path).get(name)
        if not (isinstance(found, tuple) and found[0] == "import"):
            return found
        file = found[1]
    return None


def _arg_pairs():
    """``(JAX "<module>::<name>", JAX parameters, port file, port name)`` for
    every public JAX function or class with a counterpart."""
    pairs = []
    for module in JAX_MODULES:
        all_names, _, _ = _read(os.path.join(JAX_PKG, module))
        sigs = _signatures(os.path.join(JAX_PKG, module))
        for name in all_names or ():
            key = f"{module}::{name}"
            if name not in sigs or isinstance(sigs[name], tuple) \
                    or _not_ported(module, name):
                continue
            target = RENAMED.get(key, f"{module}::{name}")
            pairs.append((key, sigs[name], *target.split("::")))
    return pairs


ARG_PAIRS = _arg_pairs()
ARG_KEYS = {key: (params, pfile, pname) for key, params, pfile, pname in ARG_PAIRS}


def _missing(key):
    params, pfile, pname = ARG_KEYS[key]
    port = _port_params(pfile, pname)
    assert port is not None, f"{key}: no port counterpart {pfile}::{pname}"
    return [a for a in params if a not in port and a != "self"], port


def _covered(key, arg):
    return any(k in table for table in (RENAMED_ARGS, ARGS_NOT_PORTED)
               for k in (arg, f"{key}::{arg}"))


@pytest.mark.parametrize("key", sorted(ARG_KEYS))
def test_jax_arguments_have_a_counterpart(key):
    missing, _ = _missing(key)
    uncovered = [a for a in missing if not _covered(key, a)]
    assert not uncovered, (
        f"rgcn_tpu/{key}: arguments {uncovered} have no counterpart in "
        f"rgcn_tpu_torch/{ARG_KEYS[key][1]}::{ARG_KEYS[key][2]}, no RENAMED_ARGS "
        "and no ARGS_NOT_PORTED entry")


@pytest.mark.parametrize("table,entry", [("RENAMED_ARGS", k) for k in sorted(RENAMED_ARGS)]
                         + [("ARGS_NOT_PORTED", k) for k in sorted(ARGS_NOT_PORTED)])
def test_argument_entries_are_live(table, entry):
    value = (RENAMED_ARGS if table == "RENAMED_ARGS" else ARGS_NOT_PORTED)[entry]
    assert value, f"{entry}: no counterpart or reason given"
    if "::" not in entry:
        users = [key for key in ARG_KEYS if entry in _missing(key)[0]]
        assert users, f"{table}[{entry!r}]: no JAX function's argument needs it"
        return
    module, name, arg = entry.split("::")
    key = f"{module}::{name}"
    assert key in ARG_KEYS, f"{table}[{entry!r}]: {key} is not a ported JAX function"
    missing, port = _missing(key)
    assert arg in ARG_KEYS[key][0], f"{table}[{entry!r}]: no such JAX argument"
    assert arg in missing, f"{table}[{entry!r}]: the port now takes {arg} as it is"
    if table == "RENAMED_ARGS":
        gone = [p for p in value if p not in port]
        assert not gone, f"{table}[{entry!r}]: the port has no parameter {gone}"
