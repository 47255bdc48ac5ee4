"""The port's package boundary: no JAX, nothing of rgcn_tpu, explicit
devices, and kernel wrappers that never fall back on a CUDA request."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rgcn_tpu_torch")

MODULES = [
    "rgcn_tpu_torch",
    "rgcn_tpu_torch.config",
    "rgcn_tpu_torch.data",
    "rgcn_tpu_torch.data.dispatch",
    "rgcn_tpu_torch.data.loaders",
    "rgcn_tpu_torch.data.native_nt",
    "rgcn_tpu_torch.data.nt",
    "rgcn_tpu_torch.graph",
    "rgcn_tpu_torch.graph.coalesce",
    "rgcn_tpu_torch.graph.dynamic",
    "rgcn_tpu_torch.graph.native",
    "rgcn_tpu_torch.graph.structure",
    "rgcn_tpu_torch.device",
    "rgcn_tpu_torch.ops.aggregate",
    "rgcn_tpu_torch.ops.basis",
    "rgcn_tpu_torch.ops.collectives",
    "rgcn_tpu_torch.ops.diag",
    "rgcn_tpu_torch.ops.distmult",
    "rgcn_tpu_torch.ops.distmult_train",
    "rgcn_tpu_torch.ops.fused",
    "rgcn_tpu_torch.ops.rel_spmm",
    "rgcn_tpu_torch.ops.spmm",
    "rgcn_tpu_torch.kernels",
    "rgcn_tpu_torch.native",
    "rgcn_tpu_torch.nn",
    "rgcn_tpu_torch.nn.layers",
    "rgcn_tpu_torch.models",
    "rgcn_tpu_torch.models.node_classification",
    "rgcn_tpu_torch.models.link_prediction",
    "rgcn_tpu_torch.serve",
    "rgcn_tpu_torch.serve_nodes",
    "rgcn_tpu_torch.serve_links",
    "rgcn_tpu_torch.weights",
    "rgcn_tpu_torch.profile_serve",
    "rgcn_tpu_torch.profile_epoch",
    "rgcn_tpu_torch.compare_k2",
    "rgcn_tpu_torch.compare_k3",
    "rgcn_tpu_torch.compare_k4_k5",
    "rgcn_tpu_torch.compare_gathers",
    "rgcn_tpu_torch.train",
    "rgcn_tpu_torch.train.optim",
    "rgcn_tpu_torch.train.evaluate",
    "rgcn_tpu_torch.train.node_classification",
    "rgcn_tpu_torch.train.link_prediction",
    "rgcn_tpu_torch.train.negative",
    "rgcn_tpu_torch.train.samplers",
    "rgcn_tpu_torch.utils",
    "rgcn_tpu_torch.utils.logging",
    "rgcn_tpu_torch.utils.checkpoint",
    "rgcn_tpu_torch.trace_train_gate",
    "rgcn_tpu_torch.classify_nodes",
    "rgcn_tpu_torch.predict_links",
    "rgcn_tpu_torch.dist",
    "rgcn_tpu_torch.dist.checkpoint",
    "rgcn_tpu_torch.dist.collectives",
    "rgcn_tpu_torch.dist.driver",
    "rgcn_tpu_torch.dist.evaluate",
    "rgcn_tpu_torch.dist.host",
    "rgcn_tpu_torch.dist.mesh",
    "rgcn_tpu_torch.dist.multihost",
    "rgcn_tpu_torch.dist.train",
]


def _port_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "sys.modules['pandas'] = None\n"
        f"import {', '.join(MODULES)}\n"
        "bad = sorted(m for m in sys.modules if m == 'rgcn_tpu' "
        "or m.startswith('rgcn_tpu.') or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(_port_files()), ids=os.path.basename)
def test_no_jax_or_rgcn_tpu_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    bad = [n for n in names
           if n.split(".")[0] in ("rgcn_tpu", "jax", "jaxlib", "flax", "optax",
                                  "orbax", "pandas")]
    assert not bad, f"{path} imports {bad}"


def test_default_device_needs_cuda(monkeypatch):
    from rgcn_tpu_torch.data.synthetic import synthetic_node_classification
    from rgcn_tpu_torch.device import resolve_device
    from rgcn_tpu_torch.serve import load_nc_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = synthetic_node_classification(num_nodes=40, num_rels=3,
                                         num_edges=120)
    cfg = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_nc_server(cfg, data, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: no silent CPU fallback."""
    from rgcn_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    x = torch.zeros((4, 2))
    w = torch.zeros((1, 2, 2))
    i32 = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.launch_k1_aggregate(torch.zeros((8, 2)), None,
                                    i32.reshape(1, 8), i32[:1], 4, 4, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.launch_k2_fused(x, w, i32, torch.zeros(8), i32.reshape(1, 8),
                                i32[:1], i32[:1], 4, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.launch_k3_messages(x, w, i32, torch.zeros(8), i32[:1], 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.launch_k4_weighted_aggregate(x, i32, torch.zeros((2, 8)),
                                             i32.reshape(1, 8), i32[:1], 4, 4, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.launch_k5_weighted_aggregate_dedup(
            x, i32, torch.zeros((2, 1, 8)), i32.reshape(2, 1, 4), i32[:1], 4, 4, 1)
    assert kernels.LAUNCHES == before


def test_basis_wrappers_take_plain_version_only_on_cpu():
    """K4/K5 dispatch: CPU tensors take the plain versions and count no
    launch; tensors elsewhere go to the launchers, which refuse what is
    not on the card (the meta device stands in for it)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.ops import basis

    rng = np.random.default_rng(0)
    dst, src = rng.integers(0, 30, 80), rng.integers(0, 30, 80)
    m = build_merged_layout(dst, src, rng.integers(0, 4, 80),
                            np.ones(80, np.float32), 30, 4, dedup_k=2)
    m = m.to("cpu")
    before = dict(kernels.LAUNCHES)
    x = torch.ones((30, 5))
    w = torch.ones((2, m.layout.num_chunks * m.layout.chunk))
    out = basis.weighted_aggregate(x, m.src_sorted, w, m.layout, 30)
    assert out.shape == (2, 30, 5) and kernels.LAUNCHES == before
    dd = m.fwd_dedup
    w_k = torch.ones((2, 2, dd.num_chunks * dd.chunk))
    out = basis.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, 30)
    assert out.shape == (2, 30, 5) and kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        basis.weighted_aggregate(x.to("meta"), m.src_sorted, w, m.layout, 30)
    with pytest.raises(ValueError, match="CUDA tensor"):
        basis.weighted_aggregate_dedup(x.to("meta"), dd.src_sorted, w_k, dd, 30)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("num_nodes", [20, 33])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_basis_wrappers_refuse_node_count_off_layout(num_nodes, device):
    """K4/K5 refuse a node count that does not span the layout's row blocks
    (30 nodes in 4 blocks of 8), on the plain route (CPU tensors) and
    before the kernel route (the meta device stands in for the card)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.graph.coalesce import build_merged_layout
    from rgcn_tpu_torch.ops import basis

    rng = np.random.default_rng(1)
    dst, src = rng.integers(0, 30, 80), rng.integers(0, 30, 80)
    m = build_merged_layout(dst, src, rng.integers(0, 4, 80),
                            np.ones(80, np.float32), 30, 4, row_block=8,
                            chunk=16, dedup_k=2).to("cpu")
    before = dict(kernels.LAUNCHES)
    x = torch.ones((30, 5), device=device)
    w = torch.ones((2, m.layout.num_chunks * m.layout.chunk), device=device)
    dd = m.fwd_dedup
    w_k = torch.ones((2, 2, dd.num_chunks * dd.chunk), device=device)
    with pytest.raises(ValueError, match="4 row blocks of 8"):
        basis.weighted_aggregate(x, m.src_sorted, w, m.layout, num_nodes)
    with pytest.raises(ValueError, match="4 row blocks of 8"):
        basis.weighted_aggregate_dedup(x, dd.src_sorted, w_k, dd, num_nodes)
    assert kernels.LAUNCHES == before


def test_ctypes_signatures_match_sources():
    """Each launcher's ctypes argtypes match its C signature in csrc/; K2's
    tile variant and K3's FMA, edge-column and probe variants (bound with
    K2's and K3's argtypes) have their kernels' signatures; the K4/K5 variants match the
    argtypes compare_k4_k5 binds them with."""
    import ctypes

    from rgcn_tpu_torch import compare_k2, compare_k3, compare_k4_k5, kernels
    from rgcn_tpu_torch.kernels import build

    launchers = [(name, src, kernels._ARGTYPES[name])
                 for name, src in build.SOURCES.items()]
    launchers.append(("k2_fused_tile", compare_k2.VARIANT, kernels._ARGTYPES["k2_fused"]))
    launchers += [(name, src, kernels._ARGTYPES["k3_messages"])
                  for name, src in {**compare_k3.VARIANTS, **compare_k3.PROBES}.items()]
    launchers += [(name, src, argtypes)
                  for name, (src, argtypes) in compare_k4_k5.VARIANTS.items()]
    for name, src, argtypes in launchers:
        text = open(os.path.join(build.CSRC, src)).read()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, f"no extern C launcher {name} in {src}"
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert argtypes == want, name


def test_compare_k2_needs_cuda(monkeypatch):
    """The K2 design comparison runs on the card only: without CUDA it
    raises before building anything."""
    from rgcn_tpu_torch import compare_k2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k2, "build_tile", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k2.main([])


def test_compare_gathers_needs_cuda(monkeypatch):
    """The gather comparison runs on the card only: without CUDA it raises
    before building any graph."""
    from rgcn_tpu_torch import compare_gathers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_gathers, "am_ops", lambda *a: pytest.fail("ran"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_gathers.main([])


def test_profile_epoch_needs_cuda(monkeypatch):
    """The host-build measurement names a card: without CUDA (and without
    --cpu) it raises before building a trainer."""
    from rgcn_tpu_torch import profile_epoch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profile_epoch, "profile_config",
                        lambda *a, **k: pytest.fail("profiled"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_epoch.main([])


def test_import_builds_and_loads_no_host_library():
    """Importing the port compiles nothing and loads no native library: the
    host builders are built at first use."""
    code = (
        f"import {', '.join(MODULES)}\n"
        "import rgcn_tpu_torch.native as n\n"
        "assert not n._LIBS, n._LIBS\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'host_builders' not in maps and 'librgcn_native' not in maps\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_compare_k3_needs_cuda(monkeypatch):
    """The K3 design comparison runs on the card only: without CUDA it
    raises before building anything."""
    from rgcn_tpu_torch import compare_k3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k3, "build_variants", lambda _: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k3.main([])


def test_compare_k4_k5_needs_cuda(monkeypatch):
    """The K4/K5 design comparison runs on the card only: without CUDA it
    raises before building anything."""
    from rgcn_tpu_torch import compare_k4_k5

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k4_k5, "build_variants", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k4_k5.main([])


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """K4's and K5's sources include weighted_runs.cuh: an edit of the header
    alone must give them a new library path, so they are rebuilt."""
    from rgcn_tpu_torch.kernels import build

    for name in ("k4_weighted_aggregate.cu", "weighted_runs.cuh"):
        (tmp_path / name).write_bytes(open(os.path.join(build.CSRC, name), "rb").read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = build.library_path("k4_weighted_aggregate")
    with open(tmp_path / "weighted_runs.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("k4_weighted_aggregate") != before


def test_cached_build_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """A kernel found built reports the registers and spills of the nvcc
    run that built it (chip_smoke.py's build phase prints them)."""
    from rgcn_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    lib = build.library_path("k1_aggregate")
    open(lib, "w").close()
    with open(build._log_path(lib), "w") as f:
        f.write("ptxas info    : Used 40 registers, used 0 barriers\n")
    got = build.build_all(["k1_aggregate"])["k1_aggregate"]
    assert got["cached"] and got["path"] == lib
    assert "Used 40 registers" in got["log"]


def test_serve_nodes_cli_cpu(capsys):
    from rgcn_tpu_torch import serve_nodes

    cfg = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")
    serve_nodes.main(["--config", cfg, "--synthetic", "--cpu",
                      "--nodes", "node1", "42"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[synthetic] AIFB-like graph: N=8285 R=45")
    assert out[1].startswith("node1: class ") and out[2].startswith("node42: class ")
    with pytest.raises(SystemExit):
        serve_nodes.main(["--config", cfg, "--cpu"])  # no dataset files in data/
    probs = np.array([float(line.split("p=")[1].rstrip(")")) for line in out[1:]])
    assert ((probs > 0) & (probs <= 1)).all()


def test_trace_smoke_phases_records_each_gate(monkeypatch):
    """The phases-1-5 trace records every phase-5 path's final-logits
    distance and gate, also when a gate fails and ends the phases."""
    import chip_smoke

    from rgcn_tpu_torch import trace_train_gate

    ref = torch.tensor([[1.0, -2.0], [0.5, 3.0]])

    def phases(dev):
        for label, moved in (("main: fused layouts", 1e-6), ("K3 + K1 branch", 1.0)):
            chip_smoke.check_train_against_cpu(
                label, [("training.loss", 1, 0.5)], [("training.loss", 1, 0.5)],
                ref + moved, ref)

    monkeypatch.setattr(chip_smoke, "phase_environment", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setattr(chip_smoke, "phases_nc_aifb", phases)
    monkeypatch.setattr(chip_smoke, "check_train_against_cpu",
                        chip_smoke.check_train_against_cpu)
    out = trace_train_gate.smoke_phases()["smoke_phases_1_5"]
    assert out["exit_code"] == 1
    assert [g["path"] for g in out["gates"]] == ["main: fused layouts", "K3 + K1 branch"]
    assert out["gates"][0]["logits_diff"] <= out["gates"][0]["tol"] == pytest.approx(3e-4)
    assert out["gates"][1]["logits_diff"] == pytest.approx(1.0)
