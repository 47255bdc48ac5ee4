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
    "rgcn_tpu_torch.graph.augment",
    "rgcn_tpu_torch.graph.coalesce",
    "rgcn_tpu_torch.graph.compat",
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
    "rgcn_tpu_torch.ops.ordered",
    "rgcn_tpu_torch.kernels",
    "rgcn_tpu_torch.native",
    "rgcn_tpu_torch.nn",
    "rgcn_tpu_torch.nn.init",
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
    "rgcn_tpu_torch.compare_k1_k2",
    "rgcn_tpu_torch.compare_k3",
    "rgcn_tpu_torch.compare_k4_k5",
    "rgcn_tpu_torch.compare_k4_bf16",
    "rgcn_tpu_torch.compare_k4",
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
    "rgcn_tpu_torch.utils.canary",
    "rgcn_tpu_torch.utils.profiling",
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
        "from rgcn_tpu_torch.graph import augment_triples, padded_size, "
        "self_loop_triples\n"
        "from rgcn_tpu_torch.graph.augment import split_spo\n"
        "from rgcn_tpu_torch.nn import TorchLinear\n"
        "from rgcn_tpu_torch.nn.init import uniform_symmetric\n"
        "from rgcn_tpu_torch.train import make_optimizer, select_sampler, "
        "RankingFilters\n"
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
    tile and atomics variants (bound with K2's argument list before its
    redesign) and K3's FMA, edge-column and probe variants (bound with K3's
    argtypes) have their kernels' signatures; the K4/K5 variants and
    compare_k1_k2's match the argtypes their scripts bind them with."""
    import ctypes

    from rgcn_tpu_torch import compare_k1_k2, compare_k2, compare_k3, compare_k4_k5, kernels
    from rgcn_tpu_torch.kernels import build

    launchers = [(name, src, kernels._ARGTYPES[name])
                 for name, src in build.SOURCES.items()]
    launchers.append(("k2_fused_tile", compare_k2.VARIANT, compare_k2.OLD_K2_ARGS))
    launchers.append(("k2_atomics_f32", compare_k2.ATOMICS, compare_k2.OLD_K2_ARGS))
    launchers += [(name, src, argtypes)
                  for name, (src, argtypes) in compare_k1_k2.VARIANTS.items()]
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


def test_compare_k1_k2_needs_cuda(monkeypatch):
    """K1's and K2's fixed-order designs are compared with the atomics
    designs on the card only: without CUDA the script raises before
    building anything."""
    from rgcn_tpu_torch import compare_k1_k2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k1_k2, "build_variants", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k1_k2.main([])


@pytest.mark.parametrize("name", ["k1_aggregate", "k1_aggregate_bf16", "k2_fused",
                                  "k2_fused_bf16"])
def test_fixed_order_launchers_take_scratch_and_counters(name):
    """K1's and K2's C launchers take the f32 scratch and the stream's
    counters after the output, and K1 its route where it took dst_sorted;
    no memset is left in their launch paths (the atomics route K1 kept
    before is a variant for the comparisons, with its memset)."""
    import ctypes

    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.kernels import build

    text = open(os.path.join(build.CSRC, build.SOURCES[name])).read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    params = [p.strip().split()[-1].lstrip("*") for p in m.group(1).split(",")]
    out = params.index("out")
    assert params[out + 1] in ("scratch", "part") and params[out + 2] == "counters"
    assert ("route" in params) == name.startswith("k1") and "dst_sorted" not in params
    assert kernels._ARGTYPES[name][out + 2] is ctypes.c_void_p
    for header in ("k2_fused.cuh", "chunk_sum.cuh"):
        assert "cudaMemsetAsync" not in open(os.path.join(build.CSRC, header)).read()
    k1 = open(os.path.join(build.CSRC, "k1_aggregate.cuh")).read()
    assert "cudaMemsetAsync" not in k1 and "atomicAdd" not in k1
    kept = open(os.path.join(build.CSRC, "variants", "k1_atomic_routes.cuh")).read()
    at = kept.index("cudaMemsetAsync")
    assert "if (route == kAtomics)" in kept[at - 300:at]


def _layout_shape(lay, dout):
    return dict(n_chunks=lay.num_chunks, chunk=lay.chunk, row_block=lay.row_block, dout=dout)


def test_k1_route_by_layout_at_the_model_shapes():
    """K1's route is a function of the layout's order alone: every
    destination-sorted layout the configs build takes the fixed-order
    owned-row route at any size and width (nc-AIFB's, dout 16; the pair
    path's layout of slots grouped by pair, dout 10, at a small size;
    lp-FB-toy's, dout 500; lp-WN18's, 1,014 CTAs; and at AM scale nc-AM's
    pair path at width 10 and e-RGCN nc-AM's diagonal at 32, which took
    the atomics and owned routes before), a source-ordered one the chunk
    route; the lanes are 4 values with a masked tail, moved in pieces of
    4, 2 or 1 values by the rows' width and the table's alignment; the
    scratch is two rows of dout rounded up to whole lanes a unit, or an
    (RB, dout) tile a chunk; the counters one a (unit, column group)."""
    from rgcn_tpu_torch import kernels
    from rgcn_tpu_torch.data.synthetic import aifb_like, fb_toy_like
    from rgcn_tpu_torch.graph.structure import build_edge_set
    from rgcn_tpu_torch.ops.aggregate import build_dst_layout

    aifb = aifb_like()
    es = build_edge_set(aifb.triples, aifb.num_nodes, aifb.num_relations, tile_size=128,
                        with_dst_layout=True)
    fb = fb_toy_like()
    fes = build_edge_set(fb.train, fb.num_nodes, fb.num_relations, tile_size=128,
                         with_dst_layout=True)
    rng = np.random.default_rng(3)
    triples = np.stack([rng.integers(0, 500, 4000), rng.integers(0, 6, 4000),
                        rng.integers(0, 500, 4000)], axis=1)
    pes = build_edge_set(triples, 500, 6, with_dst_layout=True, with_pair_index=True,
                         with_pair_agg=True)
    cases = [(es.layout, 16, es.num_nodes), (pes.pairs.agg.grad_layout, 10, 500),
             (fes.layout, 500, fes.num_nodes)]
    assert es.layout.num_chunks == 261 and es.layout.chunk == 256
    for lay, dout, n in cases:
        assert lay.dst_sorted and kernels.k1_route(lay.dst_sorted) == kernels.K1_FIXED
        shape = _layout_shape(lay, dout)
        units = kernels.k1_fixed_units(shape["n_chunks"], shape["chunk"], dout)
        assert units >= lay.num_chunks
        assert kernels.k1_scratch_floats(kernels.K1_FIXED, **shape) == \
            units * 2 * (-(-dout // 4) * 4)
    # nc-AIFB: 4 lanes a row, a CTA a chunk (span 256)
    assert kernels.k1_fixed_units(261, 256, 16) == 261
    # dout 10: 3 lanes a row (4, 4 and a masked 2) in groups of 4, span 256
    assert kernels.k1_fixed_units(100, 256, 10) == 100
    # dout 4: 1 lane a row, span 2,048 slots
    assert kernels.k1_fixed_units(10, 2048, 4) == 10
    # nc-AM at AM scale: 6,925 chunks of 256 (am_like()'s destination
    # layout): the pair path at width 10 and e-RGCN's diagonal at 32, a
    # CTA a chunk; the pair path's dT at 400 and 440, a CTA a (chunk,
    # column group of 128); lp-WN18's 1,014 chunks at 200
    for n_chunks, dout, groups in ((6925, 10, 1), (6925, 32, 1), (6925, 128, 1),
                                   (6925, 400, 4), (6925, 440, 4), (1014, 200, 2)):
        assert kernels.k1_route(True) == kernels.K1_FIXED
        assert kernels.k1_fixed_units(n_chunks, 256, dout) == n_chunks
        assert kernels.k1_fixed_counters(n_chunks, 256, dout) == n_chunks * groups
    assert kernels.k1_scratch_floats(kernels.K1_FIXED, 6925, 256, 128, 10) == \
        6925 * 2 * 12
    assert kernels.k1_scratch_floats(kernels.K1_FIXED, 6925, 256, 128, 32) == \
        6925 * 2 * 32
    # lp-FB-toy's dout 500: 4 column groups of 32 lanes x 4 values, the
    # counters one a (unit, column group)
    n_fb = fes.layout.num_chunks
    assert kernels.k1_fixed_counters(n_fb, 256, 500) == n_fb * 4
    # the pieces: 4 values on whole, aligned lanes; 2 (8-byte f32, 4-byte
    # bf16) at width 10; 1 at an odd width or a table off its 2-value grid
    assert kernels.k1_piece(16, 0x7f0000000010, 4) == 4
    assert kernels.k1_piece(16, 0x7f0000000008, 4) == 2
    assert kernels.k1_piece(16, 0x7f0000000008, 2) == 4
    assert kernels.k1_piece(10, 0x7f0000000000, 4) == 2
    assert kernels.k1_piece(10, 0x7f0000000000, 2) == 2
    assert kernels.k1_piece(11, 0x7f0000000000, 4) == 1
    assert kernels.k1_piece(10, 0x7f0000000004, 4) == 1
    by_src = build_dst_layout(es.dst, es.num_nodes, src=es.src)
    assert not by_src.dst_sorted and kernels.k1_route(False) == kernels.K1_CHUNK
    shape = _layout_shape(by_src, 16)
    assert kernels.k1_scratch_floats(kernels.K1_CHUNK, **shape) == \
        by_src.num_chunks * (by_src.row_block * 16 + by_src.row_block // 32)
    assert kernels.chunk_scratch_floats(296, 512, 4) == 296 * (512 * 4 + 16)


def test_chunk_sum_shared_memory():
    """chunk_sum.cuh's shared memory (K2, K1's chunk route): a slice (the
    power of two at least dout, 4 to 32 columns, at a pitch 4 floats wider
    from 8 up) of every slot's message, a bit a slot for each row and a bit
    a row of the block; the builders' fused geometry (RB 512, CH 512) fits
    at any width, and a
    geometry past an H100 CTA's 232,448 bytes is refused before a launch."""
    from rgcn_tpu_torch import kernels

    assert kernels.chunk_smem_bytes(512, 512, 4) == 4 * (512 * 4 + 16 * 512 + 16)
    assert kernels.chunk_smem_bytes(512, 512, 10) == 4 * (512 * 20 + 16 * 512 + 16)
    assert kernels.chunk_smem_bytes(512, 512, 500) == 4 * (512 * 36 + 16 * 512 + 16)
    assert kernels.chunk_smem_bytes(48, 96, 16) == 4 * (48 * 20 + 2 * 96 + 3)
    kernels._check_chunk_smem("K2", 512, 512, 500)
    with pytest.raises(ValueError, match="past 232448"):
        kernels._check_chunk_smem("K2", 4096, 2048, 16)


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


def test_compare_k1_k5_needs_cuda(monkeypatch):
    """K1's routes and K5's passes are compared on the card only: without
    CUDA the script raises before building anything."""
    from rgcn_tpu_torch import compare_k1_k5

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k1_k5, "build_variants", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k1_k5.main([])


@pytest.mark.parametrize("name", ["k1_owned_f32", "k1_atomics_f32", "k1_owned_bf16",
                                  "k1_atomics_bf16", "k1_wruns_f32", "k1_wruns_bf16",
                                  "k5_cta_passes", "k5_last_cta"])
def test_compare_k1_k5_variant_signatures(name):
    """The variants' C launchers have the argument types compare_k1_k5
    binds them with (K1's launcher's list before its fixed-order redesign,
    K5's launcher's list; k5_last_cta takes its per-block counters before
    the stream)."""
    import ctypes

    from rgcn_tpu_torch import compare_k1_k5, kernels
    from rgcn_tpu_torch.kernels import build

    src, argtypes = compare_k1_k5.VARIANTS[name]
    text = open(os.path.join(build.CSRC, src)).read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"no extern C launcher {name} in {src}"
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in m.group(1).split(",")]
    assert argtypes == want
    launcher = kernels._ARGTYPES["k5_weighted_aggregate_dedup"] if name.startswith("k5") \
        else [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    if name == "k5_last_cta":
        launcher = launcher[:-1] + [ctypes.c_void_p] + launcher[-1:]
    assert argtypes == launcher


def test_compare_k4_needs_cuda(monkeypatch):
    """K4's launchers are compared with the design they replaced on the card
    only: without CUDA the script raises before building anything."""
    from rgcn_tpu_torch import compare_k4, compare_k4_bf16

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k4_bf16, "build_variants", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k4.main([])


def test_compare_k4_bf16_needs_cuda(monkeypatch):
    """K4's bf16 designs are compared on the card only: without CUDA the
    script raises before building anything."""
    from rgcn_tpu_torch import compare_k4_bf16

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(compare_k4_bf16, "build_variants", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_k4_bf16.main([])


@pytest.mark.parametrize("name", ["k4_bf16_variant", "k4_bf16_probe"])
def test_compare_k4_bf16_variant_signatures(name):
    """The variants' C launchers take the bf16 launcher's arguments, and one
    more before the stream (k4_bf16_variant the variant's number,
    k4_bf16_probe its stamps), as compare_k4_bf16 binds them."""
    import ctypes

    from rgcn_tpu_torch import compare_k4_bf16, kernels
    from rgcn_tpu_torch.kernels import build

    src, argtypes = compare_k4_bf16.VARIANTS[name]
    text = open(os.path.join(build.CSRC, src)).read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"no extern C launcher {name} in {src}"
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in m.group(1).split(",")]
    assert argtypes == want
    launcher = kernels._ARGTYPES["k4_weighted_aggregate_bf16"]
    extra = ctypes.c_int if name == "k4_bf16_variant" else ctypes.c_void_p
    launcher = launcher[:-1] + [extra] + launcher[-1:]
    assert want == launcher


@pytest.mark.parametrize("name", ["k4_runs_f32", "k4_runs_bf16"])
def test_k4_runs_variant_signatures(name):
    """The design K4's launchers replaced (variants/k4_weighted_runs.cu)
    keeps its launcher's arguments from before: no counters, no span, as
    compare_k4_bf16 binds them; nothing of it is left in the launchers."""
    import ctypes

    from rgcn_tpu_torch import compare_k4_bf16
    from rgcn_tpu_torch.kernels import build

    src, argtypes = compare_k4_bf16.VARIANTS[name]
    text = open(os.path.join(build.CSRC, src)).read()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"no extern C launcher {name} in {src}"
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in m.group(1).split(",")]
    assert argtypes == want == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    assert '#include "../weighted_runs.cuh"' in text


@pytest.mark.parametrize("n_chunks,chunk,row_len,span,want", [
    (502, 256, 400, 256, 502 * 2 * 400),    # lp-WN18's merged frame, nb 2, din 200
    (502, 256, 200, 128, 502 * 2 * 2 * 200),  # half-chunk units: two a chunk
    (261, 256, 64, 256, 261 * 2 * 64),      # nc-AIFB, 4 bases of 16
    (6925, 256, 10, 256, 6925 * 2 * 10),    # nc-AM's featureless layer, sum_bases
    (40, 64, 400, 256, 40 * 2 * 400),       # a span past the chunk: a unit a chunk
    (7, 100, 3, 64, 7 * 2 * 2 * 3),         # a chunk of a unit and a part
])
def test_k4_bf16_scratch_floats(n_chunks, chunk, row_len, span, want):
    """K4's f32 scratch (both forms): two rows a unit of ``span`` slots of a
    chunk, as csrc/k4_owned.cuh's units address it, each row the output's
    bases at din rounded up to whole 16-byte vectors of the table."""
    from rgcn_tpu_torch import kernels

    assert kernels.k4_scratch_floats(n_chunks, chunk, row_len, span) == want
    assert kernels.K4_SPAN == 256
    assert kernels.k4_row_floats(2, 200, 2) == 400 and kernels.k4_row_floats(2, 200, 4) == 400
    assert kernels.k4_row_floats(1, 10, 2) == 16 and kernels.k4_row_floats(1, 10, 4) == 12
    assert kernels.k4_row_floats(4, 16, 2) == 64 and kernels.k4_row_floats(4, 3, 4) == 16


@pytest.mark.parametrize("shape,din,offset,n_chunks,nb_out,out,route", [
    ("nc-AIFB with 4 bases: the featureless layer, f32 out", 16, 0, 261, 1, "f32", 8),
    ("nc-AIFB's layer-2 Agg over its merged frame", 16, 0, 260, 4, "bf16", 8),
    ("nc-AIFB's layer-2 dx", 16, 0, 260, 1, "bf16", 8),
    ("nc-AIFB's dbases", 16, 0, 261, 4, "f32", 8),
    ("lp-WN18's forward Agg: merged frame, 2 bases, bf16 out", 200, 0, 502, 2, "bf16", 8),
    ("lp-WN18's VJP dx: one output", 200, 0, 502, 1, "bf16", 8),
    ("lp-WN18's merged frame with an f32 output", 200, 0, 502, 2, "f32", 8),
    ("nc-AM with 4 bases: hidden 10", 10, 0, 6925, 1, "f32", 2),
    ("nc-AM's width at few chunks", 10, 0, 64, 4, "bf16", 2),
    ("the decoder's bwd_dtype pair over the corrupted layout", 200, 256, 1492, 1, "f32", 8),
    ("a table one bf16 value off 16 bytes", 200, 2, 261, 1, "f32", 1),
    ("a table 8 bytes off 16", 64, 8, 100, 2, "bf16", 4),
    ("every output at the most chunks of the first bound", 200, 0, 384, 8, "bf16", 8),
    ("several bf16 outputs one chunk past it", 200, 0, 385, 2, "bf16", 8),
    ("one output at the most chunks", 200, 0, 1024, 1, "bf16", 8),
    ("one chunk more", 200, 0, 1025, 1, "bf16", 8),
])
def test_k4_bf16_route_by_shape(shape, din, offset, n_chunks, nb_out, out, route):
    """Every layout takes K4's one kernel, the fixed-order owned-row kernel
    of csrc/k4_owned.cuh (both launchers include it and nothing else, and
    take no route), whatever its chunk count or output; the values a copy
    and a store move (``route`` here) follow from the table's width and
    alignment alone: whole 16-byte vectors (8 bf16, 4 f32), else the most
    that din and the table's address allow."""
    from rgcn_tpu_torch import kernels

    table = 0x7f0000000000 + offset
    assert kernels.k4_piece(din, table, 2) == route, shape
    # an f32 table of the same width at the same address: half the values
    assert kernels.k4_piece(din, table, 4) == {8: 4, 4: 2, 2: 2, 1: 1}[route], shape
    for name in ("k4_weighted_aggregate.cu", "k4_weighted_aggregate_bf16.cu"):
        src = open(os.path.join(PKG, "kernels", "csrc", name)).read()
        assert '#include "k4_owned.cuh"' in src and "weighted_runs.cuh\"" not in src
        assert "int route" not in src and "int span" in src
    assert kernels.k4_units(n_chunks, 256) == n_chunks


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """K4's sources include k4_owned.cuh and K5's weighted_runs.cuh: an
    edit of a header alone must give its kernels a new library path, so
    they are rebuilt."""
    from rgcn_tpu_torch.kernels import build

    for name in ("k4_weighted_aggregate.cu", "k4_owned.cuh",
                 "k5_weighted_aggregate_dedup.cu", "weighted_runs.cuh"):
        (tmp_path / name).write_bytes(open(os.path.join(build.CSRC, name), "rb").read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    for kernel, header in (("k4_weighted_aggregate", "k4_owned.cuh"),
                           ("k5_weighted_aggregate_dedup", "weighted_runs.cuh")):
        before = build.library_path(kernel)
        with open(tmp_path / header, "a") as f:
            f.write("// edited\n")
        assert build.library_path(kernel) != before


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


def test_trace_train_gate_same_bits_on_cpu():
    """The gate's trace rehearsed on the CPU's plain versions: two runs from
    one initialisation end with the same parameter and logit bits
    (``same``), and the run under use_deterministic_algorithms reports its
    warnings (none on the CPU's path), leaving the mode as it found it. On
    the CPU the featureless layer's index backward (``index_put_`` with
    accumulate) adds in parallel in no fixed order unless deterministic
    algorithms are asked for, so the rehearsal asks for them; on the card
    that backward sorts its indices and adds in a fixed order."""
    import argparse

    from rgcn_tpu_torch import trace_train_gate as tg

    args = argparse.Namespace(config=tg.CONFIG, runs=2, poison_runs=0, epochs=1,
                              race_repeats=0, out=None, same=True)
    torch.use_deterministic_algorithms(True)
    try:
        summary = tg.trace(torch.device("cpu"), args)
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(False)
    assert summary["device"] == "cpu" and summary["same"]
    assert summary["distinct_params"] == 1 and summary["nondeterministic_ops"] == []


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
