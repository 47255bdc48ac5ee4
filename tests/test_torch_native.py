"""The port's native host builders (rgcn_tpu_torch/native/csrc, built with
g++ at first use) against its numpy builders and the JAX package's numpy
builders, bit for bit; the N-Triples parser against both Python scanners;
the dispatch reaching the LP epoch and the loaders; no fallback."""

import ctypes
import dataclasses
import gzip
import os
import re

import numpy as np
import pytest
import torch

from rgcn_tpu.data.nt import iter_nt_file as j_iter_nt_file
from rgcn_tpu.graph import dynamic as jdyn
from rgcn_tpu.graph import structure as jstruct
from rgcn_tpu.ops import pallas_aggregate as jagg
from rgcn_tpu.ops import pallas_distmult as jdm
from rgcn_tpu_torch import native
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.loaders import _parse_graph
from rgcn_tpu_torch.data.native_nt import parse_nt_native
from rgcn_tpu_torch.data.synthetic import synthetic_link_prediction
from rgcn_tpu_torch.graph import dynamic as tdyn
from rgcn_tpu_torch.graph.native import (
    build_dst_layout_native,
    build_edge_set_native,
    lexsort_rel_dst,
)
from rgcn_tpu_torch.graph.structure import build_edge_set
from rgcn_tpu_torch.ops import distmult_train as tdm
from rgcn_tpu_torch.ops.aggregate import build_dst_layout
from rgcn_tpu_torch.profile_epoch import StagedTrainer, batch_differences
from rgcn_tpu_torch.train.link_prediction import EPOCH_STAGES, LinkPredictionTrainer
from rgcn_tpu_torch.utils.logging import ScalarLogger
from tests.conftest import make_random_triples
from tests.test_torch_graph import _eq_edge_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIBRARY = os.path.join(ROOT, "native", "librgcn_native.so")


def _same(got, want):
    assert batch_differences(got, want) == []


def _same_layout_as_jax(got, want):
    for f in ("perm", "local_dst", "chunk_block"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("num_row_blocks", "row_block", "chunk"):
        assert getattr(got, f) == getattr(want, f), f


# -- the destination layout's counting sort ------------------------------------


@pytest.mark.parametrize("case", range(25))
def test_dst_layout_native_bit_equal(case):
    rng = np.random.default_rng(41 + case)
    n = int(rng.integers(5, 2500))
    e = int(rng.integers(0, 6000))
    rb = int(rng.choice([8, 64, 128, 256]))
    ch = int(rng.choice([16, 128, 256]))
    dst = rng.integers(0, n + 1, e).astype(np.int32)  # pads == n included
    base = build_dst_layout(dst, n, rb, ch, prefer_native=False)
    pad_to = base.perm.shape[0] + int(rng.integers(0, 4)) * ch
    for pad in (None, pad_to):
        want = build_dst_layout(dst, n, rb, ch, pad_to=pad, prefer_native=False)
        got = build_dst_layout(dst, n, rb, ch, pad_to=pad)
        _same(got, want)
        _same(build_dst_layout_native(dst.astype(np.int64), n, rb, ch, pad), want)
        _same_layout_as_jax(got, jagg.build_dst_layout(dst, n, rb, ch, pad_to=pad,
                                                       prefer_native=False))


@pytest.mark.parametrize("pad_to", [17, 0, 16])
def test_dst_layout_rejects_bad_pad_to(pad_to):
    dst = np.arange(100, dtype=np.int32) % 50
    with pytest.raises(ValueError, match=f"pad_to={pad_to} < layout total"):
        build_dst_layout(dst, 50, 8, 16, pad_to=pad_to)
    with pytest.raises(ValueError, match=f"pad_to={pad_to} < layout total"):
        build_dst_layout(dst, 50, 8, 16, pad_to=pad_to, prefer_native=False)


def test_lexsort_rel_dst_bit_equal_with_pads():
    rng = np.random.default_rng(43)
    for _ in range(25):
        e = int(rng.integers(0, 5000))
        nr = int(rng.integers(1, 40))
        n = int(rng.integers(1, 3000))
        rel = rng.integers(0, nr, e)
        dst = rng.integers(0, n + 1, e)  # the pad value n included
        order = lexsort_rel_dst(rel, dst, nr, n + 1)
        np.testing.assert_array_equal(order, np.lexsort((dst, rel)))
        np.testing.assert_array_equal(tdyn._lexsort_rel_dst(rel, dst, nr, n),
                                      tdyn._lexsort_rel_dst(rel, dst, nr, n, False))
    with pytest.raises(ValueError, match="outside"):
        lexsort_rel_dst(np.array([5]), np.array([0]), 3, 10)
    with pytest.raises(ValueError, match="outside"):
        lexsort_rel_dst(np.array([0]), np.array([10]), 3, 10)


# -- the static edge set -------------------------------------------------------


def _triples(kind):
    rng = np.random.default_rng(70)
    if kind == "last_relation_empty":
        t = make_random_triples(rng, 60, 6, 300)
        return t[t[:, 1] != 5], 60, 6
    if kind == "several_row_blocks":
        return make_random_triples(rng, 1400, 5, 5000), 1400, 5
    return make_random_triples(rng, 90, 7, 400), 90, 7


@pytest.mark.parametrize("kind", ["last_relation_empty", "several_row_blocks", "plain"])
@pytest.mark.parametrize("tile_size", [8, 128])
@pytest.mark.parametrize("tile_multiple", [1, 3])
def test_edge_set_native_bit_equal(kind, tile_size, tile_multiple):
    t, n, r = _triples(kind)
    kw = dict(tile_size=tile_size, tile_multiple=tile_multiple)
    for layouts in (dict(), dict(with_dst_layout=True),
                    dict(with_dst_layout=True, layout_row_block=64)):
        want = build_edge_set(t, n, r, prefer_native=False, **kw, **layouts)
        got = build_edge_set(t, n, r, **kw, **layouts)
        _same(got, want)  # every field: layout, reverse, fused, theirs
        if layouts:
            assert got.reverse.layout is not None and got.reverse.fused is not None
        jax_es = jstruct.build_edge_set(t, n, r, prefer_native=False, **kw, **layouts)
        if layouts:
            _eq_edge_set(got, jax_es)
            _eq_edge_set(got.reverse, jax_es.reverse, "es.reverse")
        else:
            for f in ("src", "dst", "rel", "val", "tile_rel"):
                np.testing.assert_array_equal(getattr(got, f), getattr(jax_es, f))


def test_edge_set_native_merged_and_pairs_attach():
    t, n, r = _triples("plain")
    kw = dict(with_dst_layout=True, with_merged_layout=True, with_pair_index=True,
              with_pair_agg=True)
    _same(build_edge_set(t, n, r, **kw), build_edge_set(t, n, r, prefer_native=False, **kw))


def test_edge_set_native_rejects_out_of_range_ids():
    t = np.array([[0, 0, 1], [2, 3, 1]])
    with pytest.raises(ValueError, match="outside"):
        build_edge_set_native(t, 3, 3)  # relation 3 of 3
    with pytest.raises(ValueError, match="outside"):
        build_edge_set_native(t, 2, 4)  # node 2 of 2


# -- the LP epoch's host build and training ------------------------------------


def _small_lp(name="lp-WN18", epochs=2):
    cfg = load_experiment(os.path.join(ROOT, "configs", "rgcn", f"{name}.yaml"))
    enc = cfg.encoder
    decomp = (dataclasses.replace(enc.decomposition, num_blocks=2)
              if enc.decomposition.type == "block" else enc.decomposition)
    enc = dataclasses.replace(
        enc, node_embedding=8, hidden1_size=8, decomposition=decomp,
        edge_dropout=dataclasses.replace(enc.edge_dropout, general=0.3))
    tr = dataclasses.replace(
        cfg.training, epochs=epochs, graph_batch_size=48,
        negative_sampling=dataclasses.replace(cfg.training.negative_sampling,
                                              sampling_rate=3))
    ev = dataclasses.replace(cfg.evaluation, check_every=100, batch_size=16,
                             verbose=False)
    return dataclasses.replace(cfg, encoder=enc, training=tr, evaluation=ev)


@pytest.mark.parametrize("mode", ["keep_mask", "dropout_rng"])
def test_dynamic_host_builder_native_bit_equal(mode):
    n, r, b = 200, 4, 500
    pos = make_random_triples(np.random.default_rng(9), n, r, b)
    kw = dict(tile_size=16, with_dst_layout=True, row_block=64, layout_chunk=32)
    if mode == "keep_mask":
        kws = [dict(kw, keep_mask=np.random.default_rng(5).random(b) < 0.6)
               for _ in range(3)]
    else:
        kws = [dict(kw, dropout_rate=0.4, dropout_rng=np.random.default_rng((3, 1, 7)))
               for _ in range(3)]
    got = tdyn.build_edge_set_dynamic_host(pos, n, r, **kws[0])
    _same(got, tdyn.build_edge_set_dynamic_host(pos, n, r, prefer_native=False, **kws[1]))
    want = jdyn.build_edge_set_dynamic_host(pos, n, r, **kws[2])
    for g, w in ((got, want), (got.reverse, want.reverse)):
        for f in ("src", "dst", "rel", "val", "tile_rel"):
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f)))
        _same_layout_as_jax(g.layout, w.layout)


def test_structured_layouts_native_bit_equal():
    rng = np.random.default_rng(12)
    n, p, ns = 300, 64, 640
    pos = make_random_triples(rng, n, 5, p)
    ch = rng.random(ns) < 0.5
    ce = rng.integers(0, n, ns)
    got = tdm.build_structured_layouts(pos, ce, ch, n, row_block=64, chunk=32)
    _same(got, tdm.build_structured_layouts(pos, ce, ch, n, row_block=64, chunk=32,
                                            prefer_native=False))
    want = jdm.build_structured_layouts(pos, ce, n, row_block=64, chunk=32,
                                        sorted_corrupt=True, corrupt_head=ch)
    for g, w in zip(got[:3], want[:3]):
        _same_layout_as_jax(g, w)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("name", ["lp-WN18", "lp-FB-toy"])
def test_sample_epoch_native_equals_numpy(name):
    data = synthetic_link_prediction(num_nodes=60, num_rels=3, num_edges=320)
    trainer = LinkPredictionTrainer(_small_lp(name), data, device="cpu")
    native.reset_calls()
    times = {}
    batch = trainer.sample_epoch(3, times=times)
    # a subgraph: the forward and the reverse sort, their two layouts, and
    # the three structured layouts, all native
    assert native.CALLS == {"build_edge_set": 0, "build_dst_layout": 5,
                            "lexsort_rel_dst": 2, "parse_nt": 0}
    assert tuple(times) == EPOCH_STAGES and all(t >= 0 for t in times.values())
    native.reset_calls()
    _same(trainer.sample_epoch(3, prefer_native=False), batch)
    assert sum(native.CALLS.values()) == 0
    # the stages compose what the composed builders give
    pos, n = batch.positives, trainer.num_nodes
    whole = tdyn.build_edge_set_dynamic_host(
        pos, n, trainer.num_rels, tile_size=trainer.tile_size,
        dropout_rate=trainer.general_dropout,
        dropout_rng=np.random.default_rng((trainer.seed, 3, 7)), with_dst_layout=True,
        row_block=tdyn.auto_layout_row_block(n, 2 * len(pos)))
    _same(batch.edges, whole)
    _same(batch.layouts, tdm.build_structured_layouts(
        pos, batch.corrupt_ent, batch.corrupt_head, n, row_block=512, chunk=256))


def _losses(rec):
    return [v for m, _, v in rec if m == "training.loss"]


class _Records(ScalarLogger):
    def __init__(self):
        super().__init__(verbose=False)
        self.records = []

    def log_scalar(self, metric, value, step=None):
        self.records.append((metric, step, float(value)))


@pytest.mark.parametrize("name", ["lp-WN18", "lp-FB-toy"])
def test_training_native_equals_numpy(name):
    """Two LP epochs on the CPU: the trainer (native builders) and the
    numpy builders give bit-identical losses and ranks."""
    data = synthetic_link_prediction(num_nodes=60, num_rels=3, num_edges=320)
    cfg = _small_lp(name)
    ways = []
    for trainer in (LinkPredictionTrainer(cfg, data, device="cpu"),
                    StagedTrainer(cfg, data, device="cpu", prefer_native=False)):
        rec = _Records()
        mrr, _, ranks = trainer.fit(rec)
        ways.append((_losses(rec.records), mrr, ranks))
    (l_nat, m_nat, r_nat), (l_np, m_np, r_np) = ways
    assert len(l_nat) == 2 and l_nat == l_np
    assert m_nat == m_np
    np.testing.assert_array_equal(r_nat, r_np)


def test_trainer_path_native_counts():
    """Construction builds the evaluation graph natively (the edge set, the
    reverse sort, the forward and reverse layouts and the merged frame's
    two); each epoch two lexsorts and five layouts."""
    data = synthetic_link_prediction(num_nodes=60, num_rels=3, num_edges=320)
    native.reset_calls()
    trainer = LinkPredictionTrainer(_small_lp("lp-WN18", epochs=3), data, device="cpu")
    assert trainer.eval_edges.merged is not None
    assert native.CALLS == {"build_edge_set": 1, "build_dst_layout": 4,
                            "lexsort_rel_dst": 1, "parse_nt": 0}
    native.reset_calls()
    trainer.fit(_Records())
    assert native.CALLS == {"build_edge_set": 0, "build_dst_layout": 5 * 3,
                            "lexsort_rel_dst": 2 * 3, "parse_nt": 0}


# -- the N-Triples parser ----------------------------------------------------------

NT_LINES = [
    "<http://a/s1> <http://p/r1> <http://a/o1> .",
    '<http://a/s1> <http://p/r2> "plain literal" .',
    '<http://a/s2> <http://p/r2> "esc \\"q\\" lit"^^<http://t/int> .',
    '<http://a/s2> <http://p/r1> "hallo"@de .',
    '<http://a/s3>\t<http://p/r2>\t"tab \\\\ back"@en-GB .',
    "_:b0 <http://p/r3> _:b1 .",
    "# a comment line",
    "",
    "   ",
    "  <http://a/s1> <http://p/r3> _:b0 .",
    '<http://a/s3> <http://p/r1> "ünïcødé ☃" .',
    "<http://a/s3> <http://p/r3> <http://a/" + "x" * 70000 + "> .",
]


def _write(path, lines, gz=True):
    with (gzip.open if gz else open)(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("gz", [True, False])
def test_nt_parser_matches_both_scanners(tmp_path, gz):
    path = _write(tmp_path / ("g.nt.gz" if gz else "g.nt"), NT_LINES, gz)
    native.reset_calls()
    spo, nodes, rels = parse_nt_native(path)
    assert native.CALLS["parse_nt"] == 1
    py_spo, py_nodes, py_rels = _parse_graph(path, prefer_native=False)
    assert spo.dtype == py_spo.dtype == np.int64
    np.testing.assert_array_equal(spo, py_spo)
    assert (nodes, rels) == (py_nodes, py_rels)
    # the JAX package's scanner: the same terms under sorted-vocabulary ids
    jt = list(j_iter_nt_file(path))
    assert nodes == sorted({t[0] for t in jt} | {t[2] for t in jt})
    assert rels == sorted({t[1] for t in jt})
    n2i, r2i = {x: i for i, x in enumerate(nodes)}, {x: i for i, x in enumerate(rels)}
    np.testing.assert_array_equal(spo, [(n2i[s], r2i[p], n2i[o]) for s, p, o in jt])
    assert '"esc \\"q\\" lit"^^<http://t/int>' in nodes and "_:b1" in nodes
    _same(_parse_graph(path), (spo, nodes, rels))


@pytest.mark.parametrize("bad", ["<http://a/s1> <http://p/r1>",
                                 "<http://a/s1> <http://p/r1> <http://a/o1",
                                 "plain words here ."])
def test_nt_parser_rejects_malformed_line(tmp_path, bad):
    path = _write(tmp_path / "bad.nt.gz", NT_LINES[:2] + [bad])
    with pytest.raises(ValueError):
        parse_nt_native(path)
    with pytest.raises(ValueError):
        _parse_graph(path, prefer_native=False)


def test_nt_parser_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_nt_native(str(tmp_path / "absent.nt.gz"))


# -- the build, the binding and the boundary -----------------------------------


def test_signatures_match_the_sources():
    """Every bound function exists in its library with the C source's
    parameter count (a mismatch would pass wrong arguments silently)."""
    for lib_name, fns in native.SIGNATURES.items():
        sources, _ = native.LIBRARIES[lib_name]
        text = re.sub(r"//[^\n]*", "", "".join(
            open(os.path.join(native.CSRC, s)).read() for s in sources))
        lib = native.load(lib_name)
        for fn, (_, argtypes) in fns.items():
            m = re.search(rf"\b{fn}\(([^)]*)\)\s*{{", text)
            assert m, fn
            params = [p for p in m.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), fn
            # a CDLL function releases the GIL for the call
            assert not getattr(lib, fn)._flags_ & ctypes._FUNCFLAG_PYTHONAPI, fn


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "csrc"
    bad.mkdir()
    for src in ("graph_builder.cc", "layout_builder.cc", "nt_parser.cc"):
        (bad / src).write_text("int broken( {\n")
    monkeypatch.setattr(native, "CSRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"host builder build failed:[\s\S]*error"):
        native.build_all(["host_builders"])
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_libraries_are_the_ports_and_not_the_jax_one():
    for name in native.LIBRARIES:
        path = native.load(name)._name
        assert os.path.dirname(path) == native.BUILD_DIR
        assert os.path.basename(path).startswith(name + "-")
    with open("/proc/self/maps") as f:
        assert "librgcn_native" not in f.read()
    assert not os.path.exists(JAX_LIBRARY)


def test_cpu_tensor_paths_untouched():
    """The builders feed numpy arrays; EdgeSet.to moves them as before."""
    t, n, r = _triples("plain")
    es = build_edge_set(t, n, r, with_dst_layout=True).to("cpu")
    assert isinstance(es.src, torch.Tensor) and es.layout.perm.dtype == torch.int32
