"""The port's dataset loaders against the JAX package's on the same fixture
files (``tests/test_loaders.py``, whose fixtures these are): N-Triples
parsing, the NC registry (every dataset's file names and headers), splits,
class coding, prune, ``limit`` with ``.rest``, the cache, the LP loader;
then integer labels of different digit lengths (pandas types such a column
as integers, so they sort as numbers), the JAX package's cache pickle left
unread, and the CLIs' dispatch. Loaders are deterministic, so every
comparison is exact.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from rgcn_tpu.data import loaders as jl
from rgcn_tpu.data.nt import parse_nt_line as j_parse
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data import dispatch
from rgcn_tpu_torch.data import loaders as tl
from rgcn_tpu_torch.data.nt import parse_nt_line, read_nt_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# dataset -> (directory, train file, test file, node header, label header)
NC_FILES = {
    "aifb": ("aifb", "trainingSet.tsv", "testSet.tsv", "person", "label_affiliation"),
    "am": ("am", "trainingSet.tsv", "testSet.tsv", "proxy", "label_cateogory"),
    "bgs": ("bgs", "trainingSet(lith).tsv", "testSet(lith).tsv", "rock",
            "label_lithogenesis"),
    "mutag": ("mutag", "trainingSet.tsv", "testSet.tsv", "bond", "label_mutagenic"),
}


def _write_nc_dataset(root, name="aifb", labels=None):
    """The fixture of tests/test_loaders.py under ``name``'s file names and
    headers; ``labels`` replaces the label of person i (default g{i%2})."""
    d, train_f, test_f, node_h, label_h = NC_FILES[name]
    d = os.path.join(str(root), d)
    os.makedirs(d)
    people = [f"http://ex/person{i}" for i in range(10)]
    lines = []
    for i in range(10):
        lines.append(f"<{people[i]}> <http://ex/knows> <{people[(i+1)%10]}> .")
        lines.append(f"<{people[i]}> <http://ex/affil> <http://ex/group{i%2}> .")
    lines.append('<http://ex/person3> <http://ex/name> "Per \\"3\\""@en .')
    # an unrelated far-away component (pruned at depth 2 from labels)
    lines.append("<http://ex/far1> <http://ex/knows> <http://ex/far2> .")
    with gzip.open(os.path.join(d, f"{name}_stripped.nt.gz"), "wt") as f:
        f.write("\n".join(lines) + "\n")
    labels = labels or [f"g{i%2}" for i in range(10)]

    def tsv(path, rows):
        with open(path, "w") as f:
            f.write(f"{node_h}\t{label_h}\n")
            for n, lab in rows:
                f.write(f"{n}\t{lab}\n")

    tsv(os.path.join(d, train_f), [(people[i], labels[i]) for i in range(8)])
    tsv(os.path.join(d, test_f), [(people[i], labels[i]) for i in range(8, 10)])


def _same_nc(a, b):
    np.testing.assert_array_equal(a.triples, b.triples)
    assert a.triples.dtype == b.triples.dtype == np.int64
    assert (a.n2i, a.i2n, a.r2i, a.i2r) == (b.n2i, b.i2n, b.r2i, b.i2r)
    assert a.train == b.train and a.test == b.test
    assert list(a.train) == list(b.train) and list(a.test) == list(b.test)
    assert a.num_classes == b.num_classes and a.class_values == b.class_values
    for split in ("train", "test"):
        for x, y in zip(a.index_labels(getattr(a, split)),
                        b.index_labels(getattr(b, split))):
            np.testing.assert_array_equal(x, y)


def _both_nc(root, **kw):
    kw.setdefault("enable_cache", False)
    return (tl.load_node_classification(data_root=str(root), **kw),
            jl.load_node_classification(data_root=str(root), **kw))


def test_parse_nt_terms(tmp_path):
    lines = ['<http://a/x> <http://p/rel> "lit with \\"q\\""^^<http://t> .',
             "_:b0 <http://p> <http://a/y> .",
             '<http://a> <http://p> "hello"@en .', "# comment", ""]
    for line in lines:
        assert parse_nt_line(line) == j_parse(line)
    s, p, o = parse_nt_line(lines[0])
    assert s == "http://a/x" and p == "http://p/rel"
    assert o == '"lit with \\"q\\""^^<http://t>'
    assert parse_nt_line("# comment") is None and parse_nt_line("") is None
    for opener, name in ((open, "g.nt"), (gzip.open, "g.nt.gz")):
        with opener(str(tmp_path / name), "wt") as f:
            f.write("\n".join(lines) + "\n")
        assert read_nt_file(str(tmp_path / name)) == [j_parse(x) for x in lines[:3]]


@pytest.mark.parametrize("name", sorted(NC_FILES))
def test_nc_loader_final_run(tmp_path, name):
    """Every registry entry: file names (BGS's "(lith)"), headers (AM's
    "label_cateogory"), the graph file."""
    _write_nc_dataset(tmp_path, name)
    data, ref = _both_nc(tmp_path, name=name, final_run=True)
    _same_nc(data, ref)
    assert data.num_classes == 2
    assert len(data.train) == 8 and len(data.test) == 2
    idx, lbl = data.index_labels(data.train)
    assert idx.shape == lbl.shape == (8,)


def test_nc_loader_validation_split(tmp_path):
    _write_nc_dataset(tmp_path)
    data, ref = _both_nc(tmp_path, name="aifb", final_run=False)
    _same_nc(data, ref)
    # first 40% of 8 training rows become the validation-as-test split
    assert len(data.test) == 3 and len(data.train) == 5
    data, ref = _both_nc(tmp_path, name="aifb", final_run=False, val_prop=0.25)
    _same_nc(data, ref)
    assert len(data.test) == 2


def test_nc_loader_prune(tmp_path):
    _write_nc_dataset(tmp_path)
    full, _ = _both_nc(tmp_path, name="aifb", final_run=True)
    pruned, ref = _both_nc(tmp_path, name="aifb", final_run=True, prune=True)
    _same_nc(pruned, ref)
    assert len(pruned.triples) < len(full.triples)
    assert not [n for n in pruned.i2n if "far" in n]


def test_nc_loader_cache_roundtrip(tmp_path):
    _write_nc_dataset(tmp_path)
    a = tl.load_node_classification("aifb", final_run=True, data_root=str(tmp_path))
    cachefile = tmp_path / "aifb" / "cache_rgcn_tpu_torch_test.pkl"
    assert cachefile.exists()
    assert not (tmp_path / "aifb" / "cache_rgcn_tpu_test.pkl").exists()
    b = tl.load_node_classification("aifb", final_run=True, data_root=str(tmp_path))
    _same_nc(a, b)
    _same_nc(a, jl.load_node_classification("aifb", final_run=True,
                                            data_root=str(tmp_path)))
    # the cache answers without the graph: the graph file is not read again
    os.remove(tmp_path / "aifb" / "aifb_stripped.nt.gz")
    _same_nc(a, tl.load_node_classification("aifb", final_run=True,
                                            data_root=str(tmp_path)))
    # each split and prune setting has a cache file of its own
    assert not (tmp_path / "aifb" / "cache_rgcn_tpu_torch_validation.pkl").exists()


def _write_lp_dataset(root, directory="wn18"):
    d = os.path.join(str(root), directory)
    os.makedirs(d)
    rows = [(f"e{i}", f"r{i%3}", f"e{(i+1)%20}") for i in range(20)]
    for name, rs in (("train.txt", rows[:14]), ("valid.txt", rows[14:17]),
                     ("test.txt", rows[17:])):
        with open(os.path.join(d, name), "w") as f:
            for s, p, o in rs:
                f.write(f"{s}\t{p}\t{o}\n")


def _same_lp(a, b):
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(a.test, b.test)
    assert a.all_triples == b.all_triples
    assert (a.n2i, a.i2n, a.r2i, a.i2r) == (b.n2i, b.i2n, b.r2i, b.i2r)


@pytest.mark.parametrize("name,directory", [("wn18", "wn18"),
                                            ("FB15k-237", "fB15k-237")])
def test_lp_loader(tmp_path, name, directory):
    _write_lp_dataset(tmp_path, directory)
    for final_run in (False, True):
        for limit in (None, 5):
            got = tl.load_link_prediction(name, final_run=final_run, limit=limit,
                                          data_root=str(tmp_path))
            _same_lp(got, jl.load_link_prediction(name, final_run=final_run,
                                                  limit=limit,
                                                  data_root=str(tmp_path)))
    val_run = tl.load_link_prediction(name, final_run=False, data_root=str(tmp_path))
    assert len(val_run.test) == 3  # valid used as test
    final = tl.load_link_prediction(name, final_run=True, data_root=str(tmp_path))
    assert len(final.test) == 3 and len(final.train) == 14
    assert len(final.all_triples) == 20  # vocab + truth over all splits
    assert final.num_relations == 3


def test_unknown_dataset_raises(tmp_path):
    with pytest.raises(ValueError, match="could not find"):
        tl.load_node_classification("nope", data_root=str(tmp_path))
    with pytest.raises(ValueError, match="could not find"):
        tl.load_link_prediction("nope", data_root=str(tmp_path))


def test_nc_loader_relation_limit(tmp_path):
    """``limit`` keeps the most frequent relations (ties in order of first
    appearance) and buckets the rest into '.rest'; no cache."""
    _write_nc_dataset(tmp_path)
    for limit in (1, 2):
        data, ref = _both_nc(tmp_path, name="aifb", final_run=True, limit=limit)
        _same_nc(data, ref)
        assert len(data.i2r) == limit + 2 and ".rest" in data.r2i
        assert data.triples[:, 1].max() < len(data.i2r)
    assert not os.path.exists(tmp_path / "aifb" / "cache_rgcn_tpu_torch_test.pkl")


def test_nc_labels_coded_densely():
    kw = dict(triples=np.zeros((0, 3), dtype=np.int64), n2i={"a": 0, "b": 1, "c": 2},
              i2n=["a", "b", "c"], r2i={"r": 0}, i2r=["r"],
              train={"a": 1, "b": 3}, test={"c": 3})
    data, ref = tl.NodeClassificationData(**kw), jl.NodeClassificationData(**kw)
    assert data.num_classes == ref.num_classes == 2
    assert data.class_values == ref.class_values
    _, train_lbl = data.index_labels(data.train)
    _, test_lbl = data.index_labels(data.test)
    assert train_lbl.tolist() == [0, 1] and test_lbl.tolist() == [1]


@pytest.mark.parametrize("name", ["mutag", "am"])
def test_nc_integer_labels_sort_as_numbers(tmp_path, name):
    """MUTAG's and AM's labels are integers. pandas types the column as
    int64, so 9 < 10 < 100 and the class codes follow the numbers; read as
    strings "10" < "100" < "9" would code them differently."""
    labels = ["9", "10", "100", "7", "9", "10", "100", "7", "10", "9"]
    _write_nc_dataset(tmp_path, name, labels=labels)
    data, ref = _both_nc(tmp_path, name=name, final_run=True)
    _same_nc(data, ref)
    assert data.num_classes == 4
    coded = {n: c for n, c in data.train.items()}
    assert [coded[f"http://ex/person{i}"] for i in range(4)] == [1, 2, 3, 0]
    assert tl._typed_column(["-1", "+2"]) == [-1, 2]
    assert tl._typed_column(["1", "x"]) == ["1", "x"]


def test_jax_cache_pickle_is_left_unread(tmp_path):
    """With the JAX package's cache in the directory, the port neither
    reads it (here it holds garbage) nor imports rgcn_tpu."""
    _write_nc_dataset(tmp_path)
    jl.load_node_classification("aifb", final_run=True, data_root=str(tmp_path))
    jax_cache = tmp_path / "aifb" / "cache_rgcn_tpu_test.pkl"
    assert jax_cache.exists()
    jax_cache.write_bytes(b"not a pickle the port may open")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['rgcn_tpu'] = None\n"
        "from rgcn_tpu_torch.data.loaders import load_node_classification\n"
        f"d = load_node_classification('aifb', final_run=True, data_root={str(tmp_path)!r})\n"
        "bad = sorted(m for m in sys.modules if m.startswith('rgcn_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(d.train), len(d.test), d.num_classes)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["8", "2", "2"]
    assert jax_cache.read_bytes() == b"not a pickle the port may open"
    assert (tmp_path / "aifb" / "cache_rgcn_tpu_torch_test.pkl").exists()


def test_dispatch(tmp_path, capsys):
    """The CLIs' dispatch: the synthetic stand-ins with ``synthetic``, else
    the loaders with the config's ``final_run`` and ``prune``."""
    nc = load_experiment(os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml"))
    lp = load_experiment(os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml"))
    data = dispatch.load_nc_data(nc, True)
    assert data.num_nodes == 8285
    assert capsys.readouterr().out.startswith("[synthetic] AIFB-like graph: N=8285")
    data = dispatch.load_lp_data(lp, True, verbose=False)
    assert data.num_nodes == 40943 and capsys.readouterr().out == ""

    _write_nc_dataset(tmp_path)
    _write_lp_dataset(tmp_path)
    got = dispatch.load_nc_data(nc, False, data_root=str(tmp_path))
    _same_nc(got, jl.load_node_classification(
        "AIFB", final_run=nc.evaluation.final_run, prune=nc.dataset.prune,
        data_root=str(tmp_path), enable_cache=False))
    assert len(got.test) == 2  # final_run: true in nc-AIFB.yaml
    got = dispatch.load_lp_data(lp, False, data_root=str(tmp_path))
    _same_lp(got, jl.load_link_prediction("WN18", final_run=True,
                                          data_root=str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        dispatch.load_lp_data(lp, False, data_root=str(tmp_path / "empty"))
