"""The four CLIs on the CPU over dataset files on disk (``--data-root``)
with checkpoints (``--checkpoint-dir``): a training run writes its
``step_*`` directories, a second run resumes after the last, and the
serving CLI answers from the checkpoint as a server built from it does."""

import gzip
import os

import numpy as np
import pytest

from rgcn_tpu_torch import classify_nodes, predict_links, serve_links, serve_nodes
from rgcn_tpu_torch.config import load_experiment
from rgcn_tpu_torch.data.loaders import load_link_prediction, load_node_classification
from rgcn_tpu_torch.serve import load_lp_server, load_nc_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC_CFG = os.path.join(ROOT, "configs", "rgcn", "nc-AIFB.yaml")
LP_CFG = os.path.join(ROOT, "configs", "rgcn", "lp-WN18.yaml")


def _write_aifb(root):
    d = os.path.join(str(root), "aifb")
    os.makedirs(d)
    people = [f"http://ex/person{i}" for i in range(12)]
    lines = []
    for i in range(12):
        lines.append(f"<{people[i]}> <http://ex/knows> <{people[(i + 1) % 12]}> .")
        lines.append(f"<{people[i]}> <http://ex/affil> <http://ex/group{i % 3}> .")
    with gzip.open(os.path.join(d, "aifb_stripped.nt.gz"), "wt") as f:
        f.write("\n".join(lines) + "\n")
    for name, rows in (("trainingSet.tsv", range(9)), ("testSet.tsv", range(9, 12))):
        with open(os.path.join(d, name), "w") as f:
            f.write("person\tlabel_affiliation\n")
            for i in rows:
                f.write(f"{people[i]}\thttp://ex/group{i % 3}\n")


def _write_wn18(root):
    d = os.path.join(str(root), "wn18")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    rows = {(int(s), int(p), int(o)) for s, p, o in zip(
        rng.integers(0, 30, 150), rng.integers(0, 4, 150), rng.integers(0, 30, 150))}
    rows = sorted(rows)
    for name, part in (("train.txt", rows[:-20]), ("valid.txt", rows[-20:-10]),
                       ("test.txt", rows[-10:])):
        with open(os.path.join(d, name), "w") as f:
            for s, p, o in part:
                f.write(f"{s:08d}\t_rel{p}\t{o:08d}\n")


def _steps(ck):
    return sorted(os.listdir(ck))


def test_classify_then_serve_nodes_from_files(tmp_path, capsys):
    _write_aifb(tmp_path)
    root, ck = str(tmp_path), str(tmp_path / "ck")
    args = ["--config", NC_CFG, "--data-root", root, "--cpu", "--tile-size", "16",
            "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    classify_nodes.main(args + ["--epochs", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[data] AIFB: N=15 R=2 E=24 train=9 test=3")
    assert _steps(ck) == ["step_00000002", "step_00000003"]
    assert not any("resumed" in line for line in out)

    classify_nodes.main(args + ["--epochs", "5"])
    out = capsys.readouterr().out.splitlines()
    assert "resumed from checkpoint at epoch 3" in out
    assert [ln.split("]")[0] for ln in out if ln.startswith("[Epoch")] == \
        ["[Epoch 4", "[Epoch 5"]
    assert _steps(ck) == ["step_00000002", "step_00000003", "step_00000004",
                          "step_00000005"]

    serve_nodes.main(["--config", NC_CFG, "--data-root", root, "--cpu",
                      "--checkpoint-dir", ck, "--nodes", "http://ex/person9", "10"])
    out = capsys.readouterr().out.splitlines()
    data = load_node_classification("AIFB", final_run=True, data_root=root)
    srv = load_nc_server(load_experiment(NC_CFG), data, checkpoint_dir=ck, device="cpu")
    ids = [data.n2i["http://ex/person9"], 10]
    want = srv.classify(ids)
    assert out == [f"{data.i2n[i]}: class {c} (p={p[c]:.3f})"
                   for i, c, p in zip(ids, want, srv.probabilities(ids))]

    with pytest.raises(SystemExit):  # an empty checkpoint directory
        serve_nodes.main(["--config", NC_CFG, "--data-root", root, "--cpu",
                          "--checkpoint-dir", str(tmp_path / "none")])
    assert "no checkpoint found" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # no dataset files there
        classify_nodes.main(["--config", NC_CFG, "--data-root", str(tmp_path / "x"),
                             "--cpu"])
    assert "dataset file not found" in capsys.readouterr().err


def test_predict_then_serve_links_from_files(tmp_path, capsys):
    _write_wn18(tmp_path)
    root, ck = str(tmp_path), str(tmp_path / "ck")
    args = ["--config", LP_CFG, "--data-root", root, "--cpu", "--tile-size", "16",
            "--checkpoint-dir", ck, "--checkpoint-every", "1"]
    predict_links.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out.splitlines()
    data = load_link_prediction("WN18", final_run=True, data_root=root)
    assert out[0] == (f"[data] WN18: N={data.num_nodes} R=4 train={len(data.train)} "
                      "test=10")
    assert _steps(ck) == ["step_00000001", "step_00000002"]
    assert out[-1].startswith("[Final Scores] Total Epoch 2 MRR(filtered): ")

    predict_links.main(args + ["--epochs", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "resumed from checkpoint at epoch 2" in out
    assert [ln.split("]")[0] for ln in out if ln.startswith("[Epoch")] == ["[Epoch 3"]
    assert _steps(ck)[-1] == "step_00000003"

    q = tmp_path / "q.tsv"
    q.write_text(f"{data.i2n[0]} _rel1 ?\n? _rel2 {data.i2n[3]}\n")
    serve_links.main(["--config", LP_CFG, "--data-root", root, "--cpu",
                      "--checkpoint-dir", ck, "--queries", str(q), "--topk", "3",
                      "--filtered"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[serve] encoded {data.num_nodes} nodes")
    srv = load_lp_server(load_experiment(LP_CFG), data, checkpoint_dir=ck, device="cpu")
    _, tails = srv.topk_tails(np.array([[0, 1]]), k=3, filtered=True)
    _, heads = srv.topk_heads(np.array([[2, 3]]), k=3, filtered=True)
    assert out[1].startswith("tails (0, 1): ") and out[2].startswith("heads (2, 3): ")
    assert [e.split(":")[0] for e in out[1].split(": ", 1)[1].split(", ")] == \
        [data.i2n[e] for e in tails[0]]
    assert [e.split(":")[0] for e in out[2].split(": ", 1)[1].split(", ")] == \
        [data.i2n[e] for e in heads[0]]

    with pytest.raises(SystemExit):
        serve_links.main(["--config", LP_CFG, "--data-root", root, "--cpu",
                          "--checkpoint-dir", str(tmp_path / "none")])
    assert "no checkpoint found" in capsys.readouterr().err
