"""The port's YAML-subset reader and NC configs against PyYAML and
``rgcn_tpu.config``."""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from rgcn_tpu import config as jcfg
from rgcn_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                           recursive=True))
NC_CONFIGS = [p for p in CONFIGS if os.path.basename(p).startswith("nc-")]
LP_CONFIGS = [p for p in CONFIGS if os.path.basename(p).startswith("lp-")]


def _id(path):
    return os.path.relpath(path, os.path.join(ROOT, "configs"))


def test_config_count():
    assert len(CONFIGS) == 12 and len(NC_CONFIGS) == 8


@pytest.mark.parametrize("path", CONFIGS, ids=_id)
def test_reader_equals_safe_load(path):
    text = open(path).read()
    assert tcfg.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", NC_CONFIGS, ids=_id)
def test_nc_experiment_equals_jax(path):
    got = tcfg.load_experiment(path)
    want = jcfg.load_experiment(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("path", LP_CONFIGS, ids=_id)
def test_lp_configs_wait_for_lp_slice(path):
    """The LP slice has landed: every LP config (rgcn/ and c-rgcn/) loads
    into the same LinkPredictionExperiment as the JAX package's."""
    got = tcfg.load_experiment(path)
    want = jcfg.load_experiment(path)
    assert isinstance(got, tcfg.LinkPredictionExperiment)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


SNIPPETS = [
    "a: 1\nb: -2\nc: 0\nd: 1_000\n",
    "a: 1.5\nb: -0.25\nc: 1.0e-3\nd: 1e-3\ne: .5\nf: 3.\n",
    "a: true\nb: False\nc: yes\nd: off\ne: null\nf: ~\ng:\n",
    "a: 'quoted # not a comment'\nb: \"double\"\nc: plain text  # comment\n",
    "# header\nouter:\n  inner:\n    leaf: x\n  sib: 2\nnext: 3\n",
    "a: .inf\nb: -.inf\nc: it's\nd: schlichtkrull-dropout\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_reader_scalars_equal_safe_load(text):
    got, want = tcfg.parse_yaml(text), yaml.safe_load(text)
    assert got == want
    for k, v in want.items():
        assert type(got[k]) is type(v), k


def test_reader_nan():
    assert math.isnan(tcfg.parse_yaml("a: .nan\n")["a"])


@pytest.mark.parametrize(
    "text", ["a:\n  - 1\n  - 2\n", "a: [1, 2]\n", "a: {b: 1}\n",
             "a: 1\n   b: 2\n", "a: 1\na: 2\n", "just text\n"],
)
def test_reader_rejects_outside_subset(text):
    with pytest.raises(ValueError, match="line"):
        tcfg.parse_yaml(text)


def test_load_experiment_from_dict_and_errors():
    cfg = tcfg.load_experiment({"dataset": {"name": "AIFB"},
                                "rgcn": {"hidden_size": 8}})
    assert cfg.rgcn.hidden_size == 8 and cfg.training.epochs == 50
    with pytest.raises(ValueError, match="rgcn"):
        tcfg.load_experiment({"dataset": {"name": "x"}})
