"""Experiment configs over the repo's YAML subset.

Counterpart of ``rgcn_tpu/config.py``: node-classification and
link-prediction dataclasses and ``load_experiment``. PyYAML is not a
dependency of the port, so :func:`parse_yaml` reads the subset every file
under ``configs/`` uses:
nested ``key: scalar`` maps by indentation, ``#`` comments, and YAML 1.1
plain scalars (bool, null, int, float, string) or quoted strings.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = [
    "DatasetConfig",
    "OptimiserConfig",
    "NegativeSamplingConfig",
    "TrainingConfig",
    "DecompositionConfig",
    "EdgeDropoutConfig",
    "RGCNConfig",
    "EncoderConfig",
    "DecoderConfig",
    "EvaluationConfig",
    "NodeClassificationExperiment",
    "LinkPredictionExperiment",
    "parse_yaml",
    "load_experiment",
]


@dataclass(frozen=True)
class DatasetConfig:
    name: str
    prune: bool = False


@dataclass(frozen=True)
class OptimiserConfig:
    algorithm: str = "adam"
    weight_decay: float = 0.0
    learn_rate: float = 0.01


@dataclass(frozen=True)
class NegativeSamplingConfig:
    sampling_rate: int = 10
    head_prob: float = 0.5


@dataclass(frozen=True)
class TrainingConfig:
    epochs: int = 50
    optimiser: OptimiserConfig = OptimiserConfig()
    use_cuda: bool = False  # accepted for config compat; device is explicit
    graph_batch_size: Optional[int] = None
    sampling_method: str = "uniform"
    negative_sampling: Optional[NegativeSamplingConfig] = None


@dataclass(frozen=True)
class DecompositionConfig:
    type: str  # 'basis' | 'block'
    num_bases: int = 0
    num_blocks: int = 0


@dataclass(frozen=True)
class EdgeDropoutConfig:
    general: float = 0.0
    self_loop: float = 0.0
    self_loop_type: str = "none"


@dataclass(frozen=True)
class RGCNConfig:
    """``rgcn:`` section of node-classification configs."""

    model: str = "rgcn"  # 'rgcn' | 'e-rgcn'
    num_layers: int = 2
    hidden_size: int = 16
    node_embeddings: int = 10
    decomposition: Optional[DecompositionConfig] = None
    edge_dropout: Optional[EdgeDropoutConfig] = None
    layer1_l2_penalty: float = 0.0
    node_embedding_l2_penalty: float = 0.0


@dataclass(frozen=True)
class EncoderConfig:
    """``encoder:`` section of link-prediction configs."""

    model: str = "rgcn"  # 'rgcn' | 'c-rgcn'
    num_layers: int = 2
    node_embedding: Optional[int] = None
    hidden1_size: Optional[int] = None
    hidden2_size: Optional[int] = None
    decomposition: Optional[DecompositionConfig] = None
    edge_dropout: Optional[EdgeDropoutConfig] = None
    weight_init: str = "glorot-normal"
    include_gain: bool = False
    bias_init: Optional[str] = None
    node_embedding_l2_penalty: float = 0.0


@dataclass(frozen=True)
class DecoderConfig:
    """``decoder:`` section of link-prediction configs."""

    model: str = "distmult"
    l2_penalty_type: Optional[str] = None
    l2_penalty: float = 0.0
    weight_init: str = "standard-normal"
    include_gain: bool = False
    bias_init: Optional[str] = None
    bwd_dtype: Optional[str] = None  # the training backward's table dtype


@dataclass(frozen=True)
class EvaluationConfig:
    final_run: bool = False
    filtered: bool = False
    check_every: int = 2000
    batch_size: int = 16
    verbose: bool = False


@dataclass(frozen=True)
class NodeClassificationExperiment:
    dataset: DatasetConfig
    training: TrainingConfig
    rgcn: RGCNConfig
    evaluation: EvaluationConfig
    repeats: int = 1


@dataclass(frozen=True)
class LinkPredictionExperiment:
    dataset: DatasetConfig
    training: TrainingConfig
    encoder: EncoderConfig
    decoder: DecoderConfig
    evaluation: EvaluationConfig

    def structured_decoder_ok(self, pallas: bool) -> bool:
        """Does the structured-negatives decoder (3P+Ns query gathers, the
        scatter-free backward: ``ops/distmult_train.py``) apply? Bias-free
        scoring with a Schlichtkrull-or-off L2, on the kernel path
        (``pallas``: the JAX package's name for it)."""
        return (
            pallas
            and self.decoder.bias_init is None
            and (self.decoder.l2_penalty == 0.0
                 or self.decoder.l2_penalty_type == "schlichtkrull-l2")
        )


# --------------------------------------------------------------------------
# YAML subset reader
# --------------------------------------------------------------------------

# PyYAML's SafeLoader implicit resolvers (YAML 1.1), restricted to the forms
# a config can hold: decimal ints, decimal floats, .inf/.nan.
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                         "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF")},
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _scalar(text: str, lineno: int):
    if text[:1] in ("'", '"'):
        q = text[0]
        if len(text) < 2 or text[-1] != q:
            raise ValueError(f"line {lineno}: unterminated quoted scalar")
        body = text[1:-1]
        return body.replace("''", "'") if q == "'" else body
    if text[0] in "[{&*!|>" or text.startswith("- "):
        raise ValueError(
            f"line {lineno}: {text!r} is outside the supported YAML subset"
        )
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    m = _INF.match(text)
    if m:
        return float(f"{m.group(1)}inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse nested ``key: scalar`` maps (the subset of ``configs/``).

    A key with nothing after the colon opens a nested map when the next
    line is indented deeper, else it is null — as ``yaml.safe_load`` reads
    it. Anything else (lists, flow collections, anchors, multi-line
    scalars) raises ``ValueError`` naming the line.
    """
    root: Dict[str, Any] = {}
    stack = [(0, root)]  # (indent, map) from the root down
    pending = None  # (indent, parent map, key) of a key with no value yet
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"line {lineno}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                child: Dict[str, Any] = {}
                p_map[p_key] = child
                stack.append((indent, child))
        while stack[-1][0] > indent:
            stack.pop()
        top_indent, top = stack[-1]
        if top_indent != indent:
            raise ValueError(f"line {lineno}: inconsistent indentation")
        m = re.match(r"([^:#'\"\s][^:]*?)\s*:(?:\s+(.*))?$", body)
        if m is None:
            raise ValueError(
                f"line {lineno}: {body!r} is not a 'key: value' line"
            )
        key, value = m.group(1), (m.group(2) or "").strip()
        if key in top:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        if value:
            top[key] = _scalar(value, lineno)
        else:
            top[key] = None
            pending = (indent, top, key)
    return root


# --------------------------------------------------------------------------


def _build(cls, raw: Optional[Dict[str, Any]]):
    """Construct a (possibly nested) config dataclass from a raw dict,
    ignoring unknown keys."""
    raw = dict(raw or {})
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        v = raw.pop(f.name)
        if f.name == "optimiser":
            v = _build(OptimiserConfig, v)
        elif f.name == "negative_sampling":
            v = _build(NegativeSamplingConfig, v) if v is not None else None
        elif f.name == "decomposition":
            v = _build(DecompositionConfig, v) if v is not None else None
        elif f.name == "edge_dropout":
            v = _build(EdgeDropoutConfig, v) if v is not None else None
        kwargs[f.name] = v
    return cls(**kwargs)


def tool_config(ap, flag: str, path: str) -> str:
    """``path``, a tool's config file, when it exists; else the tool's
    argument parser ``ap`` exits naming ``flag`` and the missing path. The
    tools default to files under a checkout's ``configs/``, which an
    installed copy of the package does not hold."""
    if not os.path.isfile(path):
        ap.error(f"{flag}: config file {path} not found (the default lies in a "
                 f"checkout's configs/, which an installed copy lacks); pass "
                 f"{flag} with a config file")
    return path


def load_experiment(path_or_dict):
    """Load a YAML config file (or raw dict) into the right experiment
    type: NC configs have an ``rgcn`` section, LP configs
    ``encoder``/``decoder``."""
    if isinstance(path_or_dict, dict):
        raw = path_or_dict
    else:
        with open(path_or_dict, "r") as f:
            raw = parse_yaml(f.read())

    dataset = _build(DatasetConfig, raw.get("dataset"))
    training = _build(TrainingConfig, raw.get("training"))
    evaluation = _build(EvaluationConfig, raw.get("evaluation"))
    if "rgcn" in raw:
        return NodeClassificationExperiment(
            dataset=dataset,
            training=training,
            rgcn=_build(RGCNConfig, raw.get("rgcn")),
            evaluation=evaluation,
            repeats=int(raw.get("repeats", 1)),
        )
    if "encoder" in raw:
        return LinkPredictionExperiment(
            dataset=dataset,
            training=training,
            encoder=_build(EncoderConfig, raw.get("encoder")),
            decoder=_build(DecoderConfig, raw.get("decoder")),
            evaluation=evaluation,
        )
    raise ValueError(
        "config must contain an 'rgcn' (node classification) or 'encoder' "
        "(link prediction) section"
    )
