"""The gathers around the basis Functions and the assembled-batch decoder:
the forms the port replaced against the ones it runs, on the card.

    python -m rgcn_tpu_torch.compare_gathers [--out FILE]

At AM scale (``am_like()``: N 300,000, 532 general relations, 4 bases,
width 10, the destination layout ``NodeClassificationTrainer`` builds):

* ``sorted_inputs`` over the forward and the reversed edges: per-edge
  weights ``val · comps[rel]`` gathered to slot order as ``(L, nb)`` rows
  and transposed (replaced), against the weights formed in slot order,
  basis-major (``ops/basis.py::sorted_inputs``); outputs held bit-equal;
* the featureless layer's ``d comps`` dots ``<B_b[src_e], g[dst_e]>``:
  one batched einsum over the ``(nb, E, d)`` gathered rows (replaced),
  against one basis at a time (``ops/basis.py::_slot_dots``);

at lp-WN18's assembled batch (N 40,943, width 200, 330,000 triples): the
biased decoder's row gathers, forward and backward, by advanced indexing
(replaced: its backward sorts the indices) and by ``index_select``; and two
whole training steps with the basis backward's per-slot dots in either
form, swapped in one process: lp-WN18's structured step and nc-AM's
4-basis step (``profile_serve.profile_train_step``). Each pair in the
order replaced, current, current, replaced; ops as CUDA-event ms per call
(20 calls after 5), steps as host median and device ms. Prints the card's
name and power limit, then one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from rgcn_tpu_torch.device import resolve_device

ORDER = ("replaced", "current", "current", "replaced")


def event_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Mean CUDA-event ms of ``fn()`` over ``iters`` calls back to back."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(forms: dict, timer) -> dict:
    """``{form: [timer(forms[form]) for each turn of ORDER]}``."""
    out: dict = {}
    for name in ORDER:
        out.setdefault(name, []).append(timer(forms[name]))
    return out


def per_edge_sorted_inputs(edges, comps):
    """The replaced ``sorted_inputs``: per-edge weights gathered to slot
    order as ``(L, nb)`` rows, then transposed."""
    perm = edges.layout.perm.long()
    src_z = torch.cat([edges.src, edges.src.new_zeros(1)])
    wvec = edges.val[:, None] * comps[edges.rel.long()]
    wvec_z = torch.cat([wvec, wvec.new_zeros((1, comps.shape[1]))])
    return (src_z[perm].clamp_max(edges.num_nodes - 1), wvec_z[perm].T.contiguous())


def einsum_dots(tables, index, rows):
    """The replaced per-slot dots: one batched einsum over the gathered
    ``(nb, L, d)`` rows."""
    from rgcn_tpu_torch.ops.basis import full_f32_matmul

    with full_f32_matmul():
        return torch.einsum("bli,li->lb", tables[:, index], rows)


def am_ops(dev, am) -> dict:
    from rgcn_tpu_torch.graph.structure import auto_nc_row_block, build_edge_set
    from rgcn_tpu_torch.ops import basis

    es = build_edge_set(am.triples, am.num_nodes, am.num_relations, tile_size=128,
                        with_dst_layout=True,
                        layout_row_block=auto_nc_row_block(am.num_nodes)).to(dev)
    gen = torch.Generator().manual_seed(0)
    n, nb, d = am.num_nodes, 4, 10
    comps = torch.randn((es.num_rels, nb), generator=gen).to(dev)
    bases = torch.randn((nb, n, d), generator=gen).to(dev)
    g = torch.randn((n, d), generator=gen).to(dev)
    out = {}
    for frame, e in (("forward", es), ("reverse", es.reverse)):
        old, new = per_edge_sorted_inputs(e, comps), basis.sorted_inputs(e, comps)
        if not (torch.equal(old[0], new[0]) and torch.equal(old[1], new[1])):
            raise RuntimeError(f"sorted_inputs ({frame}): the two forms differ")
        out[f"sorted_inputs_{frame}_ms"] = in_turns(
            {"replaced": lambda: per_edge_sorted_inputs(e, comps),
             "current": lambda: basis.sorted_inputs(e, comps)}, event_ms)
    src = es.src.long()
    gd = torch.cat([g, g.new_zeros((1, d))])[es.dst.long()]
    ref = einsum_dots(bases, src, gd)
    err = (basis._slot_dots(bases, src, gd) - ref).abs().max().item()
    tol = 1e-5 * max(1.0, ref.abs().max().item())
    if not err <= tol:
        raise RuntimeError(f"per-slot dots: max abs err {err} > {tol}")
    out["featureless_dcomps_dots_ms"] = in_turns(
        {"replaced": lambda: einsum_dots(bases, src, gd),
         "current": lambda: basis._slot_dots(bases, src, gd)}, event_ms)
    out["featureless_dcomps_dots_max_abs_err"] = err
    return out


def decoder_ops(dev) -> dict:
    gen = torch.Generator().manual_seed(1)
    n, r, d, b = 40_943, 18, 200, 330_000
    z = torch.randn((n, d), generator=gen).to(dev).requires_grad_()
    rel = torch.randn((r, d), generator=gen).to(dev).requires_grad_()
    t = torch.stack([torch.randint(0, n, (b,), generator=gen),
                     torch.randint(0, r, (b,), generator=gen),
                     torch.randint(0, n, (b,), generator=gen)], 1).to(dev)
    w = torch.randn((b,), generator=gen).to(dev)
    s, p, o = t[:, 0], t[:, 1], t[:, 2]

    def advanced_index():
        (torch.sum(z[s] * rel[p] * z[o], -1) * w).sum().backward()

    def index_select():
        (torch.sum(z.index_select(0, s) * rel.index_select(0, p) * z.index_select(0, o),
                   -1) * w).sum().backward()

    return {"decoder_gathers_fwd_bwd_ms": in_turns(
        {"replaced": advanced_index, "current": index_select},
        lambda fn: event_ms(fn, iters=10, warmup=2))}


def steps(dev, am) -> dict:
    from rgcn_tpu_torch.config import DecompositionConfig, load_experiment
    from rgcn_tpu_torch.data.synthetic import wn18_like
    from rgcn_tpu_torch.ops import basis
    from rgcn_tpu_torch.profile_serve import _CONFIGS, profile_train_step
    from rgcn_tpu_torch.train.link_prediction import LinkPredictionTrainer
    from rgcn_tpu_torch.train.node_classification import NodeClassificationTrainer

    forms = {"replaced": einsum_dots, "current": basis._slot_dots}

    def step_in_turns(trainer):
        out: dict = {}
        for name in ORDER:
            basis._slot_dots = forms[name]
            try:
                prof = profile_train_step(trainer)
            finally:
                basis._slot_dots = forms["current"]
            out.setdefault(name, []).append({
                "step_host_median_ms": prof["step"]["host_ms"]["median"],
                "device_step_ms": prof["step_us"] / 1e3,
                "device_busy_share": prof["step"]["device_busy_share"]})
        return out

    lp = LinkPredictionTrainer(load_experiment(f"{_CONFIGS}/lp-WN18.yaml"), wn18_like(),
                               device=dev)
    lp.set_epoch(1)
    out = {"lp_wn18_structured_step": step_in_turns(lp)}
    del lp
    base = load_experiment(f"{_CONFIGS}/nc-AM.yaml")
    cfg = dataclasses.replace(base, rgcn=dataclasses.replace(
        base.rgcn, decomposition=DecompositionConfig("basis", num_bases=4)))
    out["nc_am_basis4_step"] = step_in_turns(NodeClassificationTrainer(cfg, am, device=dev))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)

    from rgcn_tpu_torch.compare_k2 import card
    from rgcn_tpu_torch.data.synthetic import am_like

    print(card(), flush=True)
    am = am_like()
    report = {"device": torch.cuda.get_device_name(dev), "card": card(),
              **am_ops(dev, am), **decoder_ops(dev), **steps(dev, am)}
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
