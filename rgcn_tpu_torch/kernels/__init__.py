"""ctypes bindings of the hand-written Hopper kernels, with launch counters.

Each ``launch_*`` function checks its tensors (CUDA device, dtype, shape,
contiguity), allocates the output with ``torch.empty`` (zeroing, where a
kernel needs it, is the C launcher's: K2 memsets its output; K1, in either
form, memsets it on its atomics route and zeroes only the rows two CTAs
share on its owned-row route, chosen by the layout's shape; K4's f32 form
zeroes only the rows two CTAs share, K5 the rows of row blocks with several
chunks; K4's bf16 form zeroes nothing on its owned-row kernel, and takes
an f32 scratch of two rows a CTA and the stream's split-run counters,
``k4_bf16_counters``), launches on
``torch.cuda.current_stream()``, raises if the C launcher reports a CUDA
error, and adds one to its kernel's count in :data:`LAUNCHES`. The count
moves nowhere else, so a run that resets the counts and reads them after
shows which kernels it went through. The libraries are built from
``csrc/`` at first use (:mod:`rgcn_tpu_torch.kernels.build`).

K1, K4 and K5 take f32 or bf16 tables and messages (the edge stage's
compute dtype, :func:`rgcn_tpu_torch.nn.layers._edge_compute_dtype`), K2
and K3 f32 or bf16 ``x`` and ``W`` (the JAX kernels' ``compute_dtype``): a
bf16 one launches the kernel's bf16 form, an entry point and library of
its own with its own count (``k1_aggregate_bf16``, ``k2_fused_bf16``,
``k3_messages_bf16``, ``k4_weighted_aggregate_bf16``,
``k5_weighted_aggregate_dedup_bf16``), which sums in f32. K1 writes f32
or, with ``out_dtype=torch.bfloat16``, bf16 from either message dtype; K4
and K5 a bf16 output from bf16 tables; K3 messages of ``out_dtype`` (f32
or bf16; the bf16 form also takes f32 operands with bf16 messages). Any
other dtype raises: nothing is converted to reach a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from rgcn_tpu_torch.kernels import build as _build

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "refuse_grad",
    "table_form",
    "launch_k1_aggregate",
    "launch_k2_fused",
    "launch_k3_messages",
    "launch_k4_weighted_aggregate",
    "launch_k5_weighted_aggregate_dedup",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in _build.SOURCES}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C launcher (pointers and the stream as c_void_p)
_ARGTYPES = {
    # K1: (msgs, index, local_dst, chunk_block, out, scratch, ..., dst_sorted,
    # out_bf16, stream), one list for the f32 and the bf16 form
    "k1_aggregate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "k2_fused": [_P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _I, _P],
    "k3_messages": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # K3's bf16 form: (..., din, dout, x_bf16, out_bf16, stream)
    "k3_messages_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # K4 and K5: (..., out, scratch, ..., out_bf16, stream), one list for
    # the f32 and the bf16 form
    "k4_weighted_aggregate": [_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "k5_weighted_aggregate_dedup": [_P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# a bf16 form takes its f32 form's arguments; K4's (x, src, w, local_dst,
# chunk_block, out, scratch, counters, ..., out_bf16, route, span, stream)
_ARGTYPES.update({name + "_bf16": _ARGTYPES[name] for name in (
    "k1_aggregate", "k2_fused", "k5_weighted_aggregate_dedup")})
_ARGTYPES["k4_weighted_aggregate_bf16"] = [_P] * 8 + [_I] * 12 + [_P]
# the table and message dtypes of K1, K4 and K5, and the output dtypes a
# table dtype allows
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = {torch.float32: (torch.float32,),
               torch.bfloat16: (torch.float32, torch.bfloat16)}
_LIBS: Dict[str, ctypes.CDLL] = {}

# K4/K5 keep one sum per basis in registers: their launchers instantiate
# 1 to 8 bases (csrc/weighted_runs.cuh, csrc/k4_owned_bf16.cuh)
_NB_MAX = 8
# slots of a unit (one CTA) of K4's bf16 form: a whole chunk of the
# builders' 256 (csrc/k4_owned_bf16.cuh)
K4_BF16_SPAN = 256


# K4's bf16 form's split-run counters, one zeroed set a (device, stream)
_K4_COUNTERS: Dict[tuple, torch.Tensor] = {}
# the two kernels of K4's bf16 form (csrc/k4_weighted_aggregate_bf16.cu)
K4_BF16_RUNS, K4_BF16_OWNED = 0, 1
# the layouts K4's bf16 form takes the owned-row kernel over (k4_bf16_route):
# any up to K4_BF16_OWNED_ALL_CHUNKS chunks, up to K4_BF16_OWNED_MAX_CHUNKS
# but for a bf16 output of several bases
K4_BF16_OWNED_ALL_CHUNKS = 384
K4_BF16_OWNED_MAX_CHUNKS = 1024


def k4_bf16_route(din: int, table_ptr: int, n_chunks: int, nb_out: int,
                  out_dtype: torch.dtype) -> int:
    """The kernel K4's bf16 form runs for a table of rows ``din`` wide at
    address ``table_ptr``, over a layout of ``n_chunks`` chunks, into
    ``nb_out`` outputs of ``out_dtype``, as measured on an H100
    (``compare_k4_bf16``). The owned-row kernel (K4_BF16_OWNED,
    csrc/k4_owned_bf16.cuh) needs whole 16-byte vectors (din % 8 == 0) of a
    16-byte aligned table; it takes
    - any layout of at most K4_BF16_OWNED_ALL_CHUNKS chunks, under three
      CTAs an SM, where its shorter CTAs pay (nc-AIFB's 4-basis layouts,
      260-261 chunks at din 16: 12-43% faster);
    - a layout of at most K4_BF16_OWNED_MAX_CHUNKS, about a wave, but for a
      bf16 output of several bases (lp-WN18's merged frames, 502 chunks:
      the VJP's dx, one output, and an f32 output 2-5% faster; the forward's
      Agg, a bf16 output of two bases, 0.3-4% slower in every run).
    Anything else takes weighted_runs.cuh's (K4_BF16_RUNS): the structured
    decoder's 1,492-chunk layouts (three waves: 9-20% faster there), nc-AM's
    hidden width 10, an unaligned table."""
    if din % 8 or table_ptr % 16 or n_chunks > K4_BF16_OWNED_MAX_CHUNKS:
        return K4_BF16_RUNS
    if n_chunks <= K4_BF16_OWNED_ALL_CHUNKS or nb_out == 1 or out_dtype != torch.bfloat16:
        return K4_BF16_OWNED
    return K4_BF16_RUNS


def k4_bf16_units(n_chunks: int, chunk: int, span: int = K4_BF16_SPAN) -> int:
    """CTAs of K4's bf16 form: ``span`` slots of a chunk each."""
    return n_chunks * -(-chunk // min(span, chunk))


def k4_bf16_scratch_floats(n_chunks: int, chunk: int, row_len: int,
                           span: int = K4_BF16_SPAN) -> int:
    """f32 scratch of K4's bf16 form: two rows of ``row_len`` (nb_out * din)
    a unit (csrc/k4_owned_bf16.cuh: part[u][0], part[u][1])."""
    return k4_bf16_units(n_chunks, chunk, span) * 2 * row_len


def k4_bf16_counters(device: torch.device, units: int) -> torch.Tensor:
    """At least ``units`` split-run counters of K4's bf16 form for the
    current stream of ``device``: zeroed when made, and every launch leaves
    them zero (csrc/k4_owned_bf16.cuh), so they are made once; a stream has
    its own, so that launches on two streams never share one."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    have = _K4_COUNTERS.get(key)
    if have is None or have.numel() < units:
        have = torch.zeros(max(units, 2 * (0 if have is None else have.numel())),
                           dtype=torch.int32, device=device)
        _K4_COUNTERS[key] = have
    return have


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    lib = _LIBS.get(name)
    if lib is None:
        path = _build.build_all([name])[name]["path"]
        lib = ctypes.CDLL(path)
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(_LIBS[name], name)


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, device,
           shape=None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: kernel needs a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: kernel needs a contiguous tensor")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """The launch branch of a wrapper without a backward: raise when grad
    mode is on and an input requires grad, since the kernel's output would
    carry no gradient back to it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward on the card: run it under "
            "torch.no_grad(), or through a differentiable wrapper"
        )


def table_form(t: torch.Tensor, what: str, out_dtype=torch.float32,
               out_dtypes=None) -> str:
    """The entry-point suffix of a table, message or operand dtype ("" for
    f32, "_bf16" for bf16); raises for any other dtype or an output dtype
    the form does not write (``out_dtypes``: the outputs it writes, by
    default K4's and K5's for this table dtype)."""
    if t.dtype not in _TABLE_DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype}, kernel takes float32 or bfloat16")
    if out_dtype not in (out_dtypes or _OUT_DTYPES[t.dtype]):
        raise TypeError(f"{what}: a {t.dtype} table gives no {out_dtype} output")
    return "" if t.dtype == torch.float32 else "_bf16"


def _pair_form(x: torch.Tensor, weights: torch.Tensor) -> str:
    """K2's and K3's operand form: ``x`` and ``W`` of one dtype, f32 ("")
    or bf16 ("_bf16")."""
    form = table_form(x, "x")
    if weights.dtype != x.dtype:
        raise TypeError(f"weights: dtype {weights.dtype}, x is {x.dtype}: "
                        "the kernel takes operands of one dtype")
    return form


def _check_blocks(num_nodes: int, row_block: int, num_row_blocks: int) -> None:
    # the output's rows must span exactly the blocks the layout addresses
    if -(-num_nodes // row_block) != num_row_blocks:
        raise ValueError(f"{num_nodes} nodes do not fill the layout's "
                         f"{num_row_blocks} blocks of {row_block}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _fn(name)
    with torch.cuda.device(device):  # the tensors' card and its stream
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def launch_k1_aggregate(
    msgs: torch.Tensor,
    index: Optional[torch.Tensor],
    local_dst: torch.Tensor,
    chunk_block: torch.Tensor,
    num_nodes: int,
    row_block: int,
    num_row_blocks: int,
    out_dtype: torch.dtype = torch.float32,
    dst_sorted: bool = True,
) -> torch.Tensor:
    """K1: ``out[n] = Σ_{slots l → n} msgs[index[l]]`` (``index`` None reads
    slot ``l`` of destination-sorted ``msgs``) over a destination layout's
    ``(n_chunks, CH)`` ``local_dst`` and ``chunk_block``. ``msgs`` f32 or
    bf16 (the bf16 form, ``k1_aggregate_bf16``); the sums are f32 and the
    output ``out_dtype``, f32 or bf16 (each element rounded once from its
    f32 sum). Both forms take one of two routes by the layout's shape
    (``csrc/k1_aggregate.cuh``, ``run()``): where ``dst_sorted`` (each row
    block's slots sorted by destination: every builder's order but the
    source-ordered one), ``dout % 4 == 0``, the launch has at least 1024
    CTAs and the layout at least 3 slots an output row, the owned-row
    route stores each row a CTA holds whole once and finishes only the
    rows two CTAs share with atomics; else the atomics route adds every
    run into a memset output. Returns ``(num_nodes, dout)``; rows past
    ``num_nodes`` are dropped."""
    dev = msgs.device
    _check(local_dst, "local_dst", torch.int32, None)
    if local_dst.dim() != 2:
        raise ValueError(
            f"local_dst: expected (n_chunks, CH), got {tuple(local_dst.shape)}")
    n_chunks, chunk = local_dst.shape
    num_slots = n_chunks * chunk
    form = table_form(msgs, "msgs", out_dtype, _TABLE_DTYPES)
    _check(msgs, "msgs", msgs.dtype, local_dst.device)
    if msgs.dim() != 2:
        raise ValueError(f"msgs: expected (rows, dout), got {tuple(msgs.shape)}")
    _check(chunk_block, "chunk_block", torch.int32, dev, (n_chunks,))
    if index is None:
        if msgs.shape[0] != num_slots:
            raise ValueError(f"msgs rows {msgs.shape[0]} != layout slots {num_slots}")
    else:
        _check(index, "index", torch.int32, dev, (num_slots,))
    if num_nodes > num_row_blocks * row_block:
        raise ValueError(
            f"{num_nodes} nodes exceed {num_row_blocks} blocks of {row_block}")
    dout = msgs.shape[1]
    out = torch.empty((num_nodes, dout), dtype=out_dtype, device=dev)
    if num_nodes == 0 or dout == 0:
        return out
    bf16_out = out_dtype == torch.bfloat16
    scratch = torch.empty((num_nodes, dout), dtype=torch.float32, device=dev) \
        if bf16_out else None
    _launch(
        "k1_aggregate" + form, dev, msgs.data_ptr(),
        None if index is None else index.data_ptr(),
        local_dst.data_ptr(), chunk_block.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        n_chunks, chunk, row_block, dout, num_nodes, int(dst_sorted), int(bf16_out),
    )
    return out


def launch_k2_fused(
    x: torch.Tensor,
    weights: torch.Tensor,
    src: torch.Tensor,
    val: torch.Tensor,
    local_dst: torch.Tensor,
    quantum_rel: torch.Tensor,
    chunk_block: torch.Tensor,
    num_nodes: int,
    row_block: int,
    num_row_blocks: int,
    quantum: int,
) -> torch.Tensor:
    """K2: ``out[n] = Σ val·(x[src] @ W[rel_q])`` over a fused layout, one
    quantum per CTA with its ``W[rel_q]`` staged in shared memory. ``x`` and
    ``weights`` f32, or both bf16 (the bf16 form, ``k2_fused_bf16``: f32
    sums, each message rounded to bf16, f32 destination sums). Returns
    ``(num_nodes, dout)`` f32; rows past ``num_nodes`` are dropped."""
    dev = x.device
    _check(local_dst, "local_dst", torch.int32, None)
    if local_dst.dim() != 2:
        raise ValueError(
            f"local_dst: expected (n_chunks, CH), got {tuple(local_dst.shape)}")
    n_chunks, chunk = local_dst.shape
    num_slots = n_chunks * chunk
    if quantum < 1 or chunk % quantum:
        raise ValueError(f"quantum {quantum} does not divide the chunk {chunk}")
    n_quanta = num_slots // quantum
    form = _pair_form(x, weights)
    _check(x, "x", x.dtype, local_dst.device)
    _check(weights, "weights", x.dtype, dev)
    if x.dim() != 2 or weights.dim() != 3 or weights.shape[1] != x.shape[1]:
        raise ValueError(
            f"x {tuple(x.shape)} and weights {tuple(weights.shape)} do not "
            "chain as (N, din) @ (R, din, dout)"
        )
    _check(src, "src", torch.int32, dev, (num_slots,))
    _check(val, "val", torch.float32, dev, (num_slots,))
    _check(quantum_rel, "quantum_rel", torch.int32, dev, (n_quanta,))
    _check(chunk_block, "chunk_block", torch.int32, dev, (n_chunks,))
    if num_nodes > num_row_blocks * row_block:
        raise ValueError(
            f"{num_nodes} nodes exceed {num_row_blocks} blocks of {row_block}")
    _, din, dout = weights.shape
    out = torch.empty((num_nodes, dout), dtype=torch.float32, device=dev)
    if num_nodes == 0 or dout == 0 or din == 0:
        return out.zero_()
    _launch(
        "k2_fused" + form, dev, x.data_ptr(), weights.data_ptr(), src.data_ptr(),
        val.data_ptr(), local_dst.data_ptr(), quantum_rel.data_ptr(),
        chunk_block.data_ptr(), out.data_ptr(),
        n_quanta, din, dout, row_block, chunk, quantum, num_nodes,
    )
    return out


def launch_k3_messages(
    x: torch.Tensor,
    weights: torch.Tensor,
    src: torch.Tensor,
    val: torch.Tensor,
    tile_rel: torch.Tensor,
    tile_size: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """K3: per relation-uniform tile, ``msgs = (x[src] @ W[tile_rel]) · val``
    in edge order; rows whose ``val`` is 0 come out 0 uncomputed. The
    launcher takes a small route for ``dout <= 32`` (W[rel] within 48 KB)
    and a tiled one otherwise. ``x`` and ``weights`` f32 or both bf16;
    messages of ``out_dtype`` (default the weights' dtype), f32 or bf16,
    summed in f32 and rounded once; anything but f32 throughout launches
    the bf16 form (``k3_messages_bf16``). Returns ``(E_pad, dout)``, every
    element stored by the kernel (no memset)."""
    dev = x.device
    n_tiles = tile_rel.shape[0]
    e_pad = n_tiles * tile_size
    out_dtype = out_dtype or weights.dtype
    form = _pair_form(x, weights)
    if out_dtype not in _TABLE_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: K3 writes float32 or bfloat16")
    if out_dtype == torch.bfloat16:
        form = "_bf16"
    _check(x, "x", x.dtype, None)
    _check(weights, "weights", x.dtype, dev)
    if x.dim() != 2 or weights.dim() != 3 or weights.shape[1] != x.shape[1]:
        raise ValueError(
            f"x {tuple(x.shape)} and weights {tuple(weights.shape)} do not "
            "chain as (N, din) @ (R, din, dout)"
        )
    _check(src, "src", torch.int32, dev, (e_pad,))
    _check(val, "val", torch.float32, dev, (e_pad,))
    _check(tile_rel, "tile_rel", torch.int32, dev, (n_tiles,))
    _, din, dout = weights.shape
    out = torch.empty((e_pad, dout), dtype=out_dtype, device=dev)
    if e_pad == 0 or dout == 0:
        return out
    flags = (int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)) \
        if form else ()
    _launch(
        "k3_messages" + form, dev, x.data_ptr(), weights.data_ptr(), src.data_ptr(),
        val.data_ptr(), tile_rel.data_ptr(), out.data_ptr(),
        n_tiles, tile_size, din, dout, *flags,
    )
    return out


def _weighted_out(num_nodes: int, nb_out: int, din: int, out_dtype, dev):
    """K4/K5's output ``(num_nodes, nb_out, din)`` and, for a bf16 output,
    the f32 scratch of the rows the kernel finishes with atomics (None for
    f32: the kernel adds into the output itself)."""
    out = torch.empty((num_nodes, nb_out, din), dtype=out_dtype, device=dev)
    scratch = None
    if out_dtype == torch.bfloat16:
        scratch = torch.empty((num_nodes, nb_out, din), dtype=torch.float32, device=dev)
    return out, scratch


def launch_k4_weighted_aggregate(
    x: torch.Tensor,
    src: torch.Tensor,
    w: torch.Tensor,
    local_dst: torch.Tensor,
    chunk_block: torch.Tensor,
    num_nodes: int,
    row_block: int,
    num_row_blocks: int,
    *,
    sum_bases: bool = False,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K4: ``out[b, n] = Σ_{slots l → n} w[b, l] · row(b, l)``, where
    ``row(b, l)`` is ``x[src[l]]`` for a shared ``(rows, din)`` table or
    ``x[b, src[l]]`` for per-basis ``(nb, rows, din)`` tables; the kernel
    gathers the rows itself. ``sum_bases`` sums over ``b``. The layout's
    slots must be sorted by destination within each row block, as every
    DstLayout builder makes them: a chunk stores the rows it owns outright.
    ``x`` f32, or bf16 (the bf16 form, ``k4_weighted_aggregate_bf16``: each
    weight rounded to bf16, f32 sums, ``out_dtype`` f32 or bf16 narrowed
    once per element); ``w`` f32. Returns ``(nb or 1, num_nodes, din)`` of
    ``out_dtype``, a view of node-major ``(num_nodes, nb or 1, din)``
    storage."""
    dev = x.device
    n_chunks, chunk = local_dst.shape
    num_slots = n_chunks * chunk
    form = table_form(x, "x", out_dtype)
    _check(x, "x", x.dtype, None)
    if x.dim() not in (2, 3):
        raise ValueError(
            f"x: expected (rows, din) or (nb, rows, din), got {tuple(x.shape)}")
    _check(w, "w", torch.float32, dev)
    nb = w.shape[0]
    if w.dim() != 2 or w.shape[1] != num_slots or not 1 <= nb <= _NB_MAX:
        raise ValueError(
            f"w: expected (nb <= {_NB_MAX}, {num_slots}), got {tuple(w.shape)}")
    per_basis = x.dim() == 3
    if per_basis and x.shape[0] != nb:
        raise ValueError(f"x: {x.shape[0]} per-basis tables for {nb} bases")
    _check(src, "src", torch.int32, dev, (num_slots,))
    _check(local_dst, "local_dst", torch.int32, dev)
    _check(chunk_block, "chunk_block", torch.int32, dev, (n_chunks,))
    _check_blocks(num_nodes, row_block, num_row_blocks)
    din, rows = x.shape[-1], x.shape[-2]
    nb_out = 1 if sum_bases else nb
    owned = bool(form) and k4_bf16_route(din, x.data_ptr(), n_chunks, nb_out,
                                         out_dtype) == K4_BF16_OWNED
    if owned:
        out = torch.empty((num_nodes, nb_out, din), dtype=out_dtype, device=dev)
    else:
        out, scratch = _weighted_out(num_nodes, nb_out, din, out_dtype, dev)
    if num_nodes == 0 or din == 0 or n_chunks == 0:
        return out.zero_().permute(1, 0, 2)
    extra, tail = (), ()
    if owned:  # f32 scratch of two rows a unit, the units' counters
        scratch = torch.empty(k4_bf16_scratch_floats(n_chunks, chunk, nb_out * din),
                              dtype=torch.float32, device=dev)
        extra = (k4_bf16_counters(dev, k4_bf16_units(n_chunks, chunk)).data_ptr(),)
    elif form:
        extra = (None,)
    if form:
        tail = (K4_BF16_OWNED if owned else K4_BF16_RUNS, K4_BF16_SPAN)
    _launch("k4_weighted_aggregate" + form, dev, x.data_ptr(), src.data_ptr(),
            w.data_ptr(), local_dst.data_ptr(), chunk_block.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), *extra,
            n_chunks, chunk, row_block, nb, din, rows, num_nodes,
            int(per_basis), int(sum_bases), int(out_dtype == torch.bfloat16), *tail)
    return out.permute(1, 0, 2)


def launch_k5_weighted_aggregate_dedup(
    x: torch.Tensor,
    src: torch.Tensor,
    w_k: torch.Tensor,
    local_k: torch.Tensor,
    chunk_block: torch.Tensor,
    num_nodes: int,
    row_block: int,
    num_row_blocks: int,
    *,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K5: ``out[b, n] = Σ_{slots l, lanes k → n} w_k[k, b, l] · x[src[l]]``
    over a source-dedup'd frame (the lanes merged per destination on chip).
    ``x`` f32, or bf16 (the bf16 form, ``k5_weighted_aggregate_dedup_bf16``,
    as K4's, with ``out_dtype`` f32 or bf16). Returns ``(nb, num_nodes,
    din)`` of ``out_dtype``, a view of node-major ``(num_nodes, nb, din)``
    storage."""
    dev = x.device
    _check(local_k, "local_k", torch.int32, None)
    if local_k.dim() != 3:
        raise ValueError(
            f"local_k: expected (K, n_chunks, CH), got {tuple(local_k.shape)}")
    kk, n_chunks, chunk = local_k.shape
    num_slots = n_chunks * chunk
    form = table_form(x, "x", out_dtype)
    _check(x, "x", x.dtype, local_k.device)
    if x.dim() != 2:
        raise ValueError(f"x: expected (rows, din), got {tuple(x.shape)}")
    _check(w_k, "w_k", torch.float32, dev)
    if w_k.dim() != 3 or w_k.shape[0] != kk or w_k.shape[2] != num_slots \
            or not 1 <= w_k.shape[1] <= _NB_MAX:
        raise ValueError(
            f"w_k: expected ({kk}, nb <= {_NB_MAX}, {num_slots}), "
            f"got {tuple(w_k.shape)}")
    nb = w_k.shape[1]
    _check(src, "src", torch.int32, dev, (num_slots,))
    _check(chunk_block, "chunk_block", torch.int32, dev, (n_chunks,))
    _check_blocks(num_nodes, row_block, num_row_blocks)
    din = x.shape[1]
    out, scratch = _weighted_out(num_nodes, nb, din, out_dtype, dev)
    if num_nodes == 0 or din == 0 or n_chunks == 0:
        return out.zero_().permute(1, 0, 2)
    _launch("k5_weighted_aggregate_dedup" + form, dev, x.data_ptr(), src.data_ptr(),
            w_k.data_ptr(), local_k.data_ptr(), chunk_block.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n_chunks, chunk, row_block, kk, nb, din, num_nodes,
            int(out_dtype == torch.bfloat16))
    return out.permute(1, 0, 2)
