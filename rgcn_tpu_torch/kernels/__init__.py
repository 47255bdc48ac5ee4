"""ctypes bindings of the hand-written Hopper kernels, with launch counters.

Each ``launch_*`` function checks its tensors (CUDA device, dtype, shape,
contiguity), allocates the output with ``torch.empty`` and any scratch the
kernel takes (nothing is zeroed per call: K1, K2 and K4 store every output
row once and sum in an order the layout fixes, finishing the rows several
CTAs share from f32 parts in a small scratch through the stream's
split-run counters, :func:`stream_counters`; K5 zeroes the rows of row
blocks with several chunks and adds to them with atomics), launches on
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
``k5_weighted_aggregate_dedup_bf16``), which sums in f32. K2 and K3 also
take f32 ``x`` with a bf16 ``W`` (the layers' ``param_dtype=bfloat16``)
in their bf16-weight forms (``k2_fused_wbf16``, ``k3_messages_wbf16``:
the weights widened exactly, f32 products and sums). K1 writes f32 or,
with ``out_dtype=torch.bfloat16``, bf16 from either message dtype; K4 and
K5 a bf16 output from bf16 tables; K3 messages of ``out_dtype`` (f32 or
bf16; the bf16 form also takes f32 operands with bf16 messages). Any
other dtype or mix raises: nothing is converted to reach a kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from rgcn_tpu_torch.kernels import build as _build

__all__ = [
    "LAUNCHES",
    "ROUTES",
    "reset_launches",
    "refuse_grad",
    "table_form",
    "pair_form",
    "stream_counters",
    "k1_route",
    "k1_piece",
    "k4_piece",
    "k4_units",
    "k4_row_floats",
    "k4_scratch_floats",
    "k1_fixed_units",
    "k1_fixed_counters",
    "k1_scratch_floats",
    "chunk_smem_bytes",
    "chunk_scratch_floats",
    "launch_k1_aggregate",
    "launch_k2_fused",
    "launch_k3_messages",
    "launch_k4_weighted_aggregate",
    "launch_k5_weighted_aggregate_dedup",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in _build.SOURCES}
# K1's and K4's launches by route and lane piece (``k1_fixed_piece2``,
# ``k4_owned_piece8``, ...) since the process started: reset_launches
# leaves them, so a run can show every route it took
ROUTES: Dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C launcher (pointers and the stream as c_void_p)
_ARGTYPES = {
    # K1: (msgs, index, local_dst, chunk_block, out, scratch, counters, ...,
    # route, out_bf16, stream), one list for the f32 and the bf16 form
    "k1_aggregate": [_P] * 7 + [_I] * 7 + [_P],
    # K2: (x, w, src, val, local_dst, quantum_rel, chunk_block, out, part,
    # counters, ..., stream), one list for the f32 and the bf16 form
    "k2_fused": [_P] * 10 + [_I] * 7 + [_P],
    "k3_messages": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # K3's bf16 form: (..., din, dout, x_bf16, out_bf16, stream)
    "k3_messages_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # K4: (x, src, w, local_dst, chunk_block, out, scratch, counters, ...,
    # out_bf16, span, stream); K5: (..., out, scratch, ..., out_bf16,
    # stream); one list for the f32 and the bf16 form of each
    "k4_weighted_aggregate": [_P] * 8 + [_I] * 11 + [_P],
    "k5_weighted_aggregate_dedup": [_P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
# a bf16 form takes its f32 form's arguments
_ARGTYPES.update({name + "_bf16": _ARGTYPES[name] for name in (
    "k1_aggregate", "k2_fused", "k4_weighted_aggregate", "k5_weighted_aggregate_dedup")})
# the bf16-weight forms: K2's takes its f32 form's arguments, K3's (...,
# din, dout, out_bf16, stream)
_ARGTYPES["k2_fused_wbf16"] = _ARGTYPES["k2_fused"]
_ARGTYPES["k3_messages_wbf16"] = [_P] * 6 + [_I] * 5 + [_P]
# the table and message dtypes of K1, K4 and K5, and the output dtypes a
# table dtype allows
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = {torch.float32: (torch.float32,),
               torch.bfloat16: (torch.float32, torch.bfloat16)}
_LIBS: Dict[str, ctypes.CDLL] = {}

# K4/K5 keep one sum per basis in registers: their launchers instantiate
# 1 to 8 bases (csrc/k4_owned.cuh, csrc/weighted_runs.cuh)
_NB_MAX = 8
# slots of a unit (one CTA) of K4: a whole chunk of the builders' 256
# (csrc/k4_owned.cuh)
K4_SPAN = 256


# the split-run counters of K1, K2 and K4, one zeroed set a (device, stream)
_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _piece(width: int, ptr: int, itemsize: int, most: int) -> int:
    """The most values (a power of two, at most ``most``) that divide
    ``width`` and whose bytes divide the address ``ptr``."""
    p = most
    while p > 1 and (width % p or ptr % (p * itemsize)):
        p //= 2
    return p


def k4_piece(din: int, table_ptr: int, itemsize: int) -> int:
    """The values K4 moves a copy and a store for a table of rows ``din``
    wide at address ``table_ptr`` with ``itemsize``-byte values
    (csrc/k4_owned.cuh's choose_piece): a whole 16-byte vector (4 f32, 8
    bf16) where din is whole vectors of a 16-byte aligned table, else the
    most that din and the table's alignment allow (nc-AM's width 10: 2 f32
    or 2 bf16 values). Every layout takes K4's one kernel, the owned-row
    kernel of csrc/k4_owned.cuh: a fixed-order sum in one launch."""
    return _piece(din, table_ptr, itemsize, 16 // itemsize)


def k4_units(n_chunks: int, chunk: int, span: int = K4_SPAN) -> int:
    """CTAs of K4: ``span`` slots of a chunk each."""
    return n_chunks * -(-chunk // min(span, chunk))


def k4_row_floats(nb_out: int, din: int, itemsize: int) -> int:
    """A row of K4's f32 scratch: ``nb_out`` bases of ``din`` rounded up to
    whole 16-byte vectors of the table (csrc/k4_owned.cuh's din_p)."""
    vec = 16 // itemsize
    return nb_out * -(-din // vec) * vec


def k4_scratch_floats(n_chunks: int, chunk: int, row_len: int,
                      span: int = K4_SPAN) -> int:
    """f32 scratch of K4: two rows of ``row_len`` (:func:`k4_row_floats`) a
    unit (csrc/k4_owned.cuh: part[u][0], part[u][1])."""
    return k4_units(n_chunks, chunk, span) * 2 * row_len


def stream_counters(device: torch.device, units: int) -> torch.Tensor:
    """At least ``units`` split-run counters for the current stream of
    ``device``, shared by K1, K2 and K4: zeroed when made, and
    every launch leaves them zero (each run's or block's last CTA wraps its
    counter back with atomicInc), so they are made once; a stream has its
    own, so that launches on two streams never share one. Launches on one
    stream run one after another, so they may share a set."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < units:
        have = torch.zeros(max(units, 2 * (0 if have is None else have.numel())),
                           dtype=torch.int32, device=device)
        _COUNTERS[key] = have
    return have


# K1's routes (csrc/k1_aggregate.cuh): owned rows over a destination-sorted
# layout, chunk_sum.cuh's chunk-a-CTA sum over any order, both in a fixed
# order
K1_FIXED, K1_CHUNK = 0, 1
# K1's K1_FIXED units: CTAs of at most 8 warps, a group of LPS lanes of 4
# values (the power of two at least the row's lanes, at most 32) walking
# max(8, LPS) slots; a CTA a column group of LPS x 4 columns
_K1_WARPS = 8
_K1_VEC = 4


def _k1_lps(dout: int) -> int:
    """K1's lanes on a row, as csrc/k1_aggregate.cuh's run(): the power of
    two at least its 4-value lanes, at most 32."""
    lanes = -(-dout // _K1_VEC)
    return min(32, 1 << max(0, (lanes - 1).bit_length()))


def _k1_span(lps: int, chunk: int) -> int:
    return min(chunk, _K1_WARPS * 32 * (max(8, lps) // lps))


def k1_piece(dout: int, msgs_ptr: int, itemsize: int) -> int:
    """The values a K1 lane moves a load or store (csrc/k1_aggregate.cuh's
    lane_piece): its 4 values where rows are whole lanes of a table
    aligned to them, else 2 (dout even, the table aligned to 2 values;
    nc-AM's width 10), else 1."""
    return _piece(dout, msgs_ptr, itemsize, _K1_VEC)


def k1_route(dst_sorted: bool) -> int:
    """The route K1 takes, in either form and for either output
    (csrc/k1_aggregate.cuh): K1_FIXED (owned rows, the rows CTAs share
    finished by one of them from f32 parts) where each row block's slots
    are sorted by destination, as every model path's layouts are, at any
    size and width; K1_CHUNK (a CTA a chunk, slots summed by destination
    in slot order, a block's chunks finished by their last CTA) where they
    are not. Both sum in a fixed order in one launch."""
    return K1_FIXED if dst_sorted else K1_CHUNK


def _k1_units_groups(n_chunks: int, chunk: int, dout: int):
    lps = _k1_lps(dout)
    units = n_chunks * -(-chunk // _k1_span(lps, chunk))
    return units, -(-dout // (lps * _K1_VEC))


def k1_fixed_units(n_chunks: int, chunk: int, dout: int) -> int:
    """CTAs of K1's K1_FIXED route over ``n_chunks`` chunks of ``chunk``
    slots at width ``dout``, column groups aside. Its scratch holds two
    rows of ``dout`` rounded up to whole lanes, f32, a unit."""
    return _k1_units_groups(n_chunks, chunk, dout)[0]


def k1_fixed_counters(n_chunks: int, chunk: int, dout: int) -> int:
    """Split-run counters of a K1_FIXED launch: one a (unit, column
    group)."""
    units, groups = _k1_units_groups(n_chunks, chunk, dout)
    return units * groups


# shared memory a CTA may take on an H100 (232,448 bytes) and the columns
# csrc/chunk_sum.cuh holds a pass
_MAX_SMEM = 232_448
_CHUNK_SLICE = 32


def chunk_smem_bytes(chunk: int, row_block: int, dout: int) -> int:
    """Shared memory of a chunk_sum.cuh CTA (K2, K1's K1_CHUNK route): a
    chunk's messages, a slice of the power of two at least ``dout`` columns
    (4 to 32) at a pitch 4 floats wider from 8 up (the banks), and a bit a
    slot for each row of the block."""
    width = 4
    while width < dout and width < _CHUNK_SLICE:
        width *= 2
    pitch = 4 if width == 4 else width + 4
    return 4 * (chunk * pitch + -(-chunk // 32) * row_block + -(-row_block // 32))


def chunk_scratch_floats(n_chunks: int, row_block: int, dout: int) -> int:
    """f32 scratch of a chunk_sum.cuh launch (K2, K1's K1_CHUNK route): an
    ``(RB, dout)`` tile a chunk, then a bit a row of each chunk."""
    return n_chunks * (row_block * dout + -(-row_block // 32))


def _check_chunk_smem(what: str, chunk: int, row_block: int, dout: int) -> None:
    need = chunk_smem_bytes(chunk, row_block, dout)
    if need > _MAX_SMEM:
        raise ValueError(f"{what}: chunks of {chunk} slots over row blocks of {row_block} "
                         f"need {need} bytes of shared memory, past {_MAX_SMEM}")


def k1_scratch_floats(route: int, n_chunks: int, chunk: int, row_block: int,
                      dout: int) -> int:
    """f32 scratch of a K1 launch: two rows of ``dout`` rounded up to whole
    4-value lanes a unit (K1_FIXED), an (RB, dout) tile and a bit a row a
    chunk (K1_CHUNK)."""
    if route == K1_FIXED:
        return k1_fixed_units(n_chunks, chunk, dout) * 2 * -(-dout // _K1_VEC) * _K1_VEC
    return chunk_scratch_floats(n_chunks, row_block, dout)


def _count_route(key: str) -> None:
    ROUTES[key] = ROUTES.get(key, 0) + 1


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


def pair_form(x: torch.Tensor, weights: torch.Tensor) -> str:
    """K2's and K3's operand form: ``x`` and ``W`` of one dtype, f32 ("")
    or bf16 ("_bf16"), or f32 ``x`` with a bf16 ``W`` ("_wbf16", bf16
    parameters, which JAX's kernels promote); any other mix raises. Their
    plain versions hold the same rule."""
    form = table_form(x, "x")
    if weights.dtype == x.dtype:
        return form
    if x.dtype == torch.float32 and weights.dtype == torch.bfloat16:
        return "_wbf16"
    raise TypeError(f"weights: dtype {weights.dtype}, x is {x.dtype}: the kernel "
                    "takes operands of one dtype, or f32 x with a bf16 W")


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
    f32 sum). By :func:`k1_route`: where ``dst_sorted`` (each row block's
    slots sorted by destination: every builder's order but the
    source-ordered one) owned rows, each stored once by the CTA its slots
    lie in and a row several CTAs share by the last of them from f32 parts;
    else a CTA a chunk; both take one launch, no memset, and sum in a fixed
    order (the same bits on every launch), at every size and width. Every
    row block must have a chunk, as every builder gives it. Returns
    ``(num_nodes, dout)``; rows past ``num_nodes`` are dropped."""
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
    route = k1_route(dst_sorted)
    if route == K1_CHUNK:
        _check_chunk_smem("K1", chunk, row_block, dout)
    scratch = torch.empty(k1_scratch_floats(route, n_chunks, chunk, row_block, dout),
                          dtype=torch.float32, device=dev)
    counters = (k1_fixed_counters(n_chunks, chunk, dout) if route == K1_FIXED
                else n_chunks)
    _count_route(f"k1_{'fixed' if route == K1_FIXED else 'chunk'}_piece"
                 f"{k1_piece(dout, msgs.data_ptr(), msgs.element_size())}")
    _launch(
        "k1_aggregate" + form, dev, msgs.data_ptr(),
        None if index is None else index.data_ptr(),
        local_dst.data_ptr(), chunk_block.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        stream_counters(dev, counters).data_ptr(),
        n_chunks, chunk, row_block, dout, num_nodes, route, int(bf16_out),
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
    """K2: ``out[n] = Σ val·(x[src] @ W[rel_q])`` over a fused layout, a
    CTA a chunk: each slot's message staged in shared memory, each row's
    messages summed in slot order, a row block's chunks by their last CTA
    in chunk order from an ``(RB, dout)`` f32 tile a chunk (one launch, no
    memset, the same bits on every launch; every row block must have a
    chunk and a block's chunks be adjacent, as both fused builders lay them
    out). ``x`` and ``weights`` f32, or both bf16 (the bf16 form,
    ``k2_fused_bf16``: f32 sums, each message rounded to bf16, f32
    destination sums), or f32 ``x`` with a bf16 ``weights`` (the
    bf16-weight form, ``k2_fused_wbf16``: each weight widened exactly,
    f32 messages and sums). Returns ``(num_nodes, dout)`` f32; rows past
    ``num_nodes`` are dropped."""
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
    form = pair_form(x, weights)
    _check(x, "x", x.dtype, local_dst.device)
    _check(weights, "weights", weights.dtype, dev)
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
    _check_chunk_smem("K2", chunk, row_block, dout)
    part = torch.empty(chunk_scratch_floats(n_chunks, row_block, dout),
                       dtype=torch.float32, device=dev)
    _launch(
        "k2_fused" + form, dev, x.data_ptr(), weights.data_ptr(), src.data_ptr(),
        val.data_ptr(), local_dst.data_ptr(), quantum_rel.data_ptr(),
        chunk_block.data_ptr(), out.data_ptr(), part.data_ptr(),
        stream_counters(dev, n_chunks).data_ptr(),
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
    the bf16 form (``k3_messages_bf16``). f32 ``x`` with a bf16 ``weights``
    launches the bf16-weight form (``k3_messages_wbf16``: each weight
    widened exactly, f32 sums, messages of either dtype). Returns
    ``(E_pad, dout)``, every element stored by the kernel (no memset)."""
    dev = x.device
    n_tiles = tile_rel.shape[0]
    e_pad = n_tiles * tile_size
    out_dtype = out_dtype or weights.dtype
    form = pair_form(x, weights)
    if out_dtype not in _TABLE_DTYPES:
        raise TypeError(f"out_dtype {out_dtype}: K3 writes float32 or bfloat16")
    if out_dtype == torch.bfloat16 and form != "_wbf16":
        form = "_bf16"
    _check(x, "x", x.dtype, None)
    _check(weights, "weights", weights.dtype, dev)
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
    flags = {"": (), "_wbf16": (int(out_dtype == torch.bfloat16),),
             "_bf16": (int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))}[form]
    _launch(
        "k3_messages" + form, dev, x.data_ptr(), weights.data_ptr(), src.data_ptr(),
        val.data_ptr(), tile_rel.data_ptr(), out.data_ptr(),
        n_tiles, tile_size, din, dout, *flags,
    )
    return out


def _weighted_out(num_nodes: int, nb_out: int, din: int, out_dtype, dev):
    """K5's output ``(num_nodes, nb_out, din)`` and, for a bf16 output, the
    f32 scratch of the rows the kernel finishes with atomics (None for
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
    DstLayout builder makes them: a CTA (a unit of K4_SPAN slots) stores
    the rows it owns outright and each row several CTAs share is finished by
    the last of them from f32 parts, in unit order: one launch, no memset,
    the same bits on every launch (csrc/k4_owned.cuh). ``x`` f32, or bf16
    (the bf16 form, ``k4_weighted_aggregate_bf16``: each weight rounded to
    bf16, f32 sums, ``out_dtype`` f32 or bf16 narrowed once per element);
    ``w`` f32. Returns ``(nb or 1, num_nodes, din)`` of ``out_dtype``, a
    view of node-major ``(num_nodes, nb or 1, din)`` storage."""
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
    out = torch.empty((num_nodes, nb_out, din), dtype=out_dtype, device=dev)
    if num_nodes == 0 or din == 0 or n_chunks == 0:
        return out.zero_().permute(1, 0, 2)
    # f32 scratch of two rows a unit, the units' counters
    scratch = torch.empty(
        k4_scratch_floats(n_chunks, chunk, k4_row_floats(nb_out, din, x.element_size())),
        dtype=torch.float32, device=dev)
    _count_route(f"k4_owned_piece{k4_piece(din, x.data_ptr(), x.element_size())}")
    _launch("k4_weighted_aggregate" + form, dev, x.data_ptr(), src.data_ptr(),
            w.data_ptr(), local_dst.data_ptr(), chunk_block.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), stream_counters(dev, k4_units(n_chunks, chunk)).data_ptr(),
            n_chunks, chunk, row_block, nb, din, rows, num_nodes,
            int(per_basis), int(sum_bases), int(out_dtype == torch.bfloat16), K4_SPAN)
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
