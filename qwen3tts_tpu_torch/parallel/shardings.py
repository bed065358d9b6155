"""Tensor-parallel parameter shardings (counterpart of
``qwen3tts_tpu/parallel/shardings.py``).

The partitioning policy is the JAX package's:

- q/k/v projections: shard the output (head) dim  -> no comm at apply
- o projection:      shard the input (head) dim   -> one sum over "tp"
- FFN gate/up:       shard the intermediate dim   -> no comm
- FFN down:          shard the intermediate (in) dim -> one sum
- text projection:   fc1 by output columns (and its bias), fc2 by input
                     rows (one sum; its bias after the sum, replicated)
- codec/LM heads:    shard the vocab dim          -> logits gather
- embeddings, norms: replicated

The specs are the JAX package's PartitionSpecs, as tuples. Where the port
differs on purpose: JAX shards the fused ``wqkv`` / ``w_gateup`` output
axis contiguously and lets GSPMD reshard for the slices that follow
(``shardings.py:28-31``). The port has no GSPMD, so it regroups: rank r of
"tp" takes its Hq/tp query heads, Hkv/tp KV heads and F/tp gate and up
columns, and the matching input rows of ``wo`` and ``w_down``, so each
rank's ``transformer_core._layer`` runs on local head counts
(``local_config``) and sums two products a layer (``parallel/collectives``).

``_fit_spec``'s rule holds, by pairs: a dim an axis does not divide stays
replicated, and so does its partner (``wqkv`` and ``wo`` split only when
tp divides Hq and Hkv, ``w_gateup`` and ``w_down`` when it divides F, with
an even F/tp for u4 rows). An int8 leaf's scales follow its columns and
stay replicated under a row split (they apply after the sum); a u4 leaf
split over its rows is repacked on its own rows (split-half nibbles over
the rank's K/tp rows, the groups cut at gcd(group, K/(2 tp)) rows with
their scale and offset: the same weights, the same grouped formula).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.code_predictor import CodePredictorParams
from ..models.talker import TalkerParams
from ..models.transformer_core import BlockParams
from ..ops.quant import QuantLinear, QuantLinear4, unpack4, weight_in_dim
from .mesh import Mesh, place, split_over


def block_specs() -> BlockParams:
    return BlockParams(
        attn_norm=(),
        wqkv=(None, None, "tp"),
        wo=(None, "tp", None),
        q_norm=(),
        k_norm=(),
        ffn_norm=(),
        w_gateup=(None, None, "tp"),
        w_down=(None, "tp", None),
    )


def talker_specs() -> TalkerParams:
    return TalkerParams(
        text_embd=(),
        text_proj_fc1_w=(None, "tp"),
        text_proj_fc1_b=("tp",),
        text_proj_fc2_w=("tp", None),
        text_proj_fc2_b=(),
        codec_embd=(),
        blocks=block_specs(),
        output_norm=(),
        codec_head=(None, "tp"),
    )


def code_predictor_specs() -> CodePredictorParams:
    return CodePredictorParams(
        blocks=block_specs(),
        output_norm=(),
        embds=(),
        heads=(None, None, "tp"),
    )


def data_spec() -> tuple:
    """Batched per-utterance tensors split their leading axis over dp."""
    return ("dp",)


def _fit_spec(spec, shape, mesh: Mesh) -> tuple:
    """Drop mesh axes from dims they don't evenly divide (and pad the spec
    to the leaf's rank)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is None or shape[d] % mesh.shape[ax] == 0 else None
                 for d, ax in enumerate(spec))


def _put(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """x's block on this rank (contiguous along each split dim), on the
    mesh's device, carrying its Placement."""
    spec = _fit_spec(spec, x.shape, mesh)
    for d, ax in enumerate(spec):
        if ax is not None:
            n = x.shape[d] // mesh.shape[ax]
            x = x.narrow(d, mesh.coord(ax) * n, n)
    return place(x.contiguous().to(mesh.device), mesh, spec)


def _cols(w, idx: torch.Tensor, spec, mesh: Mesh):
    """Output columns idx of a leaf (tensor, int8 or u4), placed as split."""
    def take(t):
        return place(t.index_select(-1, idx.to(t.device)).contiguous().to(mesh.device),
                     mesh, spec)

    if isinstance(w, (QuantLinear, QuantLinear4)):
        return type(w)(*(take(t) for t in w))
    return take(w)


def _repack4(w: QuantLinear4, lo: int, hi: int):
    """The u4 leaf on logical input rows [lo, hi): split-half nibbles over
    those rows, groups of gcd(group, (hi - lo) / 2) rows, each with its
    original group's scale and offset."""
    nib_lo, nib_hi = unpack4(w.q)
    logical = torch.cat([nib_lo, nib_hi], dim=-2)[..., lo:hi, :].to(torch.int32)
    half = (hi - lo) // 2
    q = (logical[..., :half, :] | (logical[..., half:, :] << 4)).to(torch.uint8).view(torch.int8)
    gs = weight_in_dim(w) // w.scale.shape[-2]
    sub = math.gcd(gs, half)
    groups = torch.arange(lo, hi, sub, device=w.scale.device) // gs
    return QuantLinear4(q=q, scale=w.scale.index_select(-2, groups),
                        zero=w.zero.index_select(-2, groups))


def _rows(w, lo: int, hi: int, spec, mesh: Mesh):
    """Logical input rows [lo, hi) of a leaf, placed as split (an int8
    leaf's scales replicated)."""
    rep = (None,) * len(spec)
    if isinstance(w, QuantLinear4):
        return QuantLinear4(*(place(t.contiguous().to(mesh.device), mesh, spec)
                              for t in _repack4(w, lo, hi)))
    if isinstance(w, QuantLinear):
        return QuantLinear(q=place(w.q[..., lo:hi, :].contiguous().to(mesh.device), mesh, spec),
                           scale=place(w.scale.to(mesh.device), mesh, rep))
    return place(w[..., lo:hi, :].contiguous().to(mesh.device), mesh, spec)


def _replicated(w, mesh: Mesh):
    if isinstance(w, (QuantLinear, QuantLinear4)):
        return type(w)(*(_put(t, (), mesh) for t in w))
    return _put(w, (), mesh)


def _pieces(sizes, n: int, r: int, device) -> torch.Tensor:
    """Piece r of n of every segment of `sizes` (consecutive along one
    dim), concatenated: the column indices of a regrouped split."""
    out, base = [], 0
    for s in sizes:
        step = s // n
        out.append(torch.arange(base + r * step, base + (r + 1) * step, device=device))
        base += s
    return torch.cat(out)


def _out_cols(w) -> int:
    return (w.q if isinstance(w, (QuantLinear, QuantLinear4)) else w).shape[-1]


def _shard_blocks(blocks: BlockParams, specs: BlockParams, mesh: Mesh) -> BlockParams:
    """The rank's attention heads and FFN columns (regrouped, see the module
    docstring), or a replicated pair where the axis does not fit."""
    D = blocks.q_norm.shape[-1]
    Hq = weight_in_dim(blocks.wo) // D
    Hkv = (_out_cols(blocks.wqkv) // D - Hq) // 2
    F = weight_in_dim(blocks.w_down)
    out = {f: _put(getattr(blocks, f), getattr(specs, f), mesh)
           for f in ("attn_norm", "q_norm", "k_norm", "ffn_norm")}
    pairs = (("wqkv", "wo", (Hq * D, Hkv * D, Hkv * D), (Hq, Hkv), Hq * D),
             ("w_gateup", "w_down", (F, F), (F,), F))
    for col, row, segments, counts, K in pairs:
        ax = getattr(specs, col)[-1]
        n = 1 if ax is None else mesh.shape[ax]
        wc, wr = getattr(blocks, col), getattr(blocks, row)
        fits = n > 1 and all(c % n == 0 for c in counts) and (
            not isinstance(wr, QuantLinear4) or (K // n) % 2 == 0)
        if not fits:
            out[col], out[row] = _replicated(wc, mesh), _replicated(wr, mesh)
            continue
        r = mesh.coord(ax)
        dev = (wc.q if isinstance(wc, tuple) else wc).device
        out[col] = _cols(wc, _pieces(segments, n, r, dev), getattr(specs, col), mesh)
        out[row] = _rows(wr, r * K // n, (r + 1) * K // n, getattr(specs, row), mesh)
    return BlockParams(**out)


def shard_params(params, specs, mesh: Mesh):
    """This rank's local params (TalkerParams or CodePredictorParams, any
    weight tier: float32, bf16, int8 ``QuantLinear``, u4 ``QuantLinear4``)
    on the mesh's device, each leaf carrying its Placement. The caller's
    params are left as they are."""
    if isinstance(params, BlockParams):
        return _shard_blocks(params, specs, mesh)
    fields = getattr(params, "_fields", None)
    if fields is not None and not isinstance(params, (QuantLinear, QuantLinear4)):
        return type(params)(*(shard_params(getattr(params, f), getattr(specs, f), mesh)
                              for f in fields))
    if isinstance(params, (QuantLinear, QuantLinear4)):
        return type(params)(*(_put(t, specs, mesh) for t in params))
    return _put(params, specs, mesh)


def local_config(cfg, blocks: BlockParams):
    """cfg with this rank's head counts when blocks' attention is split over
    "tp" (a rank's shard computes, and caches K/V for, its heads only).
    Raises ValueError when a pair's halves disagree (one split over "tp",
    the other not: a leaf that lost its Placement, whose rank would skip
    the pair's sum and compute a partial product)."""
    for col, row in (("wqkv", "wo"), ("w_gateup", "w_down")):
        cols = split_over(getattr(blocks, col), "tp", -1)
        rows = split_over(getattr(blocks, row), "tp", -2)
        if (cols is None) != (rows is None):
            raise ValueError(f"{col} is {'not ' if cols is None else ''}split over 'tp' but "
                             f"{row} is {'not ' if rows is None else ''}split over its rows: "
                             "a sharded leaf lost its Placement")
    mesh = split_over(blocks.wqkv, "tp", -1)
    if mesh is None:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // mesh.tp,
                               n_kv_heads=cfg.n_kv_heads // mesh.tp)
