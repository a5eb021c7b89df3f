"""Sharding rules: parameter, context-state and batch specs per
architecture (the reference's ``distributed/sharding.py``).

Mesh axes:
  * ``pod``   — pure data parallel across pods (gradients cross pods once).
  * ``data``  — data parallel; also FSDP (parameter and optimizer sharding)
                for ``param_partition == "fsdp"`` archs.
  * ``model`` — tensor parallel: attention heads / FFN width / experts /
                SSD heads / vocab.

A spec (:class:`PartitionSpec`, ``P``) has one entry per tensor dim:
``None`` (replicated), an axis name, or a tuple of names (the dim split
over those axes, major first), with the reference's ``PartitionSpec``
meaning.  ``to_placements`` turns one into the DTensor placements of a
``DeviceMesh``.  Every rule is divisibility-guarded: a dim shards only if
the axis size divides it (MQA's single KV head replicates; qwen2's 12 query
heads do not split 16 ways, so the head_dim shards instead).

The port keeps one dict per layer where the reference stacks each layer
weight on a leading scan axis, so a port spec is the reference's without
that axis's leading ``None``.  The reference's three environment switches
are keyword arguments here, with its defaults: ``attn_fallback`` (its
``REPRO_ATTN_SHARDING``), ``kv_shard`` (``REPRO_ATTN_KV_SHARD=1``) and
``kv_cache_fallback`` (``REPRO_KV_CACHE_SHARDING``).

``mesh`` is a ``DeviceMesh`` or any object with the axis names in
``axis_names`` and their sizes in a ``shape`` dict (specs need sizes, not
devices).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, lm
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import BlockCache
from repro_torch.models.encdec import EncDecState
from repro_torch.models.lm import LMState
from repro_torch.models.ssm import MambaState

POD, DATA, MODEL = "pod", "data", "model"
# attention weights whose head count does not divide the model axis: shard
# head_dim ("hd", partial sums in the contractions) or replicate the
# projection ("replicate", classic GQA tensor parallelism)
FALLBACKS = ("hd", "replicate")


def _entry(e: Any) -> Any:
    """An entry in its normal form, as the reference's ``PartitionSpec``
    keeps it: a tuple of one name is that name, an empty tuple ``None``."""
    if isinstance(e, tuple):
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec:
    """An immutable spec: one entry per tensor dim (``None``, an axis name
    or a tuple of names).  It iterates, indexes and compares as the tuple of
    its entries; trees treat it as a leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts: Any):
        object.__setattr__(self, "_parts", tuple(_entry(e) for e in parts))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        return isinstance(other, tuple) and self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}"


P = PartitionSpec


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mesh-like object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def axis_size(mesh: Any, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in (POD, DATA) if a in axes)


def _div(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


def _batch_spec(mesh: Any, batch: int):
    """The batch dim's entry: the batch axes where their product divides
    ``batch``, else replicated."""
    baxes = batch_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= axis_size(mesh, a)
    return baxes if (baxes and _div(batch, bsize)) else None


def _map_named(tree: Any, fn, name: str = "") -> Any:
    """``fn(leaf name, leaf)`` over a parameter tree (dicts and lists); a
    leaf's name is its dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(v, fn, name) for v in tree]
    return fn(name, tree)


# --------------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------------- #
def param_specs(cfg: ArchConfig, params: Any, mesh: Any, *, attn_fallback: str = "hd") -> Any:
    """A spec tree parallel to ``params`` (tensors on any device, ``meta``
    included: ``init(cfg, device="meta")`` gives a full-size arch's
    shapes)."""
    if attn_fallback not in FALLBACKS:
        raise ValueError(f"attn_fallback {attn_fallback!r} not in {FALLBACKS}")
    m = axis_size(mesh, MODEL)
    d = axis_size(mesh, DATA)
    fsdp = cfg.param_partition == "fsdp"
    replicate_odd = attn_fallback == "replicate"

    def fs(dim: int) -> Optional[str]:
        return DATA if (fsdp and _div(dim, d)) else None

    def md(dim: int) -> Optional[str]:
        return MODEL if _div(dim, m) else None

    def head_fb(hd: int) -> Optional[str]:
        return None if replicate_odd else md(hd)

    def leaf_spec(name: str, x) -> P:
        shape = tuple(x.shape)

        def out(*spec):
            return P(*spec, *([None] * (len(shape) - len(spec))))

        # ---- embeddings: vocab-sharded only -------------------------------
        if name == "table":
            return out(md(shape[0]), None)
        if name == "head":
            return out(None, md(shape[1]))
        if name == "dec_pos":
            return out(None, fs(shape[1]))
        # ---- attention ----------------------------------------------------
        if name == "wq":
            h, hd = shape[1], shape[2]
            return out(fs(shape[0]), md(h), None if _div(h, m) else head_fb(hd))
        if name in ("wk", "wv"):
            kv, hd = shape[1], shape[2]
            return out(fs(shape[0]), md(kv), None if _div(kv, m) else head_fb(hd))
        if name == "wo":
            h, hd = shape[0], shape[1]
            return out(md(h), None if _div(h, m) else head_fb(hd), fs(shape[2]))
        if name == "bq":
            h, hd = shape
            return out(md(h), None if _div(h, m) else head_fb(hd))
        if name in ("bk", "bv"):
            kv, hd = shape
            return out(md(kv), None if _div(kv, m) else head_fb(hd))
        # ---- MoE: FSDP on the experts' output dim, never the contraction --
        if name == "router":
            return out(fs(shape[0]), None)
        if name in ("w_gate", "w_up") and len(shape) == 3:  # [E, D, F]
            e = shape[0]
            return out(md(e), None, fs(shape[2]) if _div(e, m) else md(shape[2]))
        if name == "w_down" and len(shape) == 3:  # [E, F, D]
            e = shape[0]
            return out(md(e), None if _div(e, m) else md(shape[1]), fs(shape[2]))
        # ---- dense MLP ------------------------------------------------------
        if name in ("w_gate", "w_up", "w1"):
            return out(fs(shape[0]), md(shape[1]))
        if name in ("w_down", "w2"):
            return out(md(shape[0]), fs(shape[1]))
        if name == "b1":
            return out(md(shape[0]))
        # ---- Mamba / SSD ----------------------------------------------------
        if name in ("in_proj", "in_proj_z", "in_proj_x", "in_proj_dt"):
            return out(fs(shape[0]), md(shape[1]))
        if name == "out_proj":
            return out(md(shape[0]), fs(shape[1]))
        if name == "conv_w":
            return out(None, md(shape[1]))
        if name in ("conv_b", "norm_w", "A_log", "D_skip", "dt_bias"):
            return out(md(shape[0]))
        # ---- norms and everything else: replicated ------------------------
        return out()

    return _map_named(params, leaf_spec)


# --------------------------------------------------------------------------- #
# Context-state specs (the structure of the model's init_state)
# --------------------------------------------------------------------------- #
def state_specs(cfg: ArchConfig, batch: int, mesh: Any, *, kv_shard: bool = False,
                kv_cache_fallback: str = "hd") -> Any:
    """The spec tree of ``init_state(cfg, batch, ...)``.  ``kv_shard``
    shards each K/V cache along its length over ``model`` (the layout of
    ``ops.flash_attention(..., kv_group=...)``); otherwise a cache shards
    its KV heads, or where they do not divide ``model`` its head_dim
    (``kv_cache_fallback="hd"``) or nothing (``"replicate"``).  The cache's
    fallback is a knob of its own: a replicated cache can outgrow the
    card's memory in long-context decode."""
    if kv_cache_fallback not in FALLBACKS:
        raise ValueError(f"kv_cache_fallback {kv_cache_fallback!r} not in {FALLBACKS}")
    m = axis_size(mesh, MODEL)
    b = _batch_spec(mesh, batch)

    def md(dim: int) -> Optional[str]:
        return MODEL if _div(dim, m) else None

    if cfg.family == "encdec":
        kv = cfg.n_kv_heads
        kv_spec = KVCache(P(None, b, None, md(kv), None), P(None, b, None, md(kv), None))
        return EncDecState(pos=P(b), self_kv=kv_spec, cross_kv=kv_spec)

    kinds, _ = lm._layout(cfg)

    def per_kind(kind: blocks.BlockKind) -> BlockCache:
        if kind.mixer == "a":
            kv = cfg.n_kv_heads
            if kv_shard:
                spec = P(None, b, MODEL, None, None)
                return BlockCache(KVCache(spec, spec), None)
            tail = None if kv_cache_fallback == "replicate" else md(cfg.resolved_head_dim)
            spec = P(None, b, None, md(kv), None if _div(kv, m) else tail)
            return BlockCache(KVCache(spec, spec), None)
        s = cfg.ssm
        d_in = s.d_inner(cfg.d_model)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        h = s.n_ssm_heads(cfg.d_model)
        return BlockCache(None, MambaState(conv=P(None, b, None, md(conv_dim)),
                                           ssd=P(None, b, md(h), None, None)))

    return LMState(pos=P(b), caches=tuple(per_kind(k) for k in kinds))


# --------------------------------------------------------------------------- #
# Batch (token / embed / label) specs
# --------------------------------------------------------------------------- #
def data_specs(cfg: ArchConfig, batch_kwargs: Dict[str, Any], batch: int, mesh: Any,
               **state_kw: Any) -> Dict[str, Any]:
    """Specs of a step's batch: every leaf sharded on its leading (batch)
    dim over the batch axes where they divide ``batch``; ``state`` by
    ``state_specs`` (``state_kw`` its keywords)."""
    b = _batch_spec(mesh, batch)
    out = {}
    for k, v in batch_kwargs.items():
        if k == "state":
            out[k] = state_specs(cfg, batch, mesh, **state_kw)
        else:
            out[k] = P(b, *([None] * (len(v.shape) - 1)))
    return out


def spec_dim(spec: P, name: str) -> Optional[int]:
    """The tensor dim whose entry in ``spec`` names the mesh axis ``name``,
    or None."""
    dims = [i for i, entry in enumerate(spec)
            if entry == name or (isinstance(entry, tuple) and name in entry)]
    return dims[0] if dims else None


def to_placements(spec: P, mesh: Any) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``),
    one per mesh dim: ``Shard(i)`` where tensor dim ``i``'s entry names
    that mesh dim, else ``Replicate()`` (the reference's ``to_named``)."""
    dims = [spec_dim(spec, name) for name in mesh.mesh_dim_names]
    return tuple(Replicate() if d is None else Shard(d) for d in dims)
