"""Context state between the device caches and the storage tier.

The device-side cache is slotted-dense: one batch slot per active sequence.
The stored artifact of a context of L tokens is that slot's K/V rows
``[0, L)``, as a host ``LMState`` tree of numpy arrays in the reference's
layout (``[n_layers, 1, L, KV, hd]``).  bf16 rows are kept as their 2-byte
pattern (``uint16``), so byte accounting matches the reference's; an f32
artifact is the same tree, byte for byte, as the reference's.

This is the array half of the reference's ``kvcache/paged.py`` that the
packed-prefill, dense-decode path needs.  The shared block pool of paged
decode (``BlockPool``, ``PagedSlots``) comes with ``paged_decode``, ROADMAP
queue B item 4.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import BlockCache
from repro_torch.models.common import resolve_dtype
from repro_torch.models.lm import LMState


# --------------------------------------------------------------------------- #
# Host <-> device arrays (bf16 as its bit pattern on the host)
# --------------------------------------------------------------------------- #
def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of it): bf16 becomes uint16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def to_device(a: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array (or tensor) as ``dtype`` on ``device``; a uint16 array
    is read back as the bf16 pattern ``to_host`` wrote."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        if dtype != torch.bfloat16:
            raise TypeError(f"a uint16 (bf16 pattern) artifact cannot load as {dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def artifact_to_host(art: LMState) -> LMState:
    """A device-side artifact (``packed_to_artifact``) as a host tree."""
    return LMState(
        pos=np.asarray(art.pos.cpu() if isinstance(art.pos, torch.Tensor) else art.pos,
                       np.int32),
        caches=tuple(
            BlockCache(KVCache(to_host(c.attn.k), to_host(c.attn.v))) for c in art.caches
        ),
    )


def _pos(artifact: LMState) -> int:
    p = artifact.pos
    return int(p[0].item() if isinstance(p, torch.Tensor) else np.asarray(p)[0])


# --------------------------------------------------------------------------- #
# Extract / insert: one slot of the batched device state
# --------------------------------------------------------------------------- #
def extract_slot(cfg: ArchConfig, state: LMState, slot: int, length: int) -> LMState:
    """Slot ``slot``'s first ``length`` tokens of context state, on the host."""
    return LMState(
        pos=np.full((1,), length, np.int32),
        caches=tuple(
            BlockCache(KVCache(
                to_host(c.attn.k[:, slot : slot + 1, :length]),
                to_host(c.attn.v[:, slot : slot + 1, :length]),
            ))
            for c in state.caches
        ),
    )


def insert_slot(
    cfg: ArchConfig, state: LMState, slot: int, artifact: LMState, n_tokens: int = None
) -> LMState:
    """Write a context (host or device artifact) into batch slot ``slot`` in
    place, with ``pos[slot]`` set to its token count (or ``n_tokens`` for a
    partial-prefix insert).  Returns ``state``."""
    art_pos = _pos(artifact)
    L = art_pos if n_tokens is None else min(n_tokens, art_pos)
    for c, a in zip(state.caches, artifact.caches):
        for dst, src in ((c.attn.k, a.attn.k), (c.attn.v, a.attn.v)):
            dst[:, slot, :L] = to_device(src[:, 0, :L], dst.dtype, dst.device)
    state.pos[slot] = L
    return state


def partial_reuse_allowed(cfg: ArchConfig) -> bool:
    """Partial-prefix reuse needs per-position state (attention KV)."""
    return cfg.family in ("dense", "moe", "vlm") and cfg.n_ssm_layers == 0


# --------------------------------------------------------------------------- #
# Packed ragged prefill: layout + multi-slot insertion
# --------------------------------------------------------------------------- #
def packable_arch(cfg: ArchConfig, max_len: int) -> bool:
    """Whether batched admission may pack this arch's suffix-prefills into one
    ragged sequence: per-position attention state and no ring-buffer cache
    (``sliding_window < max_len``)."""
    return (
        cfg.family in ("dense", "moe", "vlm")
        and cfg.n_ssm_layers == 0
        and not (cfg.sliding_window and cfg.sliding_window < max_len)
    )


@dataclasses.dataclass(frozen=True)
class PackSegment:
    """One request's span of the packed sequence (all indices host-static)."""

    slot: int  # batch slot the outputs scatter back into
    kv_start: int  # first packed kv row of this segment (align-multiple)
    q_start: int  # first packed q index of this segment's new tokens
    matched: int  # reused prefix rows preloaded at [kv_start, kv_start+matched)
    n_new: int  # new (tail + prompt) tokens prefilled by the kernel
    n_total: int  # matched + n_new == rows valid after prefill

    @property
    def q_last(self) -> int:
        return self.q_start + self.n_new - 1


@dataclasses.dataclass(frozen=True)
class PackLayout:
    """Packed-sequence geometry for one admission batch.

    Every segment's kv span starts at a multiple of ``align``, so a kv tile
    never mixes segments and the kernel skips the cross-segment tiles whole.
    The q side is padding-free: new-token runs concatenate densely and only
    the total pads up to the power-of-two bucket."""

    segments: Tuple[PackSegment, ...]
    q_len: int  # bucketed total q length
    kv_len: int  # bucketed total kv length
    q_tokens: int  # sum of n_new (un-padded)

    @property
    def occupancy(self) -> float:
        """Useful fraction of the padded q sequence the kernel runs over."""
        return self.q_tokens / max(self.q_len, 1)


def pack_bucket(n: int, minimum: int = 16) -> int:
    """Round up to a power-of-two bucket, so steady traffic reuses a small
    closed set of launch shapes."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def pack_layout(
    slots: List[int],
    matched: List[int],
    n_new: List[int],
    *,
    align: int = 128,
    bucket_min: int = 16,
) -> PackLayout:
    segs: List[PackSegment] = []
    kv_off = 0
    q_off = 0
    for slot, m, n in zip(slots, matched, n_new):
        total = m + n
        segs.append(
            PackSegment(
                slot=slot, kv_start=kv_off, q_start=q_off,
                matched=m, n_new=n, n_total=total,
            )
        )
        kv_off += -(-total // align) * align
        q_off += n
    return PackLayout(
        segments=tuple(segs),
        q_len=pack_bucket(q_off, bucket_min),
        kv_len=pack_bucket(kv_off, max(align, bucket_min)),
        q_tokens=q_off,
    )


def build_packed_caches(
    cfg: ArchConfig, layout: PackLayout, artifacts: List[Any], device, dtype=None
) -> Tuple[BlockCache, ...]:
    """Packed KV buffers ``[n_layers, 1, kv_len + 1, KV, hd]`` on ``device``,
    with every segment's reused prefix rows copied in at its kv span — the
    multi-slot insertion of the load path.  ``artifacts[i]`` is segment i's
    stored artifact (or None for recompute).  The extra last row is the
    scratch row the padding tokens' K/V land on."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.family} archs are not ported yet (ROADMAP queue A item 12)"
        )
    dtype = dtype or resolve_dtype(cfg.dtype)
    shape = (cfg.n_layers, 1, layout.kv_len + 1, cfg.n_kv_heads, cfg.resolved_head_dim)
    k_buf = torch.zeros(shape, dtype=dtype, device=device)
    v_buf = torch.zeros(shape, dtype=dtype, device=device)
    for seg, art in zip(layout.segments, artifacts):
        if art is None or seg.matched <= 0:
            continue
        rows = slice(seg.kv_start, seg.kv_start + seg.matched)
        a = art.caches[0].attn
        k_buf[:, :, rows] = to_device(a.k[:, :, : seg.matched], dtype, device)
        v_buf[:, :, rows] = to_device(a.v[:, :, : seg.matched], dtype, device)
    return (BlockCache(KVCache(k_buf, v_buf)),)


def pack_arrays(layout: PackLayout, new_tokens: List[List[int]]) -> dict:
    """Host-side index arrays driving the packed launch: tokens, segment-local
    q/kv positions, segment ids, kv landing rows (padding lands on the
    scratch row ``kv_len``), all int32 except the int64 rows."""
    Sq, Skv = layout.q_len, layout.kv_len
    tokens = np.zeros((1, Sq), np.int32)
    q_pos = np.full((1, Sq), -(2**30), np.int32)
    q_seg = np.full((1, Sq), -1, np.int32)
    q_rows = np.full((1, Sq), Skv, np.int64)
    kv_pos = np.full((1, Skv), -1, np.int32)
    kv_seg = np.full((1, Skv), -2, np.int32)
    for i, (seg, toks) in enumerate(zip(layout.segments, new_tokens)):
        assert len(toks) == seg.n_new, (len(toks), seg)
        q = slice(seg.q_start, seg.q_start + seg.n_new)
        tokens[0, q] = toks
        q_pos[0, q] = np.arange(seg.matched, seg.n_total, dtype=np.int32)
        q_seg[0, q] = i
        q_rows[0, q] = np.arange(seg.kv_start + seg.matched, seg.kv_start + seg.n_total)
        rows = slice(seg.kv_start, seg.kv_start + seg.n_total)
        kv_pos[0, rows] = np.arange(seg.n_total, dtype=np.int32)
        kv_seg[0, rows] = i
    return {
        "tokens": tokens, "q_pos": q_pos, "q_seg": q_seg, "q_rows": q_rows,
        "kv_pos": kv_pos, "kv_seg": kv_seg,
    }


def packed_to_artifact(
    cfg: ArchConfig, caches: Tuple[BlockCache, ...], seg: PackSegment, n: int
) -> LMState:
    """One segment's first ``n`` rows of the packed buffers as a batch-1
    artifact of device views — the bridge to ``insert_slot`` (slot
    installation) and, through ``artifact_to_host``, to write-back."""
    rows = slice(seg.kv_start, seg.kv_start + n)
    return LMState(
        pos=np.full((1,), n, np.int32),
        caches=tuple(
            BlockCache(KVCache(c.attn.k[:, :, rows], c.attn.v[:, :, rows])) for c in caches
        ),
    )
