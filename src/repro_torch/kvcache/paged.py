"""Context state between the device caches and the storage tier.

The device-side cache is slotted-dense: one batch slot per active sequence.
The stored artifact of a context of L tokens is that slot's slice of the
context state, as a host ``LMState`` tree of numpy arrays in the reference's
layout:

  * attention layers: K/V rows ``[0, L)``, ``[n_layers, 1, L, KV, hd]``
    (O(L) bytes);
  * Mamba/SSD layers: the conv tail ``[n_layers, 1, d_conv-1, conv_dim]``
    in the model dtype and the SSD state ``[n_layers, 1, H, P, S]`` in f32
    (O(1) bytes, all or nothing);
  * an encoder-decoder: an ``EncDecState`` holding the audio's decoder
    cross K/V ``[n_dec, 1, S_enc, KV, hd]`` (O(L_enc) bytes), an empty
    self K/V and ``pos`` 0, since the decoder restarts at position 0 on
    reuse.

bf16 rows are kept as their 2-byte pattern (``uint16``), so byte accounting
matches the reference's; an f32 artifact is the same tree, byte for byte,
as the reference's.

Under paged decode the device state is instead one shared KV block pool
(``init_pool_caches``): host-side ``PagedSlots`` keep each slot's block
table, and packed admissions land their block-aligned spans in the pool.

This is the port of the reference's ``kvcache/paged.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import BlockCache
from repro_torch.models.common import resolve_device, resolve_dtype
from repro_torch.models.encdec import EncDecState
from repro_torch.models.lm import LMState
from repro_torch.models.ssm import MambaState


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


def _map_cache(c: BlockCache, fn) -> BlockCache:
    """``fn`` over a ``BlockCache``'s arrays, keeping its structure."""
    if c.attn is not None:
        return BlockCache(KVCache(fn(c.attn.k), fn(c.attn.v)))
    return BlockCache(None, MambaState(fn(c.mamba.conv), fn(c.mamba.ssd)))


def _host_pos(pos) -> np.ndarray:
    return np.asarray(pos.cpu() if isinstance(pos, torch.Tensor) else pos, np.int32)


def artifact_to_host(art):
    """A device-side artifact (``packed_to_artifact``, ``slot_artifact``) as a
    host tree."""
    if isinstance(art, EncDecState):
        return EncDecState(
            pos=_host_pos(art.pos),
            self_kv=KVCache(to_host(art.self_kv.k), to_host(art.self_kv.v)),
            cross_kv=KVCache(to_host(art.cross_kv.k), to_host(art.cross_kv.v)),
        )
    return LMState(pos=_host_pos(art.pos),
                   caches=tuple(_map_cache(c, to_host) for c in art.caches))


def artifact_length(artifact) -> int:
    """The token count of the context an artifact holds (its ``pos``; 0 for
    an encoder-decoder's, whose decoder restarts at position 0)."""
    p = artifact.pos
    return int(p[0].item() if isinstance(p, torch.Tensor) else np.asarray(p)[0])


# --------------------------------------------------------------------------- #
# Extract / insert: one slot of the batched device state
# --------------------------------------------------------------------------- #
def slot_artifact(state, slot: int, length: int):
    """Slot ``slot``'s first ``length`` tokens of context state as an artifact
    of device views (an SSM layer's whole state: it is O(1) in ``length``;
    an encoder-decoder's whole cross K/V, no self K/V row and ``pos`` 0)."""
    if isinstance(state, EncDecState):
        one = slice(slot, slot + 1)
        return EncDecState(
            pos=np.zeros((1,), np.int32),
            self_kv=KVCache(state.self_kv.k[:, one, :0], state.self_kv.v[:, one, :0]),
            cross_kv=KVCache(state.cross_kv.k[:, one], state.cross_kv.v[:, one]),
        )

    def rows(t: torch.Tensor) -> torch.Tensor:
        return t[:, slot : slot + 1, :length]

    def whole(t: torch.Tensor) -> torch.Tensor:
        return t[:, slot : slot + 1]

    return LMState(
        pos=np.full((1,), length, np.int32),
        caches=tuple(_map_cache(c, rows if c.attn is not None else whole)
                     for c in state.caches),
    )


def extract_slot(cfg: ArchConfig, state, slot: int, length: int):
    """Slot ``slot``'s first ``length`` tokens of context state, on the host."""
    return artifact_to_host(slot_artifact(state, slot, length))


def insert_slot(cfg: ArchConfig, state, slot: int, artifact, n_tokens: int = None):
    """Write a context (host or device artifact) into batch slot ``slot`` in
    place, with ``pos[slot]`` set to its token count (or ``n_tokens`` for a
    partial-prefix insert of attention K/V; SSM state is all or nothing, a
    whole snapshot at the stored context's length).  An encoder-decoder's
    artifact brings its cross K/V and its self K/V rows (none for a stored
    context, the prompt's for a freshly prefilled batch-1 state) and its
    ``pos``, whatever ``n_tokens``.  Returns ``state``."""
    if isinstance(state, EncDecState):
        for dst, src in zip(state.cross_kv, artifact.cross_kv):
            dst[:, slot] = to_device(src[:, 0], dst.dtype, dst.device)
        n_self = artifact.self_kv.k.shape[2]
        for dst, src in zip(state.self_kv, artifact.self_kv):
            dst[:, slot, :n_self] = to_device(src[:, 0], dst.dtype, dst.device)
        state.pos[slot] = artifact_length(artifact)
        return state
    art_pos = artifact_length(artifact)
    L = art_pos if n_tokens is None else min(n_tokens, art_pos)
    for c, a in zip(state.caches, artifact.caches):
        if c.attn is not None:
            for dst, src in ((c.attn.k, a.attn.k), (c.attn.v, a.attn.v)):
                dst[:, slot, :L] = to_device(src[:, 0, :L], dst.dtype, dst.device)
        else:
            for dst, src in ((c.mamba.conv, a.mamba.conv), (c.mamba.ssd, a.mamba.ssd)):
                dst[:, slot] = to_device(src[:, 0], dst.dtype, dst.device)
    state.pos[slot] = L
    return state


def partial_reuse_allowed(cfg: ArchConfig) -> bool:
    """Partial-prefix reuse needs per-position state (attention KV)."""
    return cfg.family in ("dense", "moe", "vlm") and cfg.n_ssm_layers == 0


def ring_match_usable(cfg: ArchConfig, stored_tokens: int, matched: int) -> bool:
    """Whether ``matched`` leading tokens of a stored context of
    ``stored_tokens`` tokens can be served from its artifact (ROADMAP C11).

    The artifact of a sliding-window arch holds the context's last
    ``min(stored_tokens, window)`` positions in ring order, and
    ``insert_slot`` reads its rows ``[:matched]`` as positions ``0 ..
    matched - 1``.  That holds while the ring never wrapped
    (``stored_tokens <= window``), and a match of the whole stored context
    inserts the ring as it is.  Any other match needs positions ``[matched
    - window, matched)``, which the ring no longer holds: the reference
    serves it anyway and generates wrong tokens; the port does not."""
    W = cfg.sliding_window
    return not W or stored_tokens <= W or matched == stored_tokens


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
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.family} archs have no packed or pooled KV (the SSM state of SSM and "
            "hybrid stacks cannot be packed or paged; an encoder-decoder arch has no "
            "packed or paged entry point, as in the reference)"
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


# --------------------------------------------------------------------------- #
# Shared KV block pool: paged batched decode state
# --------------------------------------------------------------------------- #
KV_BLOCK = 128  # pool block size in tokens


class BlockPool:
    """Host-side bookkeeping for the shared device KV block pool.

    Block ids index one device buffer of ``n_blocks * block`` KV rows shared
    by every batch slot.  Block 0 is the reserved *dump* block: a slot whose
    block table is zeroed (freed or inactive) computes its decode write row
    inside block 0, so a stale slot never corrupts a block recycled to
    another sequence.

    Blocks are reference-counted so batch-mates that loaded the same stored
    context can point their table prefixes at ONE copy of the shared-prefix
    blocks.  ``release`` returns a block to the free list exactly once, when
    its last reference drops, and ``PagedSlots.prepare_append`` is the
    copy-on-write primitive: appending into a shared boundary block first
    splits it onto a fresh private block.
    """

    def __init__(self, n_blocks: int, block: int = KV_BLOCK):
        assert n_blocks >= 2, "need the dump block plus at least one real block"
        self.block = block
        self.n_blocks = n_blocks
        self.ref = np.zeros(n_blocks, np.int64)
        self.ref[0] = 1  # dump block: permanently held by the pool itself
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Distinct non-dump blocks currently referenced."""
        return self.n_blocks - 1 - len(self._free)

    def alloc(self, n: int) -> List[int]:
        assert n <= len(self._free), (n, len(self._free))
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self.ref[b] == 0, b
            self.ref[b] = 1
        return out

    def share(self, bid: int) -> int:
        assert 0 < bid < self.n_blocks and self.ref[bid] > 0, bid
        self.ref[bid] += 1
        return bid

    def release(self, bid: int) -> None:
        assert 0 < bid < self.n_blocks and self.ref[bid] > 0, bid
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            self._free.append(bid)

    def free_list(self) -> List[int]:
        return list(self._free)


@dataclasses.dataclass(frozen=True)
class CowSplit:
    """A copy-on-write split: pool rows of block ``src`` must be copied to
    block ``dst`` before the next write touches it."""

    src: int
    dst: int


class PagedSlots:
    """Block tables and live lengths for a batch of slots over one BlockPool.

    The engine's host-side view of the paged decode state: per-slot tables
    (0-padded, fixed width ``max_len // block``), live token counts, and the
    alloc/share/append/free lifecycle.  The device buffers are the engine's;
    this class only decides which pool blocks hold what.
    """

    def __init__(self, n_slots: int, max_len: int, block: int = KV_BLOCK):
        assert max_len % block == 0, (max_len, block)
        self.block = block
        self.nb_max = max_len // block
        # worst case every slot fills max_len with private blocks (+ dump)
        self.pool = BlockPool(1 + n_slots * self.nb_max, block)
        self.tables = np.zeros((n_slots, self.nb_max), np.int32)
        self.lens = np.zeros(n_slots, np.int64)
        self.n_blocks = np.zeros(n_slots, np.int64)  # table entries in use
        self.live = np.zeros(n_slots, bool)
        self.shared_block_hits = 0  # blocks deduped across batch-mates
        self.pool_blocks_peak = 0  # high-water distinct blocks in use

    def admit(
        self,
        slot: int,
        n_total: int,
        *,
        shared_from: Optional[int] = None,
        shared_blocks: int = 0,
    ) -> List[int]:
        """Allocate the slot's table for ``n_total`` live rows; the first
        ``shared_blocks`` entries alias slot ``shared_from``'s (same stored
        context).  Returns the NEWLY allocated block ids, the ones whose rows
        the caller must fill; shared blocks already hold the right rows."""
        assert not self.live[slot], slot
        nb = -(-n_total // self.block)
        assert 0 < nb <= self.nb_max, (n_total, self.nb_max)
        assert shared_blocks <= nb
        if shared_blocks:
            assert shared_from is not None and self.live[shared_from]
            assert shared_blocks <= self.n_blocks[shared_from]
            for j in range(shared_blocks):
                self.tables[slot, j] = self.pool.share(int(self.tables[shared_from, j]))
            self.shared_block_hits += shared_blocks
        own = self.pool.alloc(nb - shared_blocks)
        self.tables[slot, shared_blocks:nb] = own
        self.tables[slot, nb:] = 0
        self.lens[slot] = n_total
        self.n_blocks[slot] = nb
        self.live[slot] = True
        self.pool_blocks_peak = max(self.pool_blocks_peak, self.pool.n_used)
        return own

    def prepare_append(self, slot: int) -> Optional[CowSplit]:
        """Make the row for the NEXT token (position ``lens[slot]``)
        writable: grow the table by a fresh block at a block boundary, or
        copy-on-write split a shared boundary block.  Returns the split to
        copy on the device, or None.  The caller bumps ``note_token`` after
        the write lands."""
        assert self.live[slot], slot
        pos = int(self.lens[slot])
        ib = pos // self.block
        assert ib < self.nb_max, "append past max_len"
        if ib == self.n_blocks[slot]:
            (bid,) = self.pool.alloc(1)
            self.tables[slot, ib] = bid
            self.n_blocks[slot] += 1
            self.pool_blocks_peak = max(self.pool_blocks_peak, self.pool.n_used)
            return None
        bid = int(self.tables[slot, ib])
        if self.pool.ref[bid] > 1:
            (fresh,) = self.pool.alloc(1)
            self.pool.release(bid)
            self.tables[slot, ib] = fresh
            return CowSplit(src=bid, dst=fresh)
        return None

    def note_token(self, slot: int) -> None:
        self.lens[slot] += 1

    def free(self, slot: int) -> None:
        """Return the slot's blocks to the pool (each freed exactly once, on
        its last reference) and zero its table AND length, so a stale decode
        write computes a row inside the dump block (table entry 0)."""
        assert self.live[slot], slot
        for j in range(int(self.n_blocks[slot])):
            self.pool.release(int(self.tables[slot, j]))
        self.tables[slot, :] = 0
        self.lens[slot] = 0
        self.n_blocks[slot] = 0
        self.live[slot] = False

    def stats(self) -> dict:
        """One pool snapshot (``engine.decode_stats()`` embeds it under the
        paged path)."""
        return {
            "block": self.block,
            "pool_blocks": self.pool.n_blocks,
            "pool_blocks_used": self.pool.n_used,
            "pool_blocks_peak": self.pool_blocks_peak,
            "shared_block_hits": self.shared_block_hits,
            "live_slots": int(self.live.sum()),
            "live_tokens": int(self.lens[self.live].sum()),
        }

    def audit(self) -> None:
        """Pool-accounting invariants: ref counts == live table references,
        the free list disjoint from them and free of duplicates, and the used
        block count == the distinct blocks of the live table entries."""
        refs: dict = {}
        for slot in range(self.tables.shape[0]):
            if not self.live[slot]:
                assert self.n_blocks[slot] == 0
                assert not self.tables[slot].any(), slot
                continue
            for j in range(int(self.n_blocks[slot])):
                bid = int(self.tables[slot, j])
                assert bid > 0, (slot, j)
                refs[bid] = refs.get(bid, 0) + 1
        for bid in range(1, self.pool.n_blocks):
            assert self.pool.ref[bid] == refs.get(bid, 0), bid
        free = self.pool.free_list()
        assert len(free) == len(set(free))
        assert not (set(free) & set(refs)), "freed block still referenced"
        assert self.pool.n_used == len(refs)


def block_rows(block_ids, block: int) -> np.ndarray:
    """Flat pool-row indices covered by ``block_ids`` (for the engine's
    one-scatter landings and copy-on-write copies)."""
    ids = np.asarray(list(block_ids), np.int64)
    return (ids[:, None] * block + np.arange(block, dtype=np.int64)[None, :]).reshape(-1)


def init_pool_caches(
    cfg: ArchConfig, n_blocks: int, block: int = KV_BLOCK, device=None, dtype=None
) -> Tuple[BlockCache, ...]:
    """The shared KV block pool on ``device`` (the card unless the caller
    asks for another): one flat-row KV buffer ``[n_layers, n_blocks * block,
    KV, hd]``, the paged counterpart of ``lm.init_state``'s slotted caches."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.family} archs have no packed or pooled KV (the SSM state of SSM and "
            "hybrid stacks cannot be packed or paged; an encoder-decoder arch has no "
            "packed or paged entry point, as in the reference)"
        )
    device = resolve_device(device)
    dtype = dtype or resolve_dtype(cfg.dtype)
    shape = (cfg.n_layers, n_blocks * block, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (BlockCache(KVCache(torch.zeros(shape, dtype=dtype, device=device),
                               torch.zeros(shape, dtype=dtype, device=device))),)
