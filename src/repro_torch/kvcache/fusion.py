"""Fused non-prefix reuse: chunk-composite KV matching + selective recompute.

The chain-hash trie (``kvcache.chunks``) only reuses *prefix* matches: a RAG
request that retrieves the same document chunks in a different order shares
no chain prefix and recomputes everything.  CacheBlend's observation is that
the stored KV of a text chunk is *approximately* position- and
context-independent — reusing it out of place and selectively recomputing a
small fraction of high-deviation tokens recovers almost all of the quality at
a fraction of the prefill compute.

This module is the content side of that subsystem:

  * ``content_hashes`` / ``ChunkIndex`` — a position-independent per-chunk
    content index maintained alongside the chain-hash trie: each complete
    chunk is keyed by a hash of its *own* tokens only, so a stored chunk is
    findable at any offset of any query.
  * ``CompositeMatch`` — the index's answer for one query context: a span
    partition into maximal reused runs (with their source entry + source row
    offset) and recompute gaps.
  * ``select_recompute`` — CacheBlend's r-fraction knob: picks exactly
    ``ceil(r * matched_tokens)`` tokens inside the reused spans to recompute
    (the *head* of each span — the cross-chunk boundary tokens whose KV
    deviates most), yielding a ``FusedSchedule`` of execution spans.

The port carries only this host half, which the tiered store's chunk index
and the planners read.  The launch assembly (``fused_layout``,
``fused_arrays``, ``build_fused_caches``) and the fused prefill kernel are
ROADMAP queue A item 7; ``EngineConfig(fusion_enabled=True)`` raises until
then.

At ``recompute_frac=1.0`` every reused token is recomputed, so the fused
launch degenerates to an ordinary full prefill — the bit-exactness anchor
``tests/test_fusion.py`` pins at kernel/model/engine level.  At r < 1 the
output is an approximation (the reused KV misses cross-chunk attention), the
same contract as the lossy int8 storage tier.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kvcache.chunks import DEFAULT_CHUNK_TOKENS


def content_hashes(tokens: Sequence[int], chunk_tokens: int) -> List[str]:
    """Position-independent hash for every *complete* chunk of ``tokens``
    (cf. ``chunks.chunk_hash_chain``, whose hashes chain over everything
    before the chunk — here a chunk's identity is its own content only)."""
    toks = np.asarray(tokens, dtype=np.int32)
    n = len(toks) // chunk_tokens
    return [
        hashlib.sha256(
            b"chunk:" + toks[i * chunk_tokens : (i + 1) * chunk_tokens].tobytes()
        ).hexdigest()[:32]
        for i in range(n)
    ]


# --------------------------------------------------------------------------- #
# Spans / match
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FusedSpan:
    """One token range of a query context: either served from a stored
    entry's rows (``reuse``) or prefilled from scratch (``recompute``)."""

    start: int  # query-context token range [start, end)
    end: int
    kind: str  # "reuse" | "recompute"
    entry_id: Optional[str] = None  # reuse spans: the source entry...
    src_start: int = -1  # ...and the row offset inside it
    chunk_hashes: Tuple[str, ...] = ()  # content hashes (chunk-aligned spans)

    @property
    def n_tokens(self) -> int:
        return self.end - self.start


def rows_by_entry(spans: Sequence[FusedSpan]) -> Dict[str, int]:
    """entry_id -> total reused rows it sources across ``spans`` — the one
    aggregation planners (fetch-byte pricing) and the engine (fetch billing)
    both consume."""
    out: Dict[str, int] = {}
    for s in spans:
        if s.kind == "reuse":
            out[s.entry_id] = out.get(s.entry_id, 0) + s.n_tokens
    return out


@dataclasses.dataclass(frozen=True)
class CompositeMatch:
    """The chunk index's view of one query context: an ordered span
    partition of ``[0, total_tokens)`` into maximal reused runs (adjacent
    matched chunks from the same entry at consecutive source rows merge)
    and recompute gaps (unmatched chunks + the trailing partial chunk)."""

    spans: Tuple[FusedSpan, ...]
    total_tokens: int
    chunk_tokens: int

    @property
    def matched_tokens(self) -> int:
        return sum(s.n_tokens for s in self.spans if s.kind == "reuse")

    @property
    def reuse_spans(self) -> Tuple[FusedSpan, ...]:
        return tuple(s for s in self.spans if s.kind == "reuse")

    @property
    def source_entries(self) -> Tuple[str, ...]:
        return tuple(rows_by_entry(self.spans))

    def rows_by_entry(self) -> Dict[str, int]:
        return rows_by_entry(self.spans)

    @property
    def coverage(self) -> float:
        return self.matched_tokens / max(self.total_tokens, 1)

    @staticmethod
    def miss(total_tokens: int, chunk_tokens: int) -> "CompositeMatch":
        spans = (
            (FusedSpan(0, total_tokens, "recompute"),) if total_tokens else ()
        )
        return CompositeMatch(spans, total_tokens, chunk_tokens)


class ChunkIndex:
    """Content-hash -> owner list map over stored contexts.

    The position-independent sibling of ``chunks.ChunkTrie``: ``insert``
    registers every complete chunk of a stored context under its content
    hash, ``match`` walks a query's chunks and assembles a
    :class:`CompositeMatch`.  Identical content may live in several entries;
    every owner is kept (matches use the earliest-registered one) so
    evicting one entry does not orphan a chunk another live entry still
    holds.  O(chunks) per call, token content never retained."""

    def __init__(self, chunk_tokens: int = DEFAULT_CHUNK_TOKENS):
        self.chunk_tokens = chunk_tokens
        # content hash -> [(entry_id, chunk index within that entry), ...]
        # in registration order; [0] is the owner served by ``match``
        self._nodes: Dict[str, List[Tuple[str, int]]] = {}

    def insert(self, tokens: Sequence[int], entry_id: str) -> List[str]:
        hashes = content_hashes(tokens, self.chunk_tokens)
        for i, h in enumerate(hashes):
            self._nodes.setdefault(h, []).append((entry_id, i))
        return hashes

    def remove(self, hashes_or_tokens: Sequence, entry_id: str) -> None:
        hashes = (
            list(hashes_or_tokens)
            if hashes_or_tokens and isinstance(hashes_or_tokens[0], str)
            else content_hashes(hashes_or_tokens, self.chunk_tokens)
        )
        for h in hashes:
            owners = self._nodes.get(h)
            if owners is None:
                continue
            owners[:] = [o for o in owners if o[0] != entry_id]
            if not owners:
                del self._nodes[h]

    def match(self, tokens: Sequence[int]) -> CompositeMatch:
        c = self.chunk_tokens
        total = len(tokens)
        hashes = content_hashes(tokens, c)
        spans: List[FusedSpan] = []

        def add_recompute(start: int, end: int) -> None:
            if end <= start:
                return
            if spans and spans[-1].kind == "recompute":
                spans[-1] = dataclasses.replace(spans[-1], end=end)
            else:
                spans.append(FusedSpan(start, end, "recompute"))

        for i, h in enumerate(hashes):
            owners = self._nodes.get(h)
            start = i * c
            if not owners:
                add_recompute(start, start + c)
                continue
            eid, src_chunk = owners[0]
            prev = spans[-1] if spans else None
            if (
                prev is not None
                and prev.kind == "reuse"
                and prev.entry_id == eid
                and prev.end == start
                and prev.src_start + prev.n_tokens == src_chunk * c
            ):
                # consecutive source chunks: extend the maximal run
                spans[-1] = dataclasses.replace(
                    prev, end=start + c, chunk_hashes=prev.chunk_hashes + (h,)
                )
            else:
                spans.append(
                    FusedSpan(
                        start, start + c, "reuse", entry_id=eid,
                        src_start=src_chunk * c, chunk_hashes=(h,),
                    )
                )
        add_recompute(len(hashes) * c, total)  # trailing partial chunk
        return CompositeMatch(tuple(spans), total, c)

    def __len__(self) -> int:
        return len(self._nodes)


# --------------------------------------------------------------------------- #
# Selective recompute: the r-fraction schedule
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FusedSchedule:
    """A :class:`CompositeMatch` refined by the chosen recompute fraction:
    the execution span partition (reused tails + recompute heads/gaps), with
    exactly ``ceil(r * matched_tokens)`` tokens selected for recompute
    inside the match's reused spans."""

    match: CompositeMatch
    recompute_frac: float
    spans: Tuple[FusedSpan, ...]  # execution spans, still a partition
    reused_tokens: int  # context tokens served from stored KV
    recompute_tokens: int  # context tokens prefilled (selected + unmatched)
    selected_tokens: int  # == ceil(r * match.matched_tokens)

    @property
    def source_entries(self) -> Tuple[str, ...]:
        return tuple(rows_by_entry(self.spans))

    def rows_by_entry(self) -> Dict[str, int]:
        return rows_by_entry(self.spans)


def select_recompute(match: CompositeMatch, recompute_frac: float) -> FusedSchedule:
    """Pick ``ceil(r * matched_tokens)`` tokens of the reused spans to
    recompute and return the execution schedule.

    Selection is deterministic: the budget is apportioned across reused
    spans proportionally (floor + largest-remainder, ties to earlier spans)
    and each span recomputes its *head* — the tokens right after a content
    discontinuity, whose KV deviates most from the stored values (the
    CacheBlend heuristic, made deterministic).  At r=1.0 every reused token
    is selected and the schedule is one big recompute span: the fused launch
    is then an ordinary full prefill (the bit-exactness anchor)."""
    r = min(max(float(recompute_frac), 0.0), 1.0)
    reuse_spans = match.reuse_spans
    m_total = match.matched_tokens
    budget = int(math.ceil(r * m_total))

    heads = {id(s): int(math.floor(r * s.n_tokens)) for s in reuse_spans}
    rem = budget - sum(heads.values())
    if rem > 0:
        by_frac = sorted(
            enumerate(reuse_spans),
            key=lambda t: (-(r * t[1].n_tokens - heads[id(t[1])]), t[0]),
        )
        for _, s in by_frac[:rem]:
            heads[id(s)] += 1

    out: List[FusedSpan] = []

    def add(span: FusedSpan) -> None:
        if span.n_tokens <= 0:
            return
        if (
            out
            and span.kind == "recompute"
            and out[-1].kind == "recompute"
            and out[-1].end == span.start
        ):
            out[-1] = dataclasses.replace(out[-1], end=span.end)
        else:
            out.append(span)

    for s in match.spans:
        if s.kind == "recompute":
            add(s)
            continue
        k = heads[id(s)]
        if k > 0:
            add(FusedSpan(s.start, s.start + k, "recompute"))
        if k < s.n_tokens:
            # chunk hashes no longer line up with a head-trimmed span
            add(
                FusedSpan(
                    s.start + k, s.end, "reuse",
                    entry_id=s.entry_id, src_start=s.src_start + k,
                )
            )
    reused = sum(s.n_tokens for s in out if s.kind == "reuse")
    return FusedSchedule(
        match=match,
        recompute_frac=r,
        spans=tuple(out),
        reused_tokens=reused,
        recompute_tokens=match.total_tokens - reused,
        selected_tokens=budget,
    )
