"""Content-addressed context chunking + prefix trie.

Contexts are identified by a *hash chain* over fixed-size token chunks
(CacheGen/SGLang-style):  ``h_0 = H(chunk_0)``, ``h_i = H(h_{i-1} || chunk_i)``.
Two requests share a stored prefix iff their chain hashes agree — chain
hashing makes a chunk's identity depend on everything before it, which is
exactly the validity condition for reusing attention KV (K/V at position t
depend on all tokens <= t).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_CHUNK_TOKENS = 256


def chunk_hash_chain(tokens: Sequence[int], chunk_tokens: int) -> List[str]:
    """Chain hashes for every *complete* chunk of ``tokens``."""
    toks = np.asarray(tokens, dtype=np.int32)
    n = len(toks) // chunk_tokens
    chain: List[str] = []
    h_prev = b""
    for i in range(n):
        chunk = toks[i * chunk_tokens : (i + 1) * chunk_tokens].tobytes()
        h = hashlib.sha256(h_prev + chunk).hexdigest()[:32]
        chain.append(h)
        h_prev = h.encode()
    return chain


@dataclasses.dataclass
class PrefixMatch:
    entry_id: Optional[str]
    matched_chunks: int
    matched_tokens: int
    total_chunks: int


class ChunkTrie:
    """Maps chain-hash prefixes to stored entries.

    ``insert`` registers a stored context's chain; ``longest_prefix`` walks a
    query's chain and returns the deepest stored node.  O(depth) per lookup,
    no token content retained (privacy: only salted hashes)."""

    def __init__(self, chunk_tokens: int = DEFAULT_CHUNK_TOKENS):
        self.chunk_tokens = chunk_tokens
        # chain hash -> (entry_id, chunk_index within that entry)
        self._nodes: Dict[str, Tuple[str, int]] = {}

    def insert(self, tokens: Sequence[int], entry_id: str) -> List[str]:
        chain = chunk_hash_chain(tokens, self.chunk_tokens)
        for i, h in enumerate(chain):
            # keep the first owner; identical chains are identical content
            self._nodes.setdefault(h, (entry_id, i))
        return chain

    def remove(self, tokens_or_chain: Sequence, entry_id: str) -> None:
        chain = (
            list(tokens_or_chain)
            if tokens_or_chain and isinstance(tokens_or_chain[0], str)
            else chunk_hash_chain(tokens_or_chain, self.chunk_tokens)
        )
        for h in chain:
            if self._nodes.get(h, (None,))[0] == entry_id:
                del self._nodes[h]

    def longest_prefix(self, tokens: Sequence[int]) -> PrefixMatch:
        chain = chunk_hash_chain(tokens, self.chunk_tokens)
        best: Optional[Tuple[str, int]] = None
        depth = 0
        for i, h in enumerate(chain):
            node = self._nodes.get(h)
            if node is None:
                break
            best, depth = node, i + 1
        if best is None:
            return PrefixMatch(None, 0, 0, len(chain))
        return PrefixMatch(best[0], depth, depth * self.chunk_tokens, len(chain))

    def __len__(self) -> int:
        return len(self._nodes)
