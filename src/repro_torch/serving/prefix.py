"""Cross-request prefix caching: a token-keyed trie over slot-cache rows
(the port of ``repro.serving.prefix``, plain Python, copied).

Millions of users share system prompts and few-shot prefixes, yet without
this module every admission re-prefills from token 0. The fix rides an
invariant the serving stack already guarantees: a slot's cache row after
prefilling tokens ``t[0:p]`` on the engine's prefill-chunk grid is a PURE
function of those tokens and the grid — pads never leak into attention
rings (pad writes are suppressed and ring validity derives from ``pos``)
or recurrent carries, RWKV's and Mamba's (pads leave the state unchanged
and the carries are taken at the last real token), and chunk plans are a function of prompt length,
never scheduling. So a
row snapshotted at a chunk boundary
(:func:`repro_torch.models.transformer.extract_cache_row`) can be copied
into ANY later request's slot
(:func:`repro_torch.models.transformer.adopt_prefix`) and the continued
prefill is bit-identical to a cold one — on full-attention rings and
boundary-aligned bounded (SWA/chunked) rings alike, which is why nodes
live only on the grid.

The trie is a flat dict keyed by exact token tuples whose lengths are
multiples of ``grid`` (= the engine's ``prefill_chunk``); a key's parent
is the key minus its last grid segment. Exact-tuple keys make aliasing of
divergent prefixes impossible by construction — two prompts sharing k
tokens hit the same node for boundaries <= k and different nodes after.
``lookup`` returns the LONGEST cached boundary prefix strictly shorter
than the query (at least one token must always be fed so the final chunk
can emit first-token logits). Nodes are refcounted: the engine pins a hit
node for the duration of the adopting request's prefill, and LRU eviction
under ``max_nodes`` pressure skips pinned nodes — an evicted node is
popped from the dict, so it can never be served again.

The same trie doubles as a shared n-gram drafter corpus
(:class:`repro_torch.serving.speculative.NgramDrafter` falls back to
:meth:`sequences` after its own-history lookup misses): cached prefixes
are exactly the text many requests share, so they are strong draft
material. Corpus-driven proposals can change TICK counts between runs
with different trie contents, never token streams — the verify step only
ever accepts what the committed stream would have produced.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrefixNode:
    """One cached boundary: the slot-cache row for tokens ``key``.

    ``row`` is the batch-of-1 cache row snapshotted by
    ``extract_cache_row`` (attention K/V rings at ``pos == len(key)``,
    RWKV or Mamba carries after ``len(key)`` tokens). ``refs`` pins the node against
    eviction while an adopting request is still prefilling; ``stamp`` is
    the LRU clock value of the last lookup hit or insert.
    """

    key: tuple
    row: object
    refs: int = 0
    stamp: int = 0

    @property
    def length(self) -> int:
        return len(self.key)


class PrefixCache:
    """Refcounted LRU trie of prefill-chunk-boundary cache rows."""

    def __init__(self, grid: int, max_nodes: int = 256, on_event=None):
        if grid < 1:
            raise ValueError(f"grid must be >= 1, got {grid}")
        if max_nodes < 1:
            raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
        self.grid = int(grid)
        self.max_nodes = int(max_nodes)
        self._nodes: dict = {}          # exact token tuple -> PrefixNode
        self._clock = 0
        # observability: ``on_event(name, **attrs)`` callback for trie
        # detail events ("prefix_hit"/"prefix_insert"/"prefix_evict");
        # the engine session wires it to the tracer. None = off.
        self.on_event = on_event
        # counters (cumulative; the engine derives per-tick deltas)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.insertions = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, key) -> bool:
        return tuple(key) in self._nodes

    def keys(self) -> list:
        """Cached boundary keys in insertion order (deterministic)."""
        return list(self._nodes)

    def lookup(self, history):
        """Longest cached boundary prefix of ``history``, capped at
        ``len(history) - 1`` so the adopting request always feeds at least
        one token (the final chunk must emit first-token logits). Returns
        ``(p, node)`` with ``p == node.length`` a multiple of ``grid``, or
        ``(0, None)`` on a miss. A hit refreshes the node's LRU stamp and
        counts toward ``hits``/``tokens_reused``; the caller must
        :meth:`acquire` the node before relying on it surviving eviction.
        """
        hist = tuple(history)
        p = ((len(hist) - 1) // self.grid) * self.grid
        while p >= self.grid:
            node = self._nodes.get(hist[:p])
            if node is not None:
                self._clock += 1
                node.stamp = self._clock
                self.hits += 1
                self.tokens_reused += p
                if self.on_event is not None:
                    self.on_event("prefix_hit", prefix_len=p,
                                  nodes=len(self._nodes))
                return p, node
            p -= self.grid
        self.misses += 1
        return 0, None

    # ------------------------------------------------------------ mutation
    def insert(self, key, row) -> bool:
        """Cache ``row`` as the state for exactly the tokens ``key`` (a
        non-empty grid multiple). First-writer-wins: re-inserting an
        existing key only refreshes its LRU stamp (the row would be
        bit-identical anyway — state is a pure function of the tokens).
        Returns True when a new node was admitted. Admission evicts
        least-recently-used UNPINNED nodes down to ``max_nodes``; if every
        node is pinned the cache temporarily overflows rather than evict a
        row an in-flight admission still depends on."""
        key = tuple(int(t) for t in key)
        if not key or len(key) % self.grid != 0:
            raise ValueError(
                f"prefix keys must be non-empty multiples of the "
                f"grid ({self.grid}), got length {len(key)}")
        self._clock += 1
        node = self._nodes.get(key)
        if node is not None:
            node.stamp = self._clock
            return False
        while len(self._nodes) >= self.max_nodes:
            if not self._evict_one():
                break
        self._nodes[key] = PrefixNode(key=key, row=row, stamp=self._clock)
        self.insertions += 1
        if self.on_event is not None:
            self.on_event("prefix_insert", prefix_len=len(key),
                          nodes=len(self._nodes))
        return True

    def acquire(self, key) -> None:
        """Pin a node against eviction (an admission is copying from it /
        still prefilling past it). Raises KeyError for unknown keys —
        acquiring an evicted node is a caller bug, not a silent miss."""
        self._nodes[tuple(key)].refs += 1

    def release(self, key) -> None:
        """Drop one pin. Every ``acquire`` must be balanced by exactly one
        ``release`` (the property suite checks refcounts return to zero)."""
        node = self._nodes[tuple(key)]
        if node.refs <= 0:
            raise ValueError(f"release without acquire for key of length "
                             f"{len(node.key)}")
        node.refs -= 1

    def _evict_one(self) -> bool:
        """Pop the least-recently-used unpinned node; False if all pinned."""
        victim = None
        for node in self._nodes.values():
            if node.refs > 0:
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        del self._nodes[victim.key]
        self.evictions += 1
        if self.on_event is not None:
            self.on_event("prefix_evict", prefix_len=len(victim.key),
                          nodes=len(self._nodes))
        return True

    # ----------------------------------------------------- drafter corpus
    def sequences(self) -> list:
        """The trie's leaf token sequences (keys that are not a proper
        prefix of another cached key), in insertion order — the shared
        n-gram drafter corpus. Interior keys are skipped: their tokens are
        a prefix of some leaf, so they add no draft material."""
        keys = list(self._nodes)
        out = []
        for k in keys:
            if any(len(o) > len(k) and o[:len(k)] == k for o in keys):
                continue
            out.append(k)
        return out

    def stats(self) -> dict:
        return {"nodes": len(self._nodes), "hits": self.hits,
                "misses": self.misses, "tokens_reused": self.tokens_reused,
                "insertions": self.insertions, "evictions": self.evictions,
                "pinned": sum(1 for n in self._nodes.values() if n.refs)}
