"""Paged KV page allocator with prefix caching and KV event emission (port
of ``dynamo_tpu/engine/page_table.py`` ``PageAllocator``):

  - physical page 0 is reserved as the null/trash page (masked writes and
    page-table padding target it; see ``ops/attention.py``)
  - full blocks are identified by their chained sequence hash
    (``llm/tokens.py``); a completed block's page is registered in the
    prefix cache and can be shared (refcounted) by later sequences
  - refcount-0 cached pages form an LRU "reuse pool": they still serve
    prefix hits but are reclaimed when fresh pages run out
  - block store / evict emit ``KvCacheEvent``s (``llm/kv_events.py``) to
    ``event_sink`` for the KV router's global index

Pure Python bookkeeping; the scheduler turns page ids into page tables.
Not ported yet: the host/disk offload tiers (``offload``, ``drain_to_host``,
``promote_restored``, ``drop_disk_blocks``) and metering, so a prefix hit
comes from the device pages alone.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.llm.kv_events import KvCacheEvent, StoredBlock
from dynamo_tpu_torch.llm.tokens import TokenBlock, TokenSequence


@dataclass
class SequencePages:
    """Page state for one live sequence."""

    seq_id: str
    pages: list[int] = field(default_factory=list)  # logical block i -> physical page
    shared_prefix_pages: int = 0  # leading pages refcounted from the prefix cache
    token_seq: Optional[TokenSequence] = None  # hashing state (block_size = page_size)
    registered_hashes: list[int] = field(default_factory=list)  # sequence hashes we cached

    @property
    def num_pages(self) -> int:
        return len(self.pages)


class PageAllocator:
    """Physical page allocator + prefix cache for one engine's KV cache."""

    def __init__(self, num_pages: int, page_size: int,
                 event_sink: Optional[Callable[[KvCacheEvent], None]] = None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.event_sink = event_sink
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # stack; page 0 reserved
        # sequence_hash -> physical page holding that full block
        self._cache: dict[int, int] = {}
        self._cache_meta: dict[int, StoredBlock] = {}  # seq_hash -> event payload
        self._refcount: dict[int, int] = {}  # physical page -> live users
        # refcount-0 cached blocks, LRU order (oldest first): seq_hash -> page
        self._reusable: OrderedDict[int, int] = OrderedDict()
        self._reusable_hash: dict[int, int] = {}  # page -> its seq_hash while in _reusable
        self._seqs: dict[str, SequencePages] = {}
        # stats
        self.cache_hit_blocks = 0
        self.cache_query_blocks = 0
        self.peak_used_pages = 0  # page-pool occupancy high-watermark

    # ------------- capacity -------------

    @property
    def free_pages(self) -> int:
        """Immediately + reclaimably free pages."""
        return len(self._free) + len(self._reusable)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def active_pages(self) -> int:
        """Pages referenced by live sequences."""
        return (self.num_pages - 1) - len(self._free) - len(self._reusable)

    def _pop_free_pages(self, n: int) -> list[int]:
        """Take ``n`` pages: the free list first, then LRU reclaim from the
        refcount-0 reusable pool (one ``removed`` event for the batch).
        Raises MemoryError (nothing taken) when both run dry."""
        if n <= len(self._free):
            out = [self._free.pop() for _ in range(n)]
        else:
            if n > len(self._free) + len(self._reusable):
                raise MemoryError("out of KV pages")
            out = [self._free.pop() for _ in range(len(self._free))]
            out.extend(self._reclaim_reusable(n - len(out)))
        if self.used_pages > self.peak_used_pages:
            self.peak_used_pages = self.used_pages
        return out

    def _reclaim_reusable(self, n: int) -> list[int]:
        """Evict up to ``n`` LRU refcount-0 cached blocks; returns the freed
        pages."""
        victims: list[tuple[int, StoredBlock, int]] = []  # (seq_hash, meta, page)
        while self._reusable and len(victims) < n:
            seq_hash, page = self._reusable.popitem(last=False)
            del self._reusable_hash[page]
            del self._cache[seq_hash]
            victims.append((seq_hash, self._cache_meta.pop(seq_hash), page))
        if victims:
            self._emit(KvCacheEvent.removed([m.block_hash for _, m, _ in victims]))
        return [p for _, _, p in victims]

    def reset_prefix_cache(self) -> int:
        """Drop every refcount-0 cached block (one ``removed`` event) and
        return its page to the free list; blocks that live sequences hold
        stay. Returns the number of pages freed. (vLLM's
        ``reset_prefix_cache``; the reference has no such call. The
        profilers use it to serve the same prompts again from a cold
        cache.)"""
        pages = self._reclaim_reusable(len(self._reusable))
        self._free.extend(pages)
        return len(pages)

    # ------------- events -------------

    def _emit(self, event: KvCacheEvent) -> None:
        if self.event_sink is not None:
            self.event_sink(event)

    # ------------- sequence lifecycle -------------

    def lookup_prefix(self, prompt_tokens: list[int], salt: int = 0) -> int:
        """Number of leading tokens already cached (block granularity),
        without allocating. ``salt``: the request's LoRA adapter uid (0 =
        base); salted prefixes never cross-hit."""
        ts = TokenSequence(prompt_tokens, self.page_size, salt=salt)
        hits = 0
        for block in ts.blocks:
            if block.sequence_hash not in self._cache:
                break
            hits += 1
        return hits * self.page_size

    def cached_page(self, seq_hash: int) -> Optional[int]:
        """Physical page holding a cached block, or None. Blocks parked in
        the refcount-0 reusable pool still serve reads."""
        return self._cache.get(seq_hash)

    def allocate_sequence(self, seq_id: str, prompt_tokens: list[int], salt: int = 0) -> tuple[int, SequencePages]:
        """Allocate pages for a prompt, reusing cached prefix blocks.

        Returns (cached_len, seq_state): the first cached_len tokens already
        have KV in shared pages and must NOT be recomputed (except the last
        block when the full prompt hits, so there is always something to
        prefill). ``salt`` folds an adapter uid into the chained block
        identity. Raises MemoryError with nothing taken (the prefix hits
        handed back) when the pool runs dry."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already allocated")
        ts = TokenSequence(prompt_tokens, self.page_size, salt=salt)
        state = SequencePages(seq_id=seq_id, token_seq=ts)

        # device prefix hits: the chain of full blocks present in the cache
        device_hits: list[int] = []
        for block in ts.blocks:
            page = self._cache.get(block.sequence_hash)
            if page is None:
                break
            device_hits.append(page)
        self.cache_query_blocks += len(ts.blocks)
        self.cache_hit_blocks += len(device_hits)

        # never consume the *entire* prompt from the cache: leave at least
        # the last token to prefill so the model produces next-token logits
        if device_hits and len(device_hits) * self.page_size >= len(prompt_tokens):
            device_hits.pop()

        for page in device_hits:
            self._ref_page(page)
        state.pages.extend(device_hits)
        state.shared_prefix_pages = len(device_hits)
        cached_len = len(device_hits) * self.page_size
        try:
            need = -(-len(prompt_tokens) // self.page_size) - len(state.pages)
            if need > 0:
                fresh = self._pop_free_pages(need)
                for page in fresh:
                    self._refcount[page] = 1
                state.pages.extend(fresh)
        except MemoryError:
            self._rollback(state)
            raise
        # blocks the prompt completes past the cached prefix are registered
        # once their KV is computed: the scheduler calls commit_prefilled()
        self._seqs[seq_id] = state
        return cached_len, state

    def _rollback(self, state: SequencePages) -> None:
        """Undo a failed allocation: shared prefix hits return to the
        reusable pool (their data is still valid)."""
        pages = set(state.pages)
        page_to_hash = {p: h for h, p in self._cache.items() if p in pages}
        for page in state.pages:
            self._unref_page(page, evictable_hash=page_to_hash.get(page))
        state.pages.clear()

    def commit_prefilled(self, seq_id: str, prompt_len: int) -> None:
        """Register all full blocks covered by the (now computed) prompt KV."""
        state = self._seqs[seq_id]
        for i in range(state.shared_prefix_pages, prompt_len // self.page_size):
            self._register_block(state, state.token_seq.blocks[i], state.pages[i])

    def ensure_capacity(self, seq_id: str, length: int) -> bool:
        """Make sure pages exist to hold `length` tokens. False if OOM."""
        state = self._seqs[seq_id]
        needed = -(-length // self.page_size)
        if state.num_pages >= needed:
            return True
        try:
            fresh = self._pop_free_pages(needed - state.num_pages)
        except MemoryError:
            return False
        for page in fresh:
            self._refcount[page] = 1
        state.pages.extend(fresh)
        return True

    def append_token(self, seq_id: str, token: int) -> None:
        """Track a decoded token; registers blocks ONE TOKEN AFTER they fill.

        A decode-written block's last row's KV exists only once the token
        after the block has been fed (token ``p`` is sampled from fed
        position ``p-1``, so appending ``p`` proves KV through ``p-1``).
        Registering at fill time would advertise, locally and through KV
        events, a block whose final row a reader extending past it finds
        unwritten: forever if the writer ends exactly at the block edge, or
        for a moment if a reader races the writer's next window. So every
        advertised block's KV is complete, and a sequence that ends at a
        block edge never registers its last block."""
        state = self._seqs[seq_id]
        state.token_seq.push_token(token)
        n = len(state.token_seq)
        # the newest token (index n-1) proves KV through n-2: the last block
        # fully below that bound is safe to register
        if (n - 1) % self.page_size == 0 and n > self.page_size:
            idx = (n - 1) // self.page_size - 1
            if idx < len(state.pages):
                self._register_block(state, state.token_seq.blocks[idx], state.pages[idx])

    def free_sequence(self, seq_id: str) -> None:
        """Release a sequence. Its full cached blocks become reusable (LRU);
        uncached pages return to the free list at once."""
        state = self._seqs.pop(seq_id)
        page_to_hash = {}
        for i, block in enumerate(state.token_seq.blocks):
            if i < len(state.pages) and self._cache.get(block.sequence_hash) == state.pages[i]:
                page_to_hash[state.pages[i]] = block.sequence_hash
        for page in state.pages:
            self._unref_page(page, evictable_hash=page_to_hash.get(page))

    # ------------- internals -------------

    def _ref_page(self, page: int) -> None:
        self._refcount[page] = self._refcount.get(page, 0) + 1
        # a cached page in the reusable pool that regains a user leaves it
        seq_hash = self._reusable_hash.pop(page, None)
        if seq_hash is not None:
            del self._reusable[seq_hash]

    def _unref_page(self, page: int, evictable_hash: Optional[int]) -> None:
        rc = self._refcount.get(page, 0) - 1
        if rc > 0:
            self._refcount[page] = rc
            return
        self._refcount.pop(page, None)
        if evictable_hash is not None and self._cache.get(evictable_hash) == page:
            self._reusable[evictable_hash] = page  # cached, reclaimable, LRU tail
            self._reusable.move_to_end(evictable_hash)
            self._reusable_hash[page] = evictable_hash
        else:
            self._free.append(page)

    def _register_block(self, state: SequencePages, block: TokenBlock, page: int) -> None:
        if block.sequence_hash in self._cache:
            return  # first writer wins; our copy stays private
        self._cache[block.sequence_hash] = page
        meta = StoredBlock(
            block_hash=block.sequence_hash,
            tokens_hash=block.block_hash,
            parent_hash=block.parent_sequence_hash,
        )
        self._cache_meta[block.sequence_hash] = meta
        state.registered_hashes.append(block.sequence_hash)
        self._emit(KvCacheEvent.stored(parent_hash=block.parent_sequence_hash, blocks=[meta]))
