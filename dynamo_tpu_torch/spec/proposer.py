"""Draft proposers for speculative decoding (a copy of
``dynamo_tpu/spec/proposer.py``).

The engine asks a proposer for up to k likely continuation tokens given a
sequence's full token history (prompt + generated so far). Proposals are
free-form guesses: a wrong draft costs only its share of one verification
pass, never output quality (the verifier accepts/rejects exactly).

``NgramProposer`` implements prompt-lookup decoding (Saxena et al.): match
the longest recent suffix of the history against an earlier occurrence and
propose the tokens that followed it. On repetition-heavy text (code,
summarization, multi-turn chat quoting context) acceptance rates are high
enough that one verify pass regularly advances k+1 tokens.

``NgramIndex`` is the incremental form the scheduler actually serves with:
the full-history rescan (O(history * max_ngram) per round — every round, per
sequence) becomes an O(max_ngram) dict update per ACCEPTED token plus an
O(max_ngram) lookup per propose. A long chat at 4K history used to pay ~16K
window comparisons per spec round; the index pays ~4 dict ops per new token.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable


@runtime_checkable
class Proposer(Protocol):
    """Pluggable host-side draft source (n-gram today). A draft MODEL does
    not fit this host contract — it is device state dispatched through
    ModelRunner.dispatch_draft — which is why make_proposer returns None for
    the draft kind."""

    def propose(self, token_ids: Sequence[int], k: int) -> list[int]: ...


class NgramIndex:
    """Incremental suffix index over one sequence's token history.

    For each n in [min_ngram, max_ngram] it tracks, per n-gram, its most
    recent start position (``_last``) and the start of the occurrence that
    position displaced (``_prev``). The history's current suffix is always
    the most recent occurrence of itself, so its most recent EARLIER match —
    exactly what the stateless scan found over windows of history[:-1] — is
    ``_prev``'s entry. Appending a token registers max_ngram n-grams; a
    propose does max_ngram lookups: both independent of history length.

    ``work`` counts dict registrations + lookups (the unit tests' O(new
    tokens) assertion rides it; the counter costs one integer add per op).
    """

    def __init__(self, tokens: Sequence[int], max_ngram: int = 4, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram; got {min_ngram}..{max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.tokens: list[int] = []
        # per-n maps live at index n (indices < min_ngram unused)
        self._last: list[dict] = [dict() for _ in range(max_ngram + 1)]
        self._prev: list[dict] = [dict() for _ in range(max_ngram + 1)]
        self.work = 0
        self.extend(tokens)

    def __len__(self) -> int:
        return len(self.tokens)

    def append(self, token: int) -> None:
        self.tokens.append(int(token))
        i = len(self.tokens) - 1
        for n in range(self.min_ngram, self.max_ngram + 1):
            s = i - n + 1
            if s < 0:
                break
            g = tuple(self.tokens[s : i + 1])
            self.work += 1
            last = self._last[n]
            old = last.get(g)
            if old is not None:
                self._prev[n][g] = old
            last[g] = s

    def extend(self, tokens: Sequence[int]) -> None:
        for t in tokens:
            self.append(t)

    def propose(self, k: int) -> list[int]:
        tokens = self.tokens
        L = len(tokens)
        if k <= 0 or L < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            g = tuple(tokens[L - n :])
            self.work += 1
            # the suffix is its own most recent occurrence (registered at its
            # final token's append); the previous one is the most recent
            # EARLIER match. When _last somehow predates the suffix (can't
            # happen through append, but stay total), use it directly.
            s = self._last[n].get(g)
            if s == L - n:
                s = self._prev[n].get(g)
            if s is None:
                continue
            # most recent match wins (closest context); predict by copying
            # with its lag d, extending PERIODICALLY past the history's end —
            # a looping chain's latest match sits one period back, and a
            # plain slice would truncate the draft at the loop period,
            # wasting the verify pass's remaining rows
            d = (L - n) - s
            return [int(tokens[L - d + (i % d)]) for i in range(k)]
        return []


class NgramProposer:
    """Prompt-lookup proposer: longest-suffix n-gram match over the history.

    For n from ``max_ngram`` down to ``min_ngram``: take the history's last n
    tokens, find the MOST RECENT earlier occurrence of that n-gram, and
    propose k tokens by copying forward with the match's lag. The stateless
    ``propose`` builds a throwaway index (tests, one-shot callers); serving
    paths hold a per-sequence :class:`NgramIndex` via :meth:`index` and pay
    only for new tokens.
    """

    def __init__(self, max_ngram: int = 4, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram; got {min_ngram}..{max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def index(self, tokens: Sequence[int]) -> NgramIndex:
        """A per-sequence incremental index seeded with ``tokens``."""
        return NgramIndex(tokens, max_ngram=self.max_ngram, min_ngram=self.min_ngram)

    def propose(self, token_ids: Sequence[int], k: int) -> list[int]:
        return self.index(token_ids).propose(k)
