"""KV cache events: engine -> router state channel (a copy of
``dynamo_tpu/llm/kv_events.py``).

Mirrors the upstream protocol (lib/llm/src/kv_router/protocols.rs:35-100):
``KvCacheEvent::Stored{parent_hash, blocks[{block_hash, tokens_hash}]}`` and
``KvCacheEvent::Removed{block_hashes}``. ``tokens_hash`` is the *unchained*
local chunk hash used for radix matching; ``block_hash`` is the engine's block
identity (we use the chained sequence hash).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

_event_counter = itertools.count()


@dataclass(frozen=True)
class StoredBlock:
    block_hash: int
    tokens_hash: int
    parent_hash: Optional[int] = None


@dataclass(frozen=True)
class KvCacheEvent:
    event_id: int
    kind: str  # "stored" | "removed"
    parent_hash: Optional[int] = None
    blocks: tuple[StoredBlock, ...] = ()
    block_hashes: tuple[int, ...] = ()

    @classmethod
    def stored(cls, parent_hash: Optional[int], blocks: list[StoredBlock]) -> "KvCacheEvent":
        return cls(
            event_id=next(_event_counter),
            kind="stored",
            parent_hash=parent_hash,
            blocks=tuple(blocks),
        )

    @classmethod
    def removed(cls, block_hashes: list[int]) -> "KvCacheEvent":
        return cls(
            event_id=next(_event_counter),
            kind="removed",
            block_hashes=tuple(block_hashes),
        )

    def to_wire(self) -> dict:
        if self.kind == "stored":
            return {
                "event_id": self.event_id,
                "stored": {
                    "parent_hash": self.parent_hash,
                    "blocks": [
                        {
                            "block_hash": b.block_hash,
                            "tokens_hash": b.tokens_hash,
                        }
                        for b in self.blocks
                    ],
                },
            }
        return {"event_id": self.event_id, "removed": {"block_hashes": list(self.block_hashes)}}

    @classmethod
    def from_wire(cls, d: dict) -> "KvCacheEvent":
        if "stored" in d:
            s = d["stored"]
            return cls(
                event_id=d["event_id"],
                kind="stored",
                parent_hash=s.get("parent_hash"),
                blocks=tuple(
                    StoredBlock(block_hash=b["block_hash"], tokens_hash=b["tokens_hash"])
                    for b in s["blocks"]
                ),
            )
        return cls(
            event_id=d["event_id"],
            kind="removed",
            block_hashes=tuple(d["removed"]["block_hashes"]),
        )
