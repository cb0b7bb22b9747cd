"""Token sequences -> fixed-size blocks with chained sequence hashes (port of
``dynamo_tpu/llm/tokens.py``, the canonical block identity used for KV reuse
and KV-aware routing):

  - ``compute_hash(data) = xxh3_64(data, seed=1337)``, the port's own XXH3-64
    (``csrc/xxh3.c`` through ``_xxh3``), bit-equal to the reference's
    ``xxhash`` call
  - block hash = hash of the block's token ids as little-endian u32 bytes
    (a nonzero ``salt`` prefixed as a little-endian u64 to the first
    block's bytes only)
  - sequence hash (chained): the first full block's sequence hash is its
    block hash; block i's sequence hash = hash of ``[parent_sequence_hash,
    block_hash]`` as two little-endian u64s
  - ``compute_block_hash_for_seq`` = *unchained* per-chunk hashes over
    complete chunks only (the router's radix-tree matching identity)

``TokenSequence.extend`` hashes every full block of its tokens in one
foreign call (``_xxh3.token_blocks``); ``push_token`` hashes the block it
completes with the scalar entry.
"""

from __future__ import annotations

import array
import struct
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from dynamo_tpu_torch.llm import _xxh3

XXH3_SEED = 1337

Token = int
SequenceHash = int
BlockHash = int


def compute_hash(data: bytes) -> int:
    return _xxh3.xxh3_64(data, XXH3_SEED)


def _tokens_bytes(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *tokens)


def compute_block_hash(tokens: Sequence[int], salt: int = 0) -> BlockHash:
    """``salt`` (e.g. a LoRA adapter uid) prefixes the hashed bytes so
    salted identities never collide with unsalted ones; 0 = the unsalted
    hash."""
    data = _tokens_bytes(tokens)
    if salt:
        data = struct.pack("<Q", salt & 0xFFFFFFFFFFFFFFFF) + data
    return compute_hash(data)


def compute_block_hash_for_seq(tokens: Sequence[int], kv_block_size: int, salt: int = 0) -> list[BlockHash]:
    """Unchained per-chunk hashes of complete chunks (router matching
    identity); ``salt`` folds into the FIRST chunk's hash only."""
    n = len(tokens) // kv_block_size * kv_block_size
    block, _ = _xxh3.token_blocks(_u32(tokens[:n]), kv_block_size, salt, XXH3_SEED, None)
    return [int(h) for h in block]


def _u32(tokens: Sequence[int]) -> np.ndarray:
    """Token ids as a uint32 array (through ``array``: a third of numpy's
    time on a list)."""
    return np.frombuffer(array.array("I", tokens), np.uint32)


def chain_hash(parent: SequenceHash, block_hash: BlockHash) -> SequenceHash:
    return compute_hash(struct.pack("<QQ", parent, block_hash))


@dataclass(frozen=True)
class TokenBlock:
    """A complete block of ``block_size`` tokens with its chained identity."""

    tokens: tuple[int, ...]
    block_hash: BlockHash
    sequence_hash: SequenceHash
    parent_sequence_hash: Optional[SequenceHash]


_new_object = object.__new__


def _token_block(tokens: tuple, block_hash: int, sequence_hash: int, parent: Optional[int]) -> TokenBlock:
    """``TokenBlock(...)`` without the frozen dataclass's ``__init__`` (a
    third of its time: a 2048-token prompt at page size 4 makes 512 of them
    at admission)."""
    block = _new_object(TokenBlock)
    d = block.__dict__
    d["tokens"], d["block_hash"], d["sequence_hash"], d["parent_sequence_hash"] = tokens, block_hash, sequence_hash, parent
    return block


@dataclass
class PartialTokenBlock:
    """The trailing incomplete block of a sequence."""

    tokens: list[int] = field(default_factory=list)
    parent_sequence_hash: Optional[SequenceHash] = None


class TokenSequence:
    """Incremental splitter of a token stream into hashed blocks: the first
    block's sequence hash equals its block hash; later blocks chain.
    ``salt`` folds into the first block's BLOCK hash, so the whole chained
    line is salt-specific without changing the chain structure (the parent
    of block 0 stays None)."""

    def __init__(self, tokens: Sequence[int] = (), block_size: int = 16, salt: int = 0):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.salt = salt
        self.blocks: list[TokenBlock] = []
        self.current = PartialTokenBlock()
        self.extend(tokens)

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.current.tokens)

    @property
    def tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.current.tokens)
        return out

    def push_token(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly completed TokenBlock if any."""
        cur = self.current
        cur.tokens.append(token)
        if len(cur.tokens) < self.block_size:
            return None
        block_hash = compute_block_hash(cur.tokens, self.salt if cur.parent_sequence_hash is None else 0)
        if cur.parent_sequence_hash is None:
            sequence_hash = block_hash
        else:
            sequence_hash = chain_hash(cur.parent_sequence_hash, block_hash)
        block = TokenBlock(
            tokens=tuple(cur.tokens),
            block_hash=block_hash,
            sequence_hash=sequence_hash,
            parent_sequence_hash=cur.parent_sequence_hash,
        )
        self.blocks.append(block)
        self.current = PartialTokenBlock(parent_sequence_hash=sequence_hash)
        return block

    def extend(self, tokens: Sequence[int]) -> list[TokenBlock]:
        """Append ``tokens``; returns the blocks they complete. The open
        partial block fills token by token, then every further full block is
        hashed in one call."""
        tokens = list(tokens)
        completed = []
        i = 0
        while i < len(tokens) and self.current.tokens:
            block = self.push_token(tokens[i])
            i += 1
            if block is not None:
                completed.append(block)
        bs = self.block_size
        n_full = (len(tokens) - i) // bs
        if n_full:
            body = tokens[i : i + n_full * bs]
            parent = self.current.parent_sequence_hash
            block_h, seq_h = _xxh3.token_blocks(_u32(body), bs, self.salt, XXH3_SEED, parent)
            for b, (bh, sh) in enumerate(zip(block_h.tolist(), seq_h.tolist())):
                block = _token_block(tuple(body[b * bs : (b + 1) * bs]), bh, sh, parent)
                self.blocks.append(block)
                completed.append(block)
                parent = sh
            self.current = PartialTokenBlock(parent_sequence_hash=parent)
            i += n_full * bs
        self.current.tokens.extend(tokens[i:])
        return completed

    def sequence_hashes(self) -> list[SequenceHash]:
        return [b.sequence_hash for b in self.blocks]
