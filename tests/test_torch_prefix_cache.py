"""The port's prefix cache against the reference's, on the CPU:

  - the port's XXH3-64 (``dynamo_tpu_torch/llm/csrc/xxh3.c``) against
    ``xxhash.xxh3_64_intdigest`` on every length 0..1100 and at 2047, 4096
    and 4099 bytes, at seeds 0, 1337 and a random 64-bit one: every length
    path of the algorithm (0; 1-3; 4-8; 9-16; 17-128; 129-240, which reads
    the secret at its own offsets; past 240, striped, with the secret a
    nonzero seed derives, the last partial block and the last stripe read
    at the input's end, and the accumulators scrambled past 1024 bytes);
    equal, bit for bit;
  - ``llm/tokens.py`` (``TokenSequence``, block, chained, salted and
    per-chunk hashes) against ``dynamo_tpu.llm.tokens``: equal;
  - ``PageAllocator`` and the reference's driven by one seeded random
    sequence of allocate / commit / append / grow / free under page
    pressure: equal cached lengths, pages, free and active counts, hit
    counters and event streams (kind, hashes, parents; event ids aside);
  - the reference's own allocator and token cases, ported;
  - the port's engine and ``AsyncJaxEngine`` (f32, the same weights) on
    prompts that share a prefix: equal ``cached_tokens``, greedy tokens and
    KV events.
"""

import asyncio
import struct

import numpy as np
import pytest
import torch
import xxhash

from dynamo_tpu.engine.page_table import PageAllocator as JaxPageAllocator
from dynamo_tpu.llm import tokens as ref_tokens
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.llm import _xxh3
from dynamo_tpu_torch.llm.kv_events import KvCacheEvent, StoredBlock
from dynamo_tpu_torch.llm.tokens import (
    TokenSequence,
    chain_hash,
    compute_block_hash,
    compute_block_hash_for_seq,
    compute_hash,
)

torch.set_num_threads(2)

RANDOM_SEED = int(np.random.default_rng(20261017).integers(0, 2**63)) * 2 + 1  # a random 64-bit seed
LENGTHS = {
    "empty": [0],
    "1-3": [1, 2, 3],
    "4-8": list(range(4, 9)),
    "9-16": list(range(9, 17)),
    "17-128": list(range(17, 129)),
    "129-240": list(range(129, 241)),
    "241-1024": list(range(241, 1025)),
    "1025-1100 and long": list(range(1025, 1101)) + [2047, 4096, 4099],
}


# ---------------------------------------------------------------- XXH3-64


@pytest.mark.parametrize("path", list(LENGTHS))
@pytest.mark.parametrize("seed", [0, 1337, RANDOM_SEED], ids=["seed0", "seed1337", "seed-random64"])
def test_xxh3_equals_xxhash_on_every_length(path, seed):
    rng = np.random.default_rng(len(path) * 1000 + seed % 1000)
    for n in LENGTHS[path]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert _xxh3.xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed), (path, n, seed)


def test_xxh3_structured_inputs():
    """All-zero, all-0xFF and repeating inputs (the bytes of token blocks
    of equal ids), where a wrong lane or offset would still collide."""
    for n in (3, 8, 16, 64, 72, 200, 240, 241, 512, 1024, 1025, 4099):
        for data in (bytes(n), b"\xff" * n, (b"\x01\x00\x00\x00" * n)[:n]):
            for seed in (0, 1337, RANDOM_SEED):
                assert _xxh3.xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed)


def test_compute_hash_is_seeded_xxh3():
    data = b"hello world"
    assert compute_hash(data) == xxhash.xxh3_64_intdigest(data, seed=1337)


@pytest.mark.parametrize("block_size", [1, 4, 16, 18, 128])
def test_token_blocks_one_call_equals_block_by_block(block_size):
    """The batched entry: every full block's hash and chained hash in one
    call, with and without a parent and a salt, against the scalar path."""
    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 2**32, 7 * block_size, dtype=np.uint64).astype(np.uint32)
    for salt in (0, 5, 2**64 - 1):
        for parent in (None, 123456789):
            block, seq = _xxh3.token_blocks(toks, block_size, salt, 1337, parent)
            prev = parent
            for b in range(7):
                chunk = toks[b * block_size : (b + 1) * block_size].tolist()
                want = compute_block_hash(chunk, salt if b == 0 and parent is None else 0)
                assert int(block[b]) == want
                chained = want if prev is None else chain_hash(prev, want)
                assert int(seq[b]) == chained
                prev = chained


# ---------------------------------------------------------------- tokens


@pytest.mark.parametrize("block_size", [1, 4, 16, 128])
@pytest.mark.parametrize("salt", [0, 7, 2**64 - 1], ids=["unsalted", "salt7", "salt-max"])
def test_token_sequence_equals_reference(block_size, salt):
    rng = np.random.default_rng(block_size + salt % 97)
    toks = rng.integers(0, 2**32, 700, dtype=np.uint64).tolist()
    got, ref = TokenSequence(toks, block_size, salt), ref_tokens.TokenSequence(toks, block_size, salt)

    def view(ts):
        return [(b.tokens, b.block_hash, b.sequence_hash, b.parent_sequence_hash) for b in ts.blocks]

    assert view(got) == view(ref) and len(got) == len(ref) == 700
    assert got.current.tokens == ref.current.tokens
    assert got.current.parent_sequence_hash == ref.current.parent_sequence_hash
    assert got.sequence_hashes() == ref.sequence_hashes()
    assert compute_block_hash_for_seq(toks, block_size, salt) == ref_tokens.compute_block_hash_for_seq(
        toks, block_size, salt)
    assert compute_block_hash(toks[:block_size], salt) == ref_tokens.compute_block_hash(toks[:block_size], salt)


def test_extend_in_pieces_equals_bulk_and_push():
    """extend() in ragged pieces, after push_token, and push_token alone give
    the same blocks and partial block as one bulk extend."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 50000, 301).tolist()
    for salt in (0, 11):
        bulk = TokenSequence(toks, 16, salt)
        pieces = TokenSequence(block_size=16, salt=salt)
        cuts = [0, 5, 21, 22, 80, 81, 200, 301]
        completed = []
        for a, b in zip(cuts, cuts[1:]):
            completed += pieces.extend(toks[a:b])
        pushed = TokenSequence(block_size=16, salt=salt)
        for t in toks:
            pushed.push_token(t)
        assert bulk.blocks == pieces.blocks == pushed.blocks == completed
        assert bulk.current == pieces.current == pushed.current
        assert bulk.tokens == toks


def test_block_hash_le_u32_bytes():
    assert compute_block_hash([1, 2, 3, 4]) == compute_hash(struct.pack("<4I", 1, 2, 3, 4))
    assert compute_block_hash([1, 2], salt=9) == compute_hash(struct.pack("<Q2I", 9, 1, 2))


def test_seq_hashes_unchained_complete_chunks_only():
    hashes = compute_block_hash_for_seq(list(range(10)), 4)
    assert hashes == [compute_block_hash([0, 1, 2, 3]), compute_block_hash([4, 5, 6, 7])]


def test_token_sequence_chaining():
    b0, b1 = TokenSequence(list(range(8)), block_size=4).blocks
    assert b0.sequence_hash == b0.block_hash and b0.parent_sequence_hash is None
    assert b1.parent_sequence_hash == b0.sequence_hash
    assert b1.sequence_hash == chain_hash(b0.sequence_hash, b1.block_hash)


def test_same_prefix_same_hashes():
    a = TokenSequence([5, 6, 7, 8, 9, 10, 11, 12], block_size=4)
    b = TokenSequence([5, 6, 7, 8, 100, 200, 300, 400], block_size=4)
    assert a.blocks[0].sequence_hash == b.blocks[0].sequence_hash
    assert a.blocks[1].sequence_hash != b.blocks[1].sequence_hash


def test_kv_events_wire_round_trip_equals_reference():
    from dynamo_tpu.llm.kv_events import KvCacheEvent as RefEvent
    from dynamo_tpu.llm.kv_events import StoredBlock as RefStored

    got = KvCacheEvent.stored(7, [StoredBlock(11, 12, 7), StoredBlock(13, 14)])
    ref = RefEvent.stored(7, [RefStored(11, 12, 7), RefStored(13, 14)])
    assert {k: v for k, v in got.to_wire().items() if k != "event_id"} == {
        k: v for k, v in ref.to_wire().items() if k != "event_id"}
    back = KvCacheEvent.from_wire(got.to_wire())
    assert back.kind == "stored" and back.parent_hash == 7 and [b.block_hash for b in back.blocks] == [11, 13]
    removed = KvCacheEvent.removed([1, 2])
    assert KvCacheEvent.from_wire(removed.to_wire()) == removed
    assert removed.event_id > got.event_id  # the module's counter


# ---------------------------------------------------------------- allocator


def event_view(e) -> tuple:
    """An event without its id (the two packages count separately)."""
    if e.kind == "stored":
        return ("stored", e.parent_hash, tuple((b.block_hash, b.tokens_hash, b.parent_hash) for b in e.blocks))
    return ("removed", tuple(e.block_hashes))


@pytest.mark.parametrize("seed,num_pages,page_size", [(0, 24, 4), (1, 40, 4), (2, 30, 16), (3, 12, 2)])
def test_page_allocator_equals_reference_on_a_random_sequence(seed, num_pages, page_size):
    """One seeded random sequence of operations on both allocators, prompts
    drawn from a few shared prefixes so blocks hit, get shared, go
    reusable and get reclaimed; every result and the state after every
    operation equal."""
    ref_events, got_events = [], []
    ref = JaxPageAllocator(num_pages, page_size, event_sink=ref_events.append)
    got = PageAllocator(num_pages, page_size, event_sink=got_events.append)
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 500, int(rng.integers(page_size, 5 * page_size))).tolist() for _ in range(3)]
    live, lens, kinds = [], {}, set()
    for step in range(300):
        op = rng.random()
        if live and op < 0.25:
            sid = live.pop(int(rng.integers(len(live))))
            ref.free_sequence(sid)
            got.free_sequence(sid)
            kinds.add("free")
        elif live and op < 0.55:
            sid = live[int(rng.integers(len(live)))]
            token = int(rng.integers(0, 500))
            if not ref.ensure_capacity(sid, lens[sid] + 1):
                assert not got.ensure_capacity(sid, lens[sid] + 1)
                continue
            assert got.ensure_capacity(sid, lens[sid] + 1)
            ref.append_token(sid, token)
            got.append_token(sid, token)
            lens[sid] += 1
            kinds.add("append")
        elif live and op < 0.65:
            sid = live[int(rng.integers(len(live)))]
            n = lens[sid] + int(rng.integers(0, 3 * page_size))
            assert got.ensure_capacity(sid, n) == ref.ensure_capacity(sid, n)
            kinds.add("grow")
        else:
            sid = f"s{step}"
            prompt = list(prefixes[int(rng.integers(3))]) + rng.integers(0, 500, int(rng.integers(0, 9))).tolist()
            cut = int(rng.integers(1, len(prompt) + 1))
            prompt = prompt[:cut]
            try:
                want = ref.allocate_sequence(sid, prompt)
            except MemoryError:
                with pytest.raises(MemoryError):
                    got.allocate_sequence(sid, prompt)
                kinds.add("oom")
                continue
            cached, state = got.allocate_sequence(sid, prompt)
            assert cached == want[0] and state.pages == want[1].pages
            assert state.shared_prefix_pages == want[1].shared_prefix_pages
            kinds.add("hit" if cached else "miss")
            got.commit_prefilled(sid, len(prompt))
            ref.commit_prefilled(sid, len(prompt))
            live.append(sid)
            lens[sid] = len(prompt)
        assert (got.free_pages, got.used_pages, got.active_pages, got.peak_used_pages) == (
            ref.free_pages, ref.used_pages, ref.active_pages, ref.peak_used_pages)
        assert (got.cache_hit_blocks, got.cache_query_blocks) == (ref.cache_hit_blocks, ref.cache_query_blocks)
        assert got._cache == ref._cache and list(got._reusable.items()) == list(ref._reusable.items())
        assert got._refcount == ref._refcount and got._free == ref._free
        for sid in live:
            assert got._seqs[sid].pages == ref._seqs[sid].pages
            assert got._seqs[sid].registered_hashes == ref._seqs[sid].registered_hashes
    assert [event_view(e) for e in got_events] == [event_view(e) for e in ref_events]
    assert {"hit", "miss", "append", "free"} <= kinds
    assert any(e.kind == "removed" for e in got_events) or num_pages > 30
    probe = prefixes[0] + [1, 2, 3]
    assert got.lookup_prefix(probe) == ref.lookup_prefix(probe)
    some = next(iter(ref._cache), None)
    assert got.cached_page(some) == ref.cached_page(some)


def test_reset_prefix_cache_frees_only_reusable_blocks():
    events = []
    a = PageAllocator(8, 4, event_sink=events.append)
    a.allocate_sequence("s1", list(range(8)))
    a.commit_prefilled("s1", 8)
    a.allocate_sequence("s2", list(range(100, 108)))
    a.commit_prefilled("s2", 8)
    a.free_sequence("s1")
    assert len(a._reusable) == 2 and a.free_pages == 5
    assert a.reset_prefix_cache() == 2
    assert not a._reusable and a.free_pages == 5 and len(a._cache) == 2  # s2's blocks stay
    assert events[-1].kind == "removed" and len(events[-1].block_hashes) == 2
    assert a.allocate_sequence("s3", list(range(8)))[0] == 0


# the reference's tests/test_page_allocator.py cases, on the port

PS = 4


def make(num_pages=8, events=None):
    return PageAllocator(num_pages, PS, event_sink=events.append if events is not None else None)


def test_basic_allocation_and_free():
    a = make()
    cached, st = a.allocate_sequence("s1", list(range(10)))
    assert cached == 0 and len(st.pages) == 3 and 0 not in st.pages
    assert a.active_pages == 3
    a.commit_prefilled("s1", 10)
    a.free_sequence("s1")
    assert a.active_pages == 0 and a.free_pages == 7


def test_prefix_cache_hit_and_sharing():
    events = []
    a = make(events=events)
    prompt = list(range(8))
    a.allocate_sequence("s1", prompt + [99, 98])
    a.commit_prefilled("s1", 10)
    assert len([e for e in events if e.kind == "stored"]) == 2
    cached, st2 = a.allocate_sequence("s2", prompt + [55, 44, 33, 22, 11])
    assert cached == 8
    st1 = a._seqs["s1"]
    assert st2.pages[:2] == st1.pages[:2] and a._refcount[st1.pages[0]] == 2
    a.free_sequence("s1")
    assert a._refcount[st2.pages[0]] == 1
    a.free_sequence("s2")


def test_full_prompt_cache_hit_leaves_one_block_to_prefill():
    a = make()
    a.allocate_sequence("s1", list(range(8)))
    a.commit_prefilled("s1", 8)
    a.free_sequence("s1")
    assert a.allocate_sequence("s2", list(range(8)))[0] == 4


def test_lru_eviction_emits_removed():
    events = []
    a = make(num_pages=6, events=events)
    a.allocate_sequence("s1", list(range(8)))
    a.commit_prefilled("s1", 8)
    a.free_sequence("s1")
    assert a.free_pages == 5
    a.allocate_sequence("s2", list(range(100, 120)))
    assert len([h for e in events if e.kind == "removed" for h in e.block_hashes]) == 2
    assert a.free_pages == 0
    with pytest.raises(MemoryError):
        a.allocate_sequence("s3", [1, 2, 3, 4])


def test_decode_block_completion_registers_one_token_late():
    events = []
    a = make(events=events)
    a.allocate_sequence("s1", [1, 2, 3])
    a.commit_prefilled("s1", 3)
    a.append_token("s1", 4)
    assert not [e for e in events if e.kind == "stored"]
    a.append_token("s1", 5)
    stored = [e for e in events if e.kind == "stored"]
    assert len(stored) == 1
    assert stored[0].blocks[0].block_hash == TokenSequence([1, 2, 3, 4], PS).blocks[0].sequence_hash


def test_ensure_capacity_grows_and_fails():
    a = make(num_pages=4)
    a.allocate_sequence("s1", [1, 2, 3, 4])
    assert a.ensure_capacity("s1", 12) and not a.ensure_capacity("s1", 13)


def test_oom_rollback_restores_state():
    a = make(num_pages=4)
    with pytest.raises(MemoryError):
        a.allocate_sequence("big", list(range(100)))
    assert a.free_pages == 3 and "big" not in a._seqs


def test_oom_rollback_returns_prefix_hits_to_the_reusable_pool():
    a = make(num_pages=6)
    a.allocate_sequence("s1", list(range(8)))
    a.commit_prefilled("s1", 8)
    a.free_sequence("s1")
    before = list(a._reusable.items())
    with pytest.raises(MemoryError):
        a.allocate_sequence("s2", list(range(8)) + list(range(50, 70)))
    assert sorted(a._reusable.items()) == sorted(before) and a.free_pages == 5 and not a._refcount


# ---------------------------------------------------------------- engines

ENGINE = dict(page_size=4, num_pages=64, max_seqs=4, max_model_len=64, prefill_buckets=(8, 16, 32))
SHARED = [7, 3, 99, 14, 250, 8, 61, 2, 40, 41, 42, 5, 17, 200, 3, 9, 77, 1]  # 4 full blocks + 2
TAILS = [[11, 12, 13], [90, 91, 92, 93, 94, 95], [], [5]]


async def collect(engine, req):
    outs = []
    async for out in engine.generate(req):
        outs.append(out)
    toks = [o.token for o in outs if o.token is not None]
    return toks, outs[0].cached_tokens, outs[-1].finish_reason


def run_both(requests_for, sequential: bool):
    """(reference outputs, events; port outputs, events) of the same
    requests through AsyncJaxEngine and the port's engine on its weights;
    ``sequential``: each request after the previous one ended."""
    import jax

    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu.engine.engine import AsyncJaxEngine
    from dynamo_tpu.engine.sampling import SamplingParams as JaxSamplingParams
    from dynamo_tpu.engine.scheduler import EngineRequest as JaxEngineRequest
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.convert import params_from_jax
    from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

    async def serve(engine, make_req, make_params):
        await engine.start()
        try:
            reqs = [make_req(f"r{i}", p, make_params(max_tokens=n)) for i, (p, n) in enumerate(requests_for)]
            if sequential:
                return [await collect(engine, r) for r in reqs]
            return list(await asyncio.gather(*(collect(engine, r) for r in reqs)))
        finally:
            await engine.shutdown()

    ref_events, got_events = [], []
    ref_engine = AsyncJaxEngine(JaxEngineConfig(model_id="tiny", tp=1, **ENGINE), kv_event_sink=ref_events.append)
    ref = asyncio.run(serve(ref_engine, JaxEngineRequest, JaxSamplingParams))
    params = jax.tree.map(np.asarray, jax.device_get(ref_engine.runner.params))
    model = LlamaModel(LlamaConfig.tiny())
    model.load_state_dict(params_from_jax(params, model.config))
    engine = AsyncTorchEngine(EngineConfig(device="cpu", **ENGINE), model=model, kv_event_sink=got_events.append)
    got = asyncio.run(serve(engine, EngineRequest, SamplingParams))
    return ref, ref_events, got, got_events, engine


def test_engine_prefix_hits_equal_the_jax_engine():
    """Shared-prefix prompts one after another (a full-prompt hit among
    them): equal greedy tokens, cached_tokens and KV event streams; the
    hits are what the allocation rule gives; metrics report the hit rate."""
    reqs = [(SHARED + t, 9) for t in TAILS] + [(SHARED + TAILS[1], 6)]
    ref, ref_events, got, got_events, engine = run_both(reqs, sequential=True)
    assert got == ref
    assert [c for _, c, _ in got] == [0, 16, 16, 16, 20]  # the last: every full block of its prompt (24 tokens)
    assert [event_view(e) for e in got_events] == [event_view(e) for e in ref_events]
    assert sum(e.kind == "stored" for e in got_events) >= 6
    m = engine.metrics()
    # hit blocks are counted before the full-prompt hit gives one back
    assert m.gpu_prefix_cache_hit_rate == pytest.approx((0 + 4 + 4 + 4 + 6) / (5 + 6 + 4 + 4 + 6))
    assert m.request_active_slots == 0 and m.kv_total_blocks == ENGINE["num_pages"] - 1
    assert m.to_wire()["request_total_slots"] == ENGINE["max_seqs"]


def test_engine_concurrent_shared_prefix_tokens_equal_the_jax_engine():
    """The same prompts at once: the greedy tokens equal the JAX engine's
    whatever each got from the cache."""
    reqs = [(SHARED + t, 8) for t in TAILS]
    ref, _, got, _, _ = run_both(reqs, sequential=False)
    assert [t for t, _, _ in got] == [t for t, _, _ in ref] and all(len(t) == 8 for t, _, _ in got)


def test_engine_lookup_prefix_after_serving():
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny", **ENGINE))
        await engine.start()
        try:
            before = await engine.run_on_engine(lambda: engine.sync_lookup_prefix(SHARED + [1, 2]))
            await collect(engine, EngineRequest("a", SHARED + [1, 2], SamplingParams(max_tokens=3)))
            after = await engine.run_on_engine(lambda: engine.sync_lookup_prefix(SHARED + [1, 2]))
            freed = await engine.run_on_engine(engine.allocator.reset_prefix_cache)
            cold = await engine.run_on_engine(lambda: engine.sync_lookup_prefix(SHARED + [1, 2]))
        finally:
            await engine.shutdown()
        return before, after, freed, cold

    before, after, freed, cold = asyncio.run(run())
    # the lookup counts every cached full block (the allocation gives the last back)
    assert (before, after, cold) == (0, 20, 0) and freed == 5


def test_a_dropped_engine_is_freed_without_the_cyclic_gc():
    """An engine with a KV event sink that served prefix hits, penalties
    and logprobs is freed when its last reference goes (nothing in it
    refers back to it): on the card its weights, pools and graphs would
    otherwise stay until the cyclic collector ran."""
    import gc
    import weakref

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest

    events = []

    async def run():
        engine = AsyncTorchEngine(EngineConfig(device="cpu", model_id="tiny", **ENGINE), kv_event_sink=events.append)
        await engine.start()
        try:
            for rid in ("a", "b"):
                await collect(engine, EngineRequest(rid, SHARED + [1, 2], SamplingParams(
                    max_tokens=3, presence_penalty=0.3, min_tokens=1), eos_token_ids=(5,), logprobs=2))
        finally:
            await engine.shutdown()
        return weakref.ref(engine), weakref.ref(engine.runner), weakref.ref(engine.allocator)

    gc.disable()
    try:
        refs = asyncio.run(run())
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()
    assert sum(e.kind == "stored" for e in events) == 5
