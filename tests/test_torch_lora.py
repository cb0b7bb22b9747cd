"""Multi-LoRA in the port against the JAX package, model level, on the CPU:
the adapter uid, spec parsing, synthetic and directory adapters, the pool
layout, ``lora_delta`` and the Llama forwards with a pool (prefill_packed,
decode, verify) on the same numpy inputs, f32. The port's delta is the
reference's function on a slot-concatenated pool (no per-token gather);
slot 0 leaves every logit bit-equal, and the pass is token-identical to
merged weights ``W + scale * A @ B`` over a greedy chain."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.lora import adapter as jax_adapter
from dynamo_tpu.lora import init_lora_pool as jax_init_lora_pool
from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.models.llama import lora_delta as jax_lora_delta
from dynamo_tpu_torch.lora import adapter
from dynamo_tpu_torch.lora import init_lora_pool, merge_adapter_into_params
from dynamo_tpu_torch.models.convert import lora_pool_from_jax, params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel, lora_delta

torch.set_num_threads(2)

ATOL = 1e-5  # the delta alone, f32
LOGITS_ATOL = 1e-4  # two layers' logits, f32 summed in another order (test_torch_llama.py)
RANK, MAX_LORAS = 4, 3
PS, NUM_PAGES = 4, 32
NAMES = ["a1", "a2", "base", "lora-7", "x.y_z", "A", "adapter-with-a-long-name", "0", "é", "a" * 64, "q:v", ""]


def test_lora_uid_equals_reference():
    """The uid salts every block hash across a mixed fleet: bit for bit."""
    for name in NAMES:
        assert adapter.lora_uid(name) == jax_adapter.lora_uid(name), name
        assert adapter.lora_uid(name) & 1


def test_parse_adapter_specs_equal_reference():
    specs = ("a1", "b=/tmp/x", "c=random:3", " d = random:9 ")
    assert adapter.parse_adapter_specs(specs) == jax_adapter.parse_adapter_specs(specs)
    for bad in (("dup", "dup"), ("bad name",), ("=random:1",)):
        for fn in (adapter.parse_adapter_specs, jax_adapter.parse_adapter_specs):
            with pytest.raises(ValueError):
                fn(bad)


def _same_tree(got, want):
    assert set(got[0]) == set(want[0]) and got[1] == want[1]
    for m in want[0]:
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[0][m][k], want[0][m][k], err_msg=f"{m}.{k}")


def test_synth_adapter_equal_arrays():
    cfg, jcfg = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
    assert adapter.module_dims(cfg) == jax_adapter.module_dims(jcfg)
    _same_tree(adapter.synth_adapter(cfg, 8, 7), jax_adapter.synth_adapter(jcfg, 8, 7))
    _same_tree(adapter.synth_adapter(cfg, 4, 3, modules=("wq", "down")),
               jax_adapter.synth_adapter(jcfg, 4, 3, modules=("wq", "down")))


def test_load_adapter_dir_round_trip(tmp_path):
    """The npz directory format at rank 2 into a rank-4 pool: both packages
    give the same zero-padded arrays and alpha / r; a pool rank below the
    adapter's raises in both."""
    cfg, jcfg = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
    dims = adapter.module_dims(cfg)
    L, r = cfg.num_layers, 2
    rng = np.random.default_rng(0)
    arrays = {}
    for m in ("wq", "down"):
        din, dout = dims[m]
        arrays[f"{m}.a"] = rng.standard_normal((L, din, r)).astype(np.float32)
        arrays[f"{m}.b"] = rng.standard_normal((L, r, dout)).astype(np.float32)
    np.savez(tmp_path / "adapter_model.npz", **arrays)
    (tmp_path / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": 8, "target_modules": ["wq", "down"]}))
    got = adapter.load_adapter(str(tmp_path), cfg, rank=4)
    _same_tree(got, jax_adapter.load_adapter(str(tmp_path), jcfg, rank=4))
    tree, scale = got
    assert scale == 4.0
    assert tree["wq"]["a"].shape == (L, dims["wq"][0], 4)
    np.testing.assert_array_equal(tree["wq"]["a"][..., :r], arrays["wq.a"])
    assert not tree["wq"]["a"][..., r:].any() and not tree["wk"]["a"].any()
    for fn, c in ((adapter.load_adapter, cfg), (jax_adapter.load_adapter, jcfg)):
        with pytest.raises(ValueError):
            fn(str(tmp_path), c, rank=1)


def reference_pool(jcfg, adapters: dict, rank=RANK, max_loras=MAX_LORAS):
    """The reference's host pool with {slot: (seed, scale)} synthetic
    adapters written into their slots."""

    class M:
        config = jcfg

    pool = jax_init_lora_pool(M, max_loras, rank)
    for slot, (seed, scale) in adapters.items():
        tree, _ = jax_adapter.synth_adapter(jcfg, rank, seed)
        for m in tree:
            pool["mods"][m]["a"][:, slot] = tree[m]["a"]
            pool["mods"][m]["b"][:, slot] = tree[m]["b"]
        pool["scales"][slot] = scale
    return pool


ADAPTERS = {1: (7, 1.0), 2: (8, 0.5), 3: (9, 2.0)}


def test_pool_layout():
    """lora_pool_from_jax puts every reference plane where the store's
    slot loads write it, and init_lora_pool matches its shapes."""
    cfg, jcfg = LlamaConfig.tiny(), JaxLlamaConfig.tiny()
    ref = reference_pool(jcfg, ADAPTERS)
    pool = lora_pool_from_jax(ref)
    zeros = init_lora_pool(LlamaModel(cfg, device="meta"), MAX_LORAS, RANK, device="cpu")
    assert {k: v.shape for k, v in pool.a.items()} == {k: v.shape for k, v in zeros.a.items()}
    assert {k: v.shape for k, v in pool.b.items()} == {k: v.shape for k, v in zeros.b.items()}
    for m in adapter.LORA_MODULES:
        for slot in range(MAX_LORAS + 1):
            group, cols = pool.a_columns(m, slot)
            np.testing.assert_array_equal(pool.a[group][:, :, cols].numpy(), ref["mods"][m]["a"][:, slot])
            np.testing.assert_array_equal(pool.b[m][:, pool.b_rows(slot)].numpy(), ref["mods"][m]["b"][:, slot])
    np.testing.assert_array_equal(pool.scales.numpy(), ref["scales"])


@pytest.mark.parametrize("ids", ["scalar", "per-token"])
def test_lora_delta_matches_reference(ids):
    rng = np.random.default_rng(3)
    S, din, dout, T = 4, 24, 40, 9
    a = rng.standard_normal((S, din, RANK)).astype(np.float32)
    b = rng.standard_normal((S, RANK, dout)).astype(np.float32)
    a[0], b[0] = 0, 0
    scales = np.array([0.0, 1.0, 0.5, 2.0], np.float32)
    x = rng.standard_normal((T, din)).astype(np.float32)
    row_ids = np.int32(2) if ids == "scalar" else rng.integers(0, S, T).astype(np.int32)
    want = jax_lora_delta(jnp.asarray(x), {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(row_ids),
                          jnp.asarray(scales))
    a_cat = torch.from_numpy(a.transpose(1, 0, 2).reshape(din, S * RANK).copy())
    b_cat = torch.from_numpy(b.reshape(S * RANK, dout).copy())
    got = lora_delta(torch.from_numpy(x), a_cat, b_cat, torch.from_numpy(np.asarray(row_ids)), torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def models():
    """(reference model, its params, the port's model on the same weights,
    the reference pool, the port's pool from it)."""
    jm = JaxLlamaModel(JaxLlamaConfig.tiny())
    params = jm.init_params(jax.random.key(0))
    cfg = LlamaConfig.tiny()
    tm = LlamaModel(cfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    ref = reference_pool(jm.config, ADAPTERS)
    return jm, params, tm, jax.tree.map(jnp.asarray, ref), lora_pool_from_jax(ref)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def lanes_inputs(rng, lens, starts, bucket=8, width=8):
    N = len(lens)
    toks = np.zeros((N, bucket), np.int32)
    pos = np.zeros((N, bucket), np.int32)
    tables = np.zeros((N, width), np.int32)
    next_page = 1
    for j, (n, start) in enumerate(zip(lens, starts)):
        toks[j, :n] = rng.integers(0, 256, n)
        pos[j] = start + np.arange(bucket)
        need = -(-(start + bucket) // PS)
        tables[j, :need] = np.arange(next_page, next_page + need)
        next_page += need
    valid = np.arange(bucket)[None, :] < np.asarray(lens)[:, None]
    return toks, pos, tables, valid


def test_prefill_packed_logits_with_pool(models):
    """Four lanes on four adapter slots (base among them) in one packed call."""
    jm, params, tm, jpool, pool = models
    rng = np.random.default_rng(4)
    toks, pos, tables, valid = lanes_inputs(rng, [7, 5, 8, 3], [0, 0, 0, 0])
    last = np.array([6, 4, 7, 2], np.int32)
    ids = np.array([1, 0, 3, 2], np.int32)
    jkv, tkv = jm.init_kv_cache(NUM_PAGES, PS), tm.init_kv_cache(NUM_PAGES, PS)
    want, _ = jax.jit(jm.prefill_packed)(params, jkv, *map(jnp.asarray, (toks, pos, tables, valid, last)),
                                         lora=jpool, lora_ids=jnp.asarray(ids))
    got, _ = tm.prefill_packed(tkv, *map(_t, (toks, pos, tables, valid, last)), lora=pool, lora_ids=_t(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGITS_ATOL)
    # the adapters bite: the base lane's logits differ from each adapter lane's own base run
    base, _ = tm.prefill_packed(tm.init_kv_cache(NUM_PAGES, PS), *map(_t, (toks, pos, tables, valid, last)))
    assert not torch.allclose(base[0], got[0]) and torch.equal(base[1], got[1])


def test_decode_and_verify_logits_with_pool(models):
    """After a packed prefill, 6 decode steps and one verify pass of 3 rows
    over a batch of 4 slots on slots (2, 0, 1, 3), slot 3 inactive in decode."""
    jm, params, tm, jpool, pool = models
    rng = np.random.default_rng(5)
    toks, pos, tables, valid = lanes_inputs(rng, [6, 4, 7, 5], [0, 0, 0, 0], bucket=8, width=8)
    last = np.array([5, 3, 6, 4], np.int32)
    ids = np.array([2, 0, 1, 3], np.int32)
    jkv, tkv = jm.init_kv_cache(NUM_PAGES, PS), tm.init_kv_cache(NUM_PAGES, PS)
    jl, jkv = jax.jit(jm.prefill_packed)(params, jkv, *map(jnp.asarray, (toks, pos, tables, valid, last)),
                                         lora=jpool, lora_ids=jnp.asarray(ids))
    tl, tkv = tm.prefill_packed(tkv, *map(_t, (toks, pos, tables, valid, last)), lora=pool, lora_ids=_t(ids))
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    p = last + 1
    active = np.array([True, True, True, False])
    decode = jax.jit(jm.decode)
    for _ in range(6):
        jl, jkv = decode(params, jkv, jnp.asarray(nxt), jnp.asarray(p), jnp.asarray(tables), jnp.asarray(active),
                         lora=jpool, lora_ids=jnp.asarray(ids))
        tl, tkv = tm.decode(tkv, _t(nxt), _t(p), _t(tables), _t(active), lora=pool, lora_ids=_t(ids))
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], atol=LOGITS_ATOL)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        p = p + active
    fed = np.stack([nxt, rng.integers(0, 256, 4), rng.integers(0, 256, 4)], axis=1).astype(np.int32)
    vpos = (p[:, None] + np.arange(3)[None, :]).astype(np.int32)
    vvalid = np.ones((4, 3), bool)
    jl, _ = jax.jit(jm.verify)(params, jkv, *map(jnp.asarray, (fed, vpos, tables, vvalid)), lora=jpool,
                               lora_ids=jnp.asarray(ids))
    tl, _ = tm.verify(tkv, *map(_t, (fed, vpos, tables, vvalid)), lora=pool, lora_ids=_t(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL)


def greedy_chain(model, prompt, steps, lora=None, lora_id=0):
    """Greedy tokens through prefill + decode (B 2, lane 1 idle)."""
    kv = model.init_kv_cache(NUM_PAGES, PS)
    T, mp = 16, 16
    table = np.zeros(mp, np.int32)
    table[: -(-(len(prompt) + steps) // PS)] = np.arange(1, -(-(len(prompt) + steps) // PS) + 1)
    toks = np.zeros(T, np.int32)
    toks[: len(prompt)] = prompt
    kw = {} if lora is None else dict(lora=lora, lora_id=lora_id)
    logits, kv = model.prefill(kv, _t(toks), torch.arange(T, dtype=torch.int32), _t(table),
                               torch.arange(T) < len(prompt), len(prompt) - 1, **kw)
    out, all_logits = [int(logits.argmax())], [logits]
    tables = _t(np.stack([table, np.zeros(mp, np.int32)]))
    for i in range(steps - 1):
        kw = {} if lora is None else dict(lora=lora, lora_ids=torch.tensor([lora_id, 0], dtype=torch.int32))
        logits, kv = model.decode(kv, torch.tensor([out[-1], 0], dtype=torch.int32),
                                  torch.tensor([len(prompt) + i, 0], dtype=torch.int32), tables,
                                  torch.tensor([True, False]), **kw)
        out.append(int(logits[0].argmax()))
        all_logits.append(logits[0])
    return out, torch.stack(all_logits)


PROMPT = [3, 1, 4, 1, 5, 9, 2]


def test_merged_weight_parity_and_zero_slot(models):
    """Each adapter's pass is token-identical to the merged weights (f32);
    slot 0 leaves every logit bit-equal to the model without a pool."""
    _, _, tm, _, pool = models
    cfg = tm.config
    for slot, (seed, scale) in ADAPTERS.items():
        tree, _ = adapter.synth_adapter(cfg, RANK, seed)
        merged = LlamaModel(cfg)
        merged.load_state_dict(tm.state_dict())
        merged.load_state_dict(merge_adapter_into_params(tm, tree, scale), strict=False)
        want, _ = greedy_chain(merged, PROMPT, 12)
        got, _ = greedy_chain(tm, PROMPT, 12, lora=pool, lora_id=slot)
        assert got == want, f"slot {slot}: {got} != merged {want}"
    base, base_logits = greedy_chain(tm, PROMPT, 12)
    zero, zero_logits = greedy_chain(tm, PROMPT, 12, lora=pool, lora_id=0)
    assert zero == base and torch.equal(zero_logits, base_logits)
    assert greedy_chain(tm, PROMPT, 12, lora=pool, lora_id=1)[0] != base


def test_merge_refuses_quantized_weights():
    cfg = LlamaConfig.tiny(quantize="int8_wo")
    model = LlamaModel(cfg)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    model.quantize_()
    tree, scale = adapter.synth_adapter(cfg, RANK, 1)
    with pytest.raises(ValueError):
        merge_adapter_into_params(model, tree, scale)
