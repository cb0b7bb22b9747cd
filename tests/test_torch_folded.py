"""Head dims that are not a multiple of 128 (TinyLlama's 64): the reference
folds such pools to ``[P, ps, Hkv*D]`` and routes them to its folded Pallas
kernels (K3a ``paged_decode_attention_pallas_folded``, K3b
``paged_prefill_attention_pallas_folded``); the port keeps the unfolded pool
(the same memory) and routes CUDA tensors to its K3a/K3b kernels, CPU tensors
to the plain versions.

Here the port's plain versions are held against the folded Pallas kernels in
interpret mode on the same numpy-seeded inputs, folded pools on the JAX
side, at D 16, 32 and 64, and at the head geometries the launchers were
widened to (D 8 over 16 kv heads, D 80 over 8, D 96 over 4 kv heads with G
3), all with Hkv*D a multiple of 128 (the reference dispatcher's condition),
over f32 and int8 pools; tolerance 1e-5 (f32, the
same algebra in another order, outputs O(1)). The dispatch rule is checked
as a pure function, and a D=64 tiny LlamaModel against the JAX model, whose
pools are folded, at 1e-4 on logits. The kernels themselves run only on the
card (tests/test_torch_kernels_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from dynamo_tpu.models.llama import LlamaModel as JaxLlamaModel
from dynamo_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas_folded
from dynamo_tpu.ops.pallas.prefill_attention import paged_prefill_attention_pallas_folded
from dynamo_tpu.quant import kv as jkv
from dynamo_tpu_torch.models.convert import kv_from_jax, params_from_jax
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels.paged_attention import (
    check_decode_args,
    paged_decode_attention_folded_kernel,
    paged_decode_attention_kernel,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    paged_prefill_attention_folded_kernel,
    paged_prefill_attention_kernel,
)
from dynamo_tpu_torch.quant import kv as tkv

torch.set_num_threads(2)

ATOL = 1e-5
LOGIT_ATOL = 1e-4
# (D, Hkv, Hq): Hkv * D a multiple of 128
GEOMETRIES = [(16, 8, 16), (32, 4, 8), (64, 2, 8), (8, 16, 32), (80, 8, 16), (96, 4, 12)]
GEOMETRY_IDS = ["d16", "d32", "d64", "d8", "d80", "d96-g3"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def pools(rng, P, ps, Hkv, D, kind):
    """(JAX folded pools, port unfolded pools) holding the same values:
    f32 rows, or int8 codes with their scales."""
    k = rng.standard_normal((P * ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P * ps, Hkv, D)).astype(np.float32)
    if kind == "f32":
        return ([jnp.asarray(x.reshape(P, ps, Hkv * D)) for x in (k, v)],
                [_t(x.reshape(P, ps, Hkv, D)) for x in (k, v)])
    jp, tp = [], []
    for x in (k, v):
        q, s = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(x)))
        jp.append(jkv.QuantizedPages(jnp.asarray(q.reshape(P, ps, Hkv * D)), jnp.asarray(s.reshape(P, ps))))
        tp.append(tkv.QuantizedPages(_t(q.reshape(P, ps, Hkv, D).copy()), _t(s.reshape(P, ps).copy())))
    return jp, tp


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("D,Hkv,Hq", GEOMETRIES, ids=GEOMETRY_IDS)
def test_folded_decode_plain_matches_pallas(D, Hkv, Hq, kind):
    """Ragged contexts (one token, mid-page, page edges, the full table) and
    tables padded with the trash page past each length."""
    rng = np.random.default_rng(D + Hq + len(kind))
    B, P, ps, mp = 5, 40, 4, 8
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    pos = np.array([0, 6, 15, 20, mp * ps - 1], np.int32)
    pt = np.zeros((B, mp), np.int32)
    for b in range(B):
        used = pos[b] // ps + 1
        pt[b, :used] = rng.choice(np.arange(1, P), size=used, replace=False)
    (jk, jv), (tk, tv) = pools(rng, P, ps, Hkv, D, kind)
    got = tatt.dispatch_paged_decode_attention(_t(q), tk, tv, _t(pt), _t(pos)).numpy()
    want = paged_decode_attention_pallas_folded(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(pos), interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("D,Hkv,Hq", GEOMETRIES, ids=GEOMETRY_IDS)
def test_folded_prefill_plain_matches_pallas(D, Hkv, Hq, kind):
    """A 64-row chunk (the folded kernel's block_q) after a cached prefix of
    37 rows, the last 9 rows padding; the packed-lane form gives the same."""
    rng = np.random.default_rng(D + Hq + len(kind) + 1)
    T, start, n_valid, P, ps, mp = 64, 37, 55, 20, 16, 8
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    used = -(-(start + T) // ps)
    pt = np.zeros(mp, np.int32)
    pt[:used] = rng.choice(np.arange(1, P), size=used, replace=False)
    pos = (start + np.arange(T)).astype(np.int32)
    (jk, jv), (tk, tv) = pools(rng, P, ps, Hkv, D, kind)
    got = tatt.dispatch_paged_prefill_attention(_t(q), tk, tv, _t(pt), _t(pos)).numpy()
    want = paged_prefill_attention_pallas_folded(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(pos), block_q=64, interpret=True
    )
    np.testing.assert_allclose(got[:n_valid], np.asarray(want)[:n_valid], atol=ATOL)
    lanes = tatt.dispatch_paged_prefill_attention(_t(q), tk, tv, _t(pt)[None], _t(pos)[None]).numpy()
    np.testing.assert_array_equal(lanes, got)


@pytest.mark.parametrize("D,folded", [(16, True), (32, True), (64, True), (96, True), (128, False), (256, False)])
def test_dispatch_rule_follows_the_reference(D, folded):
    """head_dim % 128 != 0 -> K3a / K3b, else K1 / K2: the reference's
    LlamaConfig.kv_folded, checked without launching anything."""
    assert tatt.kv_folded(D) == folded == JaxLlamaConfig.tiny(head_dim=D).kv_folded
    assert LlamaConfig.tiny(head_dim=D).kv_folded == folded
    assert tatt.decode_kernel(D) is (paged_decode_attention_folded_kernel if folded else paged_decode_attention_kernel)
    assert tatt.prefill_kernel(D) is (paged_prefill_attention_folded_kernel if folded else paged_prefill_attention_kernel)


def test_folded_launchers_refuse_cpu_and_unsupported_shapes():
    """The K3 launchers take CUDA tensors only, and their argument checks
    refuse what the kernels do not take (run here on CPU tensors)."""
    from dynamo_tpu_torch.ops.kernels.paged_attention import check_folded_decode_args
    from dynamo_tpu_torch.ops.kernels.prefill_attention import check_folded_prefill_args

    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((2, 8, 64)).astype(np.float32))
    k = torch.zeros((5, 4, 2, 64))
    pt = torch.zeros((2, 3), dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    check_folded_decode_args(q, k, k, pt, pos)
    check_folded_decode_args(q, k.reshape(5, 4, 128), k.reshape(5, 4, 128), pt, pos)  # folded view
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_folded_kernel(q, k, k, pt, pos)
    with pytest.raises(ValueError, match="head_dim"):
        check_folded_decode_args(q.repeat(1, 1, 2), k.repeat(1, 1, 1, 2), k.repeat(1, 1, 1, 2), pt, pos)
    # 100 (no multiple of 8: rows start off 16 bytes), 20 over 4 kv heads,
    # 192 (above 128), 264 (past 256) and 520 (past 512: the runtime-D body)
    # launch; 384 and 640 (multiples of 128) are K1's: its check takes them
    # and K3a's refuses them
    check_folded_decode_args(q[..., :50].repeat(1, 1, 2), *[torch.zeros((5, 4, 2, 100))] * 2, pt, pos)
    check_folded_decode_args(q[..., :20].repeat(1, 2, 1), *[torch.zeros((5, 4, 4, 20))] * 2, pt, pos)
    check_folded_decode_args(q.repeat(1, 1, 3), *[torch.zeros((5, 4, 2, 192))] * 2, pt, pos)
    check_folded_decode_args(q[..., :33].repeat(1, 1, 8), *[torch.zeros((5, 4, 2, 264))] * 2, pt, pos)
    for D in (384, 520):
        args = (torch.zeros((2, 8, D)), *[torch.zeros((5, 4, 2, D))] * 2, pt, pos)
        (check_decode_args if D % 128 == 0 else check_folded_decode_args)(*args)
        with pytest.raises(ValueError, match="head_dim"):
            (check_folded_decode_args if D % 128 == 0 else check_decode_args)(*args)
    with pytest.raises(ValueError, match="dtype"):
        check_folded_decode_args(q, k.bfloat16(), k.bfloat16(), pt, pos)
    check_folded_decode_args(q.repeat(1, 4, 1), k, k, pt, pos)  # G 16: any group launches
    check_folded_decode_args(q[..., :48].repeat(1, 3, 2), *[torch.zeros((5, 4, 8, 96))] * 2, pt, pos)  # D 96, G 3
    with pytest.raises(ValueError, match="multiple of Hkv"):
        check_folded_decode_args(q[:, :7], k, k, pt, pos)
    qp = _t(rng.standard_normal((64, 32, 64)).astype(np.float32))
    kp = torch.zeros((5, 4, 4, 64))
    check_folded_prefill_args(qp, kp, kp, pt[:1], torch.arange(64, dtype=torch.int32)[None])
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_attention_folded_kernel(qp, kp, kp, pt[0], torch.arange(64, dtype=torch.int32))
    check_folded_prefill_args(qp[:, :24], kp, kp, pt[:1], torch.arange(64, dtype=torch.int32)[None])  # G 6
    with pytest.raises(ValueError, match="Hq"):
        check_folded_prefill_args(qp[:, :30], kp, kp, pt[:1], torch.arange(64, dtype=torch.int32)[None])
    wide = torch.zeros((5, 4, 16, 64))  # Hkv*D 1024: the tensor-core body takes any width
    check_folded_prefill_args(qp, wide, wide, pt[:1], torch.arange(64, dtype=torch.int32)[None])
    with pytest.raises(ValueError, match="Hkv"):
        odd = torch.zeros((5, 4, 3, 64))  # Hq 32 is no multiple of Hkv 3
        check_folded_prefill_args(qp, odd, odd, pt[:1], torch.arange(64, dtype=torch.int32)[None])
    qi = tkv.init_quantized_pages((5, 4, 2, 64))
    check_folded_decode_args(q, qi, tkv.init_quantized_pages((5, 4, 2, 64)), pt, pos)
    with pytest.raises(ValueError, match="QuantizedPages"):
        check_folded_decode_args(q, qi, k, pt, pos)


@pytest.mark.parametrize("head_dim", [64, 32])
def test_llama_folded_head_dim_matches_reference(head_dim):
    """A tiny Llama at head_dim 64 (Hkv*D = 128, JAX folds its pools): a
    prefill, then 6 decode steps over a batch of 2; logits at 1e-4, pools
    equal after kv_from_jax unfolds the reference's."""
    over = dict(head_dim=head_dim)
    jm = JaxLlamaModel(JaxLlamaConfig.tiny(**over))
    params = jm.init_params(jax.random.key(1))
    cfg = LlamaConfig.tiny(**over)
    tm = LlamaModel(cfg)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    jcache, tcache = jm.init_kv_cache(16, 4), tm.init_kv_cache(16, 4)
    assert jcache["k"].ndim == 3 and tcache["k"].ndim == 4  # folded there, unfolded here
    rng = np.random.default_rng(head_dim)
    tokens = np.zeros(8, np.int32)
    tokens[:7] = rng.integers(0, 256, 7)
    pos = np.arange(8, dtype=np.int32)
    table = np.array([3, 7, 1, 5, 0, 0, 0, 0], np.int32)
    valid = np.arange(8) < 7
    jlogits, jcache = jax.jit(jm.prefill)(params, jcache, *map(jnp.asarray, (tokens, pos, table, valid)), 6)
    tlogits, tcache = tm.prefill(tcache, _t(tokens), _t(pos), _t(table), _t(valid), 6)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=LOGIT_ATOL)
    decode = jax.jit(jm.decode)
    tables = np.stack([table, np.zeros(8, np.int32)])
    toks = np.array([int(jnp.argmax(jlogits)), 0], np.int32)
    positions = np.array([7, 0], np.int32)
    active = np.array([True, False])
    for _ in range(6):
        jlogits, jcache = decode(params, jcache, *map(jnp.asarray, (toks, positions, tables, active)))
        tlogits, tcache = tm.decode(tcache, _t(toks), _t(positions), _t(tables), _t(active))
        np.testing.assert_allclose(tlogits.numpy()[:1], np.asarray(jlogits)[:1], atol=LOGIT_ATOL)
        toks = np.where(active, np.asarray(jnp.argmax(jlogits, axis=-1)), 0).astype(np.int32)
        positions = positions + active
    keep = np.ones(cfg.num_layers * 16, bool)
    keep[::16] = False  # per-layer trash pages
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy()[keep],
                                   kv_from_jax(np.asarray(jcache[name]), cfg).numpy()[keep], atol=LOGIT_ATOL)
