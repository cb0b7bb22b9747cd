"""The port's plain attention / norm / rope ops against the JAX reference and
the Pallas kernels in interpret mode, on the same numpy-seeded inputs at f32
(tolerance 1e-5 absolute: the same f32 algebra summed in another order).

The Pallas kernels run in interpret mode through their per-program twins
(``paged_decode_attention_pallas``, ``paged_prefill_attention_pallas(...,
lookahead=False)``): the lookahead variants compute the same function but pin
``pltpu.TPUCompilerParams``, which the installed JAX no longer has.

The CUDA kernels K1/K2 themselves run only on the card:
tests/test_torch_kernels_cuda.py holds them against these plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jref
from dynamo_tpu.ops.norms import rms_norm as j_rms_norm
from dynamo_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from dynamo_tpu.ops.pallas.prefill_attention import paged_prefill_attention_pallas
from dynamo_tpu.ops.rotary import apply_rope as j_apply_rope
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops.kernels.paged_attention import (
    check_decode_args,
    paged_decode_attention_kernel,
)
from dynamo_tpu_torch.ops.kernels.prefill_attention import (
    check_prefill_args,
    paged_prefill_attention_kernel,
)
from dynamo_tpu_torch.ops.norms import rms_norm
from dynamo_tpu_torch.ops.rotary import apply_rope

torch.set_num_threads(2)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def decode_case(B=4, Hq=4, Hkv=2, D=16, P=24, ps=4, max_pages=6, seed=0):
    """Distinct pages per sequence; lengths 1 (one-token context), ragged,
    and full; tables padded with the trash page 0 past each used length."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    positions = np.array([0, 9, 14, max_pages * ps - 1][:B], np.int32)
    pt = np.zeros((B, max_pages), np.int32)
    for b in range(B):
        used = positions[b] // ps + 1
        pt[b, :used] = rng.choice(np.arange(1, P), size=used, replace=False)
    return q, k, v, pt, positions


@pytest.mark.parametrize(
    "Hq,Hkv,D", [(4, 2, 128), (4, 4, 128), (8, 2, 16), (4, 4, 16)],
    ids=["gqa-d128", "mha-d128", "gqa-d16", "mha-d16"],
)
def test_decode_plain_matches_reference_and_pallas(Hq, Hkv, D):
    q, k, v, pt, pos = decode_case(Hq=Hq, Hkv=Hkv, D=D, seed=Hq + D)
    got = tatt.paged_decode_attention(_t(q), _t(k), _t(v), _t(pt), _t(pos)).numpy()
    ref = np.asarray(jref.paged_decode_attention(*map(jnp.asarray, (q, k, v, pt, pos))))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    pallas = np.asarray(paged_decode_attention_pallas(
        *map(jnp.asarray, (q, k, v, pt, pos)), interpret=True
    ))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    # the dispatcher takes the plain version for CPU tensors
    dispatched = tatt.dispatch_paged_decode_attention(_t(q), _t(k), _t(v), _t(pt), _t(pos)).numpy()
    np.testing.assert_array_equal(dispatched, got)


def test_decode_plain_negative_position_attends_index_zero():
    """K1's rule in the plain version: a position below 0 attends context
    index 0 only, exactly the position-0 result (the reference's plain
    version spreads a uniform softmax over the table instead)."""
    q, k, v, pt, pos = decode_case(seed=7)
    at = {}
    for p in (-1, 0):
        pos_p = pos.copy()
        pos_p[1] = p
        at[p] = tatt.paged_decode_attention(_t(q), _t(k), _t(v), _t(pt), _t(pos_p)).numpy()
    np.testing.assert_array_equal(at[-1], at[0])
    kvh = np.repeat(np.arange(k.shape[2]), q.shape[1] // k.shape[2])
    np.testing.assert_array_equal(at[-1][1], v[pt[1, 0], 0][kvh])


def prefill_case(T=128, Hq=4, Hkv=2, D=16, P=64, ps=4, max_pages=48, start=0, n_valid=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    n_valid = T if n_valid is None else n_valid
    used = -(-(start + n_valid) // ps)
    pt = np.zeros(max_pages, np.int32)  # trash-page padding past the used pages
    pt[:used] = rng.choice(np.arange(1, P), size=used, replace=False)
    positions = (start + np.arange(T)).astype(np.int32)  # pad rows stay unit-stride
    return q, k, v, pt, positions


@pytest.mark.parametrize(
    "Hq,Hkv,D,start,n_valid",
    [(4, 2, 128, 0, 128), (4, 4, 16, 0, 100), (8, 2, 16, 57, 128)],
    ids=["gqa-d128", "mha-d16-padrows", "gqa-d16-cached-prefix"],
)
def test_prefill_plain_matches_reference_and_pallas(Hq, Hkv, D, start, n_valid):
    q, k, v, pt, pos = prefill_case(Hq=Hq, Hkv=Hkv, D=D, start=start, n_valid=n_valid, seed=D + start)
    got = tatt.paged_prefill_attention(_t(q), _t(k), _t(v), _t(pt), _t(pos)).numpy()
    ref = np.asarray(jref.paged_prefill_attention(*map(jnp.asarray, (q, k, v, pt, pos))))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    pallas = np.asarray(paged_prefill_attention_pallas(
        *map(jnp.asarray, (q, k, v, pt, pos)), interpret=True, lookahead=False
    ))
    np.testing.assert_allclose(got[:n_valid], pallas[:n_valid], atol=ATOL)


def test_prefill_lanes_match_per_lane_reference():
    """The packed-lane form (one kernel launch on the card) equals the
    reference per lane, a pad lane (n=0, all-zero table) included."""
    T, ps, P, mp = 32, 4, 40, 16
    q0, k, v, pt0, pos0 = prefill_case(T=T, P=P, ps=ps, max_pages=mp, start=5, seed=1)
    q1, _, _, pt1, pos1 = prefill_case(T=T, P=P, ps=ps, max_pages=mp, start=0, seed=2)
    q_pad = np.random.default_rng(3).standard_normal(q0.shape).astype(np.float32)
    pt_pad = np.zeros(mp, np.int32)
    pos_pad = np.arange(T, dtype=np.int32)
    q = np.concatenate([q0, q1, q_pad])
    pts = np.stack([pt0, pt1, pt_pad])
    poss = np.stack([pos0, pos1, pos_pad])
    got = tatt.dispatch_paged_prefill_attention(_t(q), _t(k), _t(v), _t(pts), _t(poss)).numpy()
    for j, (qj, ptj, posj) in enumerate([(q0, pt0, pos0), (q1, pt1, pos1), (q_pad, pt_pad, pos_pad)]):
        ref = np.asarray(jref.paged_prefill_attention(*map(jnp.asarray, (qj, k, v, ptj, posj))))
        np.testing.assert_allclose(got[j * T : (j + 1) * T], ref, atol=ATOL, err_msg=f"lane {j}")
    assert np.isfinite(got).all()


def test_scatter_kv_matches_reference():
    rng = np.random.default_rng(4)
    LP, ps, Hkv, D, T = 12, 4, 2, 8, 7
    k = rng.standard_normal((LP, ps, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((LP, ps, Hkv, D)).astype(np.float32)
    k_new = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((T, Hkv, D)).astype(np.float32)
    phys = np.array([3, 3, 5, 7, 11, 1, 2], np.int32)
    offs = np.array([0, 1, 3, 2, 0, 1, 3], np.int32)
    jk, jv = jref.scatter_kv(*map(jnp.asarray, (k, v, k_new, v_new, phys, offs)))
    tk, tv = _t(k.copy()), _t(v.copy())
    out_k, out_v = tatt.scatter_kv(tk, tv, _t(k_new), _t(v_new), _t(phys), _t(offs))
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_write_kv_pages_routes_invalid_rows_to_trash():
    rng = np.random.default_rng(5)
    k = np.zeros((8, 4, 1, 4), np.float32)
    k_new = rng.standard_normal((6, 1, 4)).astype(np.float32)
    pos = np.arange(3, 9, dtype=np.int32)
    pt = np.array([6, 2, 5], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    jk, _ = jref.write_kv_pages(*map(jnp.asarray, (k, k, k_new, k_new, pos, pt, valid)), trash_page=0)
    tk, tv = _t(k.copy()), _t(k.copy())
    tatt.write_kv_pages(tk, tv, _t(k_new), _t(k_new), _t(pos), _t(pt), _t(valid), trash_page=0)
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])  # page 0 is trash


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w), 1e-5).numpy(), np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=ATOL,
    )
    pos = np.array([0, 1, 7, 130, 4095], np.int32)
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            apply_rope(_t(x), _t(pos), theta).numpy(),
            np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            atol=ATOL,
        )


def test_kernel_arg_checks_raise_on_shapes_the_kernels_do_not_take():
    q, k, v, pt, pos = (_t(a) for a in decode_case(Hq=4, Hkv=2, D=128))
    check_decode_args(q, k, v, pt, pos)  # the main-path form passes
    with pytest.raises(ValueError, match="head_dim"):
        qs, ks, vs, pts, poss = (_t(a) for a in decode_case(Hq=4, Hkv=2, D=16))
        check_decode_args(qs, ks, vs, pts, poss)
    with pytest.raises(ValueError, match="int32"):
        check_decode_args(q, k, v, pt, pos.long())
    check_decode_args(q.repeat(1, 8, 1), k, v, pt, pos)  # G 16: any group launches (sub-group blocks)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        check_decode_args(q[:, :3], k, v, pt, pos)
    qp, kp, vp, ptp, posp = (_t(a) for a in prefill_case(D=128))
    check_prefill_args(qp, kp, vp, ptp[None], posp[None])
    with pytest.raises(ValueError, match="dtype"):
        check_prefill_args(qp.double(), kp, vp, ptp[None], posp[None])
    # the launchers take CUDA tensors only: a CPU tensor is refused, never
    # computed by a plain version behind the caller's back
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_kernel(q, k, v, pt, pos)
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill_attention_kernel(qp, kp, vp, ptp, posp)
    # the dispatchers send a device that is neither the CPU nor a card to the
    # launcher, which refuses it
    with pytest.raises(ValueError, match="CUDA"):
        tatt.dispatch_paged_decode_attention(*(t.to("meta") for t in (q, k, v, pt, pos)))
