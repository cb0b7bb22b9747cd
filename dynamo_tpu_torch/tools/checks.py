"""Kernel-against-plain checks shared by ``chip_smoke.py``, the kernel
profilers (``tools/profile_attn.py``, ``tools/profile_prefill.py``) and the
card tests: the elementwise tolerance a kernel is held to, what probabilities
rounded at a bf16 boundary may add to it, pools whose checksums are exact,
and a runner's graph replays run against its eager bodies
(:func:`graph_against_eager`).

Kernel vs plain, elementwise |got - ref| <= atol + rtol * |ref|. Both sides
compute in f32 from the same inputs and differ there only in summation order
(max 1e-6 for K1, 6e-6 for K2 at f32 on an H100); a bf16 output is rounded
once at the end, and two roundings of nearly equal values differ by at most
one bf16 step, <= 2^-7 |value|. So bf16 gets rtol 2^-6 (two steps) on top of
the f32 atol: at the ~0.03 outputs of 2048-key rows the limit is ~6e-4, below
the ~1e-3 that one dropped page of keys moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.ops.attention import gather_pages
from dynamo_tpu_torch.quant.kv import QuantizedPages

TOL = {"f32": (1e-4, 0.0), "bf16": (1e-4, 2.0**-6)}


def tol_share(got: torch.Tensor, ref: torch.Tensor, tol: str) -> tuple[float, float]:
    """(max |got - ref|, the largest share of the limit ``TOL[tol]`` any
    element uses): the check passes iff the share is <= 1. A non-finite
    output gives an infinite share."""
    atol, rtol = TOL[tol]
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if not torch.isfinite(got).all():
        return float("inf"), float("inf")
    return diff.max().item(), (diff / (atol + rtol * ref.abs())).max().item()


def rounding_slack(q, k_pages, v_pages, page_tables, positions, chunk_rows: int,
                   rel: float = 2.0**-16) -> torch.Tensor:
    """f32 [B, Hq, D]: how far probabilities that lie at a rounding boundary
    may move the rounded walk of ``chunk_rows``-row chunks
    (``ops/attention.py paged_decode_attention_rounded``, the function of
    K4a, K4b and K7c) over plain pools.

    Each chunk's probabilities p = exp(s - M_c), M_c the running max after
    the chunk, are rounded to the pool dtype before P.V. A kernel's scores
    differ from the plain version's by summation order (about 1e-6 absolute,
    so about 1e-6 of p), so a p within ``rel`` (1.5e-5) of a bf16 rounding
    boundary may round up on one side and down on the other: one bf16 step
    at p. Summed over those p, step * e^(M_c - M_n) * |V| / l bounds what
    such flips move an output element (M_n the final max, l the final sum).
    Every other p must round the same on both sides: a wrong rounding point
    moves many of them and breaks TOL plus this slack. Zero over f32 pools
    (no rounding)."""
    B, Hq, D = q.shape
    if k_pages.dtype == torch.float32:
        return torch.zeros((B, Hq, D), device=q.device)
    k = gather_pages(k_pages, page_tables).float()  # [B, S, Hkv, D]
    S, Hkv = k.shape[1], k.shape[2]
    valid = torch.arange(S, device=q.device)[None, :] < (positions.long() + 1).clamp(1, S)[:, None]
    v = torch.where(valid[:, :, None, None], gather_pages(v_pages, page_tables).float(), 0.0)
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, Hq // Hkv, D), k) / D**0.5
    s = torch.where(valid[:, None, None, :], s, float("-inf"))
    n = -(-S // chunk_rows)
    chunk_max = torch.nn.functional.pad(s, (0, n * chunk_rows - S), value=float("-inf"))
    chunk_max = chunk_max.reshape(*s.shape[:3], n, chunk_rows).amax(-1)
    m = torch.cummax(chunk_max, -1).values.repeat_interleave(chunk_rows, -1)[..., :S]  # M_c of each row
    p = torch.exp(s - m)
    w = torch.exp(m - m[..., -1:])
    lo, hi = ((p * f).to(k_pages.dtype).float() for f in (1 - rel, 1 + rel))
    steps = torch.where(lo != hi, hi - lo, 0.0) * w
    l = (w * p).sum(-1)
    return (torch.einsum("bkgs,bskd->bkgd", steps, v.abs()) / l[..., None]).reshape(B, Hq, D)


def exact_pools(shape, kind: str, device, generator: torch.Generator | None = None) -> list:
    """K and V pools of ``kind`` (float32, bfloat16 or int8) holding
    multiples of 1/8 in [-1, 1] (int8: codes times the scale 2^-7, as
    ``QuantizedPages``), so that every f32 sum of up to 2^16 of their values
    is exact in any order and the load-only twins' checksums (K7a, K7b) can
    be held exactly."""
    out = []
    for _ in range(2):
        if kind == "int8":
            codes = torch.randint(-127, 128, shape, device=device, dtype=torch.int8, generator=generator)
            out.append(QuantizedPages(codes, torch.full(shape[:2], 2.0**-7, device=device)))
        else:
            x = torch.randint(-8, 9, shape, device=device, generator=generator).float() / 8
            out.append(x.to(getattr(torch, kind)))
    return out


def graph_against_eager(runner, prompts: list) -> dict:
    """Prefill calls and decode windows over ``prompts`` (prompt i into slot
    i, in pages 1 + ...; one packed call of all of them on the packed path,
    a call each off it), run twice from the same state: replayed from the
    runner's graphs (``runner.warmup()`` captures their shapes first, with
    trash-page writes, so these calls capture nothing) and through its eager
    bodies. The calls, in order:

      1. a greedy prefill ("first": tokens [n]);
      2. a greedy window from the prompts' ends ("window": tokens [K, n]);
      3. the slots' penalty state seeded with their prompts, then the
         prompts prefilled again with penalties (repetition 1.3, frequency
         0.5, presence 0.5), min_tokens 2 with each prompt's first token as
         its EOS id, and logprobs ("first_both": tokens, chosen logprobs,
         top ids, top logprobs);
      4. the extras window from the prompts' ends with those penalties and
         EOS ids ("window_extras");
      5. a logprobs window after it ("window_lp": tokens, chosen logprobs,
         top ids, top logprobs).

    Returns {"graph": run, "eager": run, "captures": the graph run's
    captures (0 when it replayed)}, each run also holding "pools" (the KV
    pools without each layer's trash page), "penalty" (the slots' counts
    and seen rows) and "logits" (the last window's last-step logits [n,
    V]). Plain (not int8) pools."""
    from dynamo_tpu_torch.engine.sampling import MAX_EOS_IDS, SamplingParams

    cfg, n, ps, K = runner.config, len(prompts), runner.config.page_size, runner.config.decode_steps
    V = runner.model.config.vocab_size
    greedy = SamplingParams()
    both = SamplingParams(repetition_penalty=1.3, frequency_penalty=0.5, presence_penalty=0.5, min_tokens=2)
    tables, first_page = [], 1
    for p in prompts:
        used = -(-(len(p) + 2 * K) // ps)
        table = np.zeros(cfg.table_bucket_for(used), np.int32)
        table[:used] = first_page + np.arange(used)
        first_page += used
        tables.append(table)
    W = max(len(t) for t in tables)
    B = cfg.max_seqs
    positions, limits = np.zeros(B, np.int32), np.zeros(B, np.int32)
    page_tables, active = np.zeros((B, W), np.int32), np.zeros(B, bool)
    penalties = np.tile(np.array([[0.0], [0.0], [1.0]], np.float32), (1, B))
    eos_rows, eos_from = np.full((B, MAX_EOS_IDS), V, np.int32), np.zeros(B, np.int32)
    for i, (p, t) in enumerate(zip(prompts, tables)):
        positions[i], limits[i], active[i] = len(p), len(p) + K - 1, True
        page_tables[i, : len(t)] = t
        penalties[:, i] = (both.presence_penalty, both.frequency_penalty, both.repetition_penalty)
        eos_rows[i, 0], eos_from[i] = p[0], len(p) + both.min_tokens - 1
    greedy_window = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32), K)
    runner.warmup()
    state = {name: t.clone() for name, t in runner.kv_cache.items()}
    slots = {name: t.clone() for name, t in runner.slot_state.items()}
    L = runner.model.config.num_layers

    def prefill(sampling, want_lp: bool):
        eos = [(p[0],) if sampling.min_tokens else () for p in prompts]
        lanes = [(np.asarray(p, np.int32), 0, t, i, sampling, e, True)
                 for i, (p, t, e) in enumerate(zip(prompts, tables, eos))]
        if runner.packed_prefill_mode:
            got = runner.prefill_chunk_batch(lanes, N=1 << (n - 1).bit_length(), want_logprobs=want_lp).numpy()
            return tuple(a[:n] for a in got) if want_lp else got[:n]
        got = [runner.prefill_chunk(*lane[:3], sample=True, sampling=sampling, slot=i, eos_ids=lane[5],
                                    want_logprobs=want_lp).numpy() for i, lane in enumerate(lanes)]
        return tuple(np.concatenate(a) for a in zip(*got)) if want_lp else np.concatenate(got)

    def run(eager: bool) -> dict:
        for name, t in runner.kv_cache.items():
            t.copy_(state[name])
        for name, t in runner.slot_state.items():
            t.copy_(slots[name])
        graphs, compiles = runner.graphs, runner.compile_monitor.compiles
        if eager:
            runner.graphs = None
        try:
            out = {"first": prefill(greedy, False)}
            out["window"] = runner.dispatch_decode_window(positions, page_tables, active, limits,
                                                          *greedy_window).numpy()[:, :n]
            for i, p in enumerate(prompts):
                runner.seed_penalty_slot(i, p)
            out["first_both"] = prefill(both, True)
            out["window_extras"] = runner.dispatch_decode_window(
                positions, page_tables, active, limits, *greedy_window, penalties=penalties,
                eos_allowed_from=eos_from, eos_ids=eos_rows).numpy()[:, :n]
            lp = runner.dispatch_decode_window(positions + K, page_tables, active, limits + K, *greedy_window,
                                               want_logprobs=True).numpy()
            out["window_lp"] = tuple(a[:, :n] for a in lp)
            out["logits"] = runner.last_logits[:n].float().clone()
        finally:
            runner.graphs = graphs
        out["pools"] = [t.reshape(L, cfg.num_pages, -1)[:, 1:].clone() for t in runner.kv_cache.values()]
        out["penalty"] = [runner.slot_state[name][:n].clone() for name in ("counts", "seen")]
        out["captures"] = runner.compile_monitor.compiles - compiles
        return out

    graph = run(False)
    return {"graph": graph, "eager": run(True), "captures": graph.pop("captures")}


def same_run(a: dict, b: dict) -> list:
    """The keys of two ``graph_against_eager`` runs whose tokens, logprob
    arrays, KV pools or penalty state differ (bit for bit); logits aside."""
    differ = []
    for key in ("first", "window", "first_both", "window_extras", "window_lp"):
        x, y = a[key], b[key]
        if isinstance(x, tuple):
            if not all(np.array_equal(u, v) for u, v in zip(x, y)):
                differ.append(key)
        elif not np.array_equal(x, y):
            differ.append(key)
    for key in ("pools", "penalty"):
        if not all(torch.equal(u, v) for u, v in zip(a[key], b[key])):
            differ.append(key)
    return differ
