#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dynamo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA device and nvcc (CUDA_HOME
or PATH). Phases, each of which raises on failure (exit code != 0):

  1. device: the card's name and power limit as nvidia-smi reports them
  2. build the five kernel sources (one nvcc per source, started together)
  3. K1 paged decode and K3a, its folded variant, against their plain
     PyTorch versions (B 64, ps 16, ragged contexts 1..2048, inactive slots,
     a row at position -1; K1 at Hq 32 / Hkv 8 / D 128, K3a at TinyLlama's
     Hq 32 / Hkv 4 / D 64) in three mixes: f32, bf16, and bf16 queries over
     the int8 cache; K1's bf16-query launches (its split body and merge)
     twice for the same bits; kernel / plain / SDPA times and the bound; the
     SASS of the mma.sync bodies (K1's split body, which K3a shares, K4a /
     K4b's passes, K5's and K6's bf16 bodies) must hold HMMA and no local
     memory (the cuobjdump runs side by side)
  4. K2 chunked-prefill flash and K3b the same way (512-row lanes at cached
     prefixes 0 and 1024, plus a pad lane, in one launch), with achieved
     TFLOP/s and share of the bound; the SASS of their bf16-query instances
     must hold HGMMA (wgmma on the tensor cores)
  5. K5 MLA latent decode against its plain version (B 16, H 16, latent
     576, d_c 512, ps 16, ragged contexts 1..2048, inactive slots, a row at
     position -1), f32 queries over f32 pages (the FMA body) and over bf16
     pages (the tensor-core body), each launched twice for the same bits;
     kernel / plain / SDPA times and the SDPA backends that take the inputs
  6. K6 MLA latent prefill the same way (512-row chunks at cached prefixes 0
     and 1536); K5 and K6 bounded over the function's own operations, 2 H
     (L + d_c) a (row, key) pair, at the pages' rate (bf16 pages: the bf16
     tensor rate)
  7. the decode variants at K1's shapes and again at the profilers' (Hq 16
     / Hkv 8 / D 128, ps 128: the reference bench's 1.3B shape), f32 and
     bf16: K4a (chunked) and K4b (grouped), each launched twice for the same
     bits, and
     K7c without cast_f32 against their plain versions, K7c with cast_f32
     against K1's (in bf16 K7c's toggles must give K4b's and K1's bits on
     the same inputs: each runs on that body); the load-only
     twins K7b (at both) and K7a (at K2's shapes and at profile_prefill's
     512-row chunk after a 2560-row prefix, also over int8) against the
     checksums of their plain versions, exactly (pools of multiples of 1/8,
     whose f32 sums are exact in any order); kernel / plain / SDPA times and
     the bound over the rows each sequence reads; then the widened head
     geometries at small sizes (WIDENED: K1 / K2 at G 7 and 6; D 256, 384,
     512, 640, 768 and 1024 on K1, K2, K4a, K4b, K7a-c; K3a / K3b at D 96
     with G 3, D 80, 8, 192, 100, 20, 264, 320, 520 and 1000; K5 / K6 at 4
     and 20 heads, at L 1088 / d_c 1024 and at L 36 / d_c 30), each held to
     its plain version in every mix it takes; then K1 and K2 at the HTTP
     path's page size 4 and shapes, bf16 (K1 at B 16 over contexts to 2112,
     K2 over four 32-row lanes at prefixes to 2080 and a pad lane), timed
     into the K1 and K2 rows under "ps4"; K7a's rows also carry the bytes
     K2's blocks read (``block_bytes``), beside its bound's once-read rows;
     K8, the weight-only int8 linear (``check_int8_linear``): Llama-3-8B's
     seven projections at T 16, 64, 512 and 2048, DeepSeek-V2-Lite's 2-D
     products at T 16 and 512 and its expert banks at 3 and 96 rows an
     expert, every one on the wgmma body, and a 1000-wide shape on the mma
     body, bf16, against its plain version, timed beside
     ``torch.matmul`` over the dequantized bf16 weight (the library call
     that reads 2 bytes a weight) and its bound, at decode sizes also over
     weights cold in L2; two launches of a split-K shape (T 16 and 512)
     give the same bits, and its f32 activations (mma body) hold the f32
     limit
  8. serve paths (tools/workload.py: 16 concurrent greedy requests of
     64-2048 prompt tokens and 64 output tokens, bf16, seeded random
     weights, full width and depth); every stream must finish with exactly
     64 tokens, the path's kernels must launch and the others' must not.
     Each engine captures its step graphs before the timed serve
     (EngineConfig.warmup=True; http serve: run's warmup="background",
     waited for), every decode window and prefill call of the serve is a
     graph replay (no capture inside it, by the capture monitor), the
     launch counts are the replays' tallies, and each phase logs its
     warmup seconds, captures, replays and graph pool bytes and its step
     anatomy (host fraction, roofline fractions, prefill fixed ms, decode
     dispatch gap) beside the card's name and power limit:
       serve / int8 serve: Llama-3-8B geometry, bf16 / int8 KV cache, K1 K2;
       serve also times a decode step against its weight floor
       (``decode_step``: graph replays of 64- less 8-step windows);
       int8_wo serve: the same with "quantize": "int8_wo" in the tiny JSON,
       K8 K1 K2, its decode step against the 2.40 ms int8 weight floor;
       MLA serve: DeepSeek-V2-Lite geometry (MLA + 64-expert MoE), K5 (its
       tensor-core body, mla_decode_tc, for every call) K6; MLA int8_wo
       serve: the same at full depth with int8_wo weights, K8 in both forms,
       K5 K6;
       folded serve / folded int8 serve: TinyLlama-1.1B geometry (head_dim
       64, prompts clipped to 1984), bf16 / int8 KV cache, K3a K3b;
       chunked serve / grouped serve: Llama-3-8B geometry at 8 of its 32
       layers (a depth cut for the time limit), bf16 KV, with
       DYNTPU_DECODE_KERNEL=chunked / grouped: K4a / K4b decode (as many
       launches as K1 in serve, scaled by the layers) and K2; no K1, K3 or
       other K4 launch;
       http serve: the CLI's parse of `run 'tiny:{Llama-3-8B}' --in http
       --out torch --http-port 0 --max-model-len 2112 ...` (page size 4),
       its HTTP service on a background event loop, the 16 prompts as
       token-id streams to /v1/completions from 16 client threads; every
       stream ends with 64 tokens, "length" and [DONE], K1 and K2 launch and
       no other kernel; /v1/models, /metrics and a unary chat answer; the
       in-process pair runs from a cold prefix cache; then, untimed, a
       completion with logprobs 5, a chat with top_logprobs 3 and a
       completion with repetition_penalty carry their fields, and a prompt
       sent twice reports cached tokens in its second timing event;
       prefix serve: Llama-3-8B geometry, 32 layers, bf16, page size 16,
       4096 pages, 16 slots, warmup True; 16 prompts sharing a 1024-token
       prefix with distinct tails of 64-960 tokens (tools/workload.py
       prefix_serve_*), 64 tokens each, the features mixed by i % 4 (greedy +
       logprobs 5; greedy + repetition 1.3, frequency 0.5, presence 0.5;
       min_tokens 32 + Llama-3's EOS ids; sampled, seeded, penalties and
       logprobs 3), in three timed rounds on one engine: (a) request 0
       alone, (b) requests 1-15 at once, (c) all 16 again; gates: streams
       end as their parameters say, logprobs finite and <= 0 with the
       chosen equal to its alternative, cached_tokens exactly the
       allocation rule's (64 prefix blocks in (b), every full block in (c)),
       prefill rows = prompt tokens less cached, the stored KV events = the
       cached blocks, no capture in a round, K1 and K2 launch and no other
       kernel; prints each round's TTFT p50 and tok/s, the host time to hash
       one 2048-token prompt at page sizes 4, 16 and 128, the warmup's
       captures, seconds and pool, the share of round (c) streams whose
       tokens equal round (b)'s, and the engine's ForwardPassMetrics
     checkpoint serve: the port's tool writes a TinyLlama-1.1B-geometry
       directory and a 2-layer V2-Lite-width one in DeepSeek's names
       (seeded bf16 weights drawn on the card, the port's safetensors
       writer); each loads through load_model(dir) in bf16 and int8_wo
       (seconds and GB/s) with prefill logits bit-equal to a model built
       from the same tensors here (``hf_state``); then `run <TinyLlama dir>
       --in http --out torch` and the same with --quantize int8_wo serve the
       folded prompts over HTTP: K3a K3b (and K8) launch, nothing else
     spec serve (``phase_spec_serve``): speculative decoding, k = 4. First
       K2 and K5 at the verify pass's shapes, bf16 (``check_verify_shapes``:
       K2 over 15 lanes of 5 rows at the workload's anchors and a pad lane;
       K5 over 16 lanes x 5 rows, each row with its lane's table), held to
       their plain versions and timed beside them and SDPA. (a) n-gram on
       the serve engine (Llama-3-8B, 32 layers, bf16), the workload twice,
       the second timed: acceptance, verify rounds, tok/s and TTFT beside
       serve's, the share of streams equal to serve's (bf16: the verify pass
       and the decode step round differently, so a stream may take the other
       side of a near-tie), only K2 launches, with the K2 launches the verify
       graphs replayed; (c) a TinyLlama-1.1B-geometry draft with Llama-3's
       vocabulary for the same target (K3a / K3b in the draft): every stream
       equals (a)'s; at Llama-3-8B width, 4 layers, f32: (a') n-gram, (b) the
       target as its own draft (greedy acceptance exactly 1.0) and (c') a
       4-layer f32 TinyLlama draft, every stream equal to the same engine's
       without speculation; (e) seeded sampled requests (temperature 0.8) on
       (a')'s and (b)'s engines reproduced token for token beside other
       batch mates; (d) DeepSeek-V2-Lite width, 4 layers, f32, capacity
       factor 11, n-gram: streams equal the engine's without speculation, K5
       launched once a layer a verify round, K6 in prefill, nothing else
     preempt serve (``phase_preempt_serve``): page pressure, QoS and the
       chunk planner, every engine warmed up first and no capture after.
       (a) the serve workload on Llama-3-8B geometry, 32 layers, bf16, on
       1100 pages, watermark 0 (the prompts fit, their outputs do not):
       every stream ends "length" with 64 tokens, at least one preemption;
       prints preemptions, pressure drains, re-admissions' cached tokens,
       tok/s and TTFT beside serve's, K1 / K2 launches; (b) Llama-3-8B
       width, 4 layers, f32, the same pool against 4096 pages: every greedy
       stream equal; (c) 4 slots, the 16 prompts as batch class, two
       critical requests once the slots are busy, QoS on then off: a shed,
       no critical victim, critical TTFT p50 below the FIFO run's; (d)
       n-gram (k = 4) on (b)'s tight pool: streams equal (b)'s; (e) a
       16384-token prompt beside the four shortest prompts decoding
       (max_model_len 16448) at the default prefill_flat_depth and at 2048:
       each prefill call's rows as chunk_len_for plans them, each call's
       device ms against its depth
     disagg serve (``phase_disagg_serve``): disaggregated prefill and
       decode, a DisaggDecodeEngine and a PrefillWorker over the port's
       broker (localhost), runtime and KV data plane, every prompt above
       256 tokens prefilled remotely; every stream ends with 64 tokens, the
       remote prefills are exactly the prompts above the threshold, no page
       stays held on either engine. (a) two Llama-3-8B engines, 32 layers,
       bf16, in this process, the KV handed over as device blocks (ici): K2
       on the prefill engine, K1 on the decode engine (each engine's replay
       tallies), remote_prefill_wait_s and TTFT p50, tok/s beside serve's;
       (b) Llama-3-8B width, 4 layers, f32, over the data plane (the ici
       hub bypassed), streamed and monolithic: every stream equals the
       aggregated engine's; the same at bf16 on the int8 KV cache; parts,
       bytes, send against overlap seconds, the checksums' GB/s; (c) the
       prefill worker as `python -m dynamo_tpu_torch.components.prefill_worker`
       in a second process on the card: every stream equal, exit 0 on
       SIGTERM; (d) DeepSeek-V2-Lite width, 4 layers, f32, over ici: every
       stream equal, K6 on the prefill engine, K5 on the decode engine
     routed serve (``phase_routed_serve``): KV-aware routing across worker
       replicas, after disagg serve: the port's broker, two WorkerServices
       (Llama-3-8B geometry, 32 layers, bf16, page size 16, 4096 pages each,
       one prefill lane, graphs captured first), a kv and a random
       ProcessorService and a FrontendService, in this process. (a) bench.py run_routing_parity's
       traffic (4 sessions x 3 turns of 3072+ tokens, 8 greedy tokens)
       through each processor on its own seeded prompts: every stream ends
       with 8 tokens; under kv every later turn lands on the worker of the
       session's previous turn with expected_cached's cached tokens; the
       kv router takes the native radix tree, whose scores on the recorded
       KV events equal the Python tree's; recomputed prefill tokens, client
       TTFT p50, tok/s and each worker's K1 / K2 tallies per arm; (b)
       bench.py run_fleet_prefix: 3 sessions (1536 shared + 127 tail
       tokens) warm worker A, then go to worker B with the holder the kv
       router names: B pulls exactly those blocks, recomputes only past
       them, no fallback; pull TTFT against a cold recompute, bytes and
       GB/s; again at 2 layers in f32, every stream of B equal A's; K1 and
       K2 launch on both workers over (a) and (b), nothing else; (c) B's
       runtime stops: the kv router drops B within its aggregator's
       interval, 8 completions over the frontend's HTTP all land on A and
       none fails, /ready reports one live instance, then 503 once A stops,
       /live 200; (d) `run '<2-layer f32>' --in dyn://routed.backend.generate
       --out torch` as a second process: this process's frontend discovers
       it, `run --in batch:<file> --out dyn://...` writes what an in-process
       engine writes, greedy completions over HTTP equal the in-process
       engine's, exit 0 on SIGINT
     tiers serve (``phase_tiers_serve``) and migrate serve
       (``phase_migrate_serve``): the KV tier ladder and live migration on
       Llama-3-8B geometry, 32 layers, bf16, page size 16, one model shared
       by the engines (graphs captured first). (a) a 1100-page engine over a
       1024-block pinned host tier: four 3072-token sessions, fillers that
       push their blocks to the host tier, each session again: every resume
       takes >= 191 blocks from the host tier, restored pages equal the saved
       ones bit for bit, tokens equal a device hit's; the no-tier arm (the
       tier detached) recomputes; TTFTs, saves / loads / transfer_s, the
       copies' device GB/s, the pinned bytes; the 0.90 watermark drains and
       nothing is preempted; (b) the int8 cache over a 64-block host tier and
       a 2 GiB disk tier: three parked sessions restore from disk with the
       no-tier arm's tokens, one corrupt .kvb file stops its restore and the
       tail recomputes with the same tokens, the disk within its budget;
       (c) 8 streams (1024-2048 tokens, 64 out) migrated after 16 tokens to
       a second engine over the seq_handoff pull: all end at full length, 8
       pulled, pause p50 / p99, streams equal to the uninterrupted baseline
       counted (bf16); the ladder at 2 layers f32 (a dropped part and a
       corrupt checksum recompute, a destination stopped after relaying
       makes the source resume), each with the uninterrupted tokens; (d) the
       two engines behind WorkerServices on one broker: POST /admin/drain
       while 4 streams decode: all end at full length, migrated > 0, the
       drained worker leaves the kv router's index
     lora serve (``phase_lora_serve``): multi-LoRA, adapters at rank 8 over
       4 device slots, no new kernel (the delta is two torch matmuls a
       module group over the slot-concatenated pool). (a) Llama-3-8B width,
       2 layers, f32: 8 greedy streams of 32 tokens over four adapters and
       the base in one batch equal each alone, their merged weights (W + s A
       B) and, for the base, a LoRA-less engine, exactly; (b) 32 layers,
       bf16, six adapters: 16 streams of 64 tokens end at 64, adapter
       streams differ from the base model's, >= 2 evictions and 6 host
       loads, the streams equal to their alone runs counted, one prompt
       under two adapters: 0 cached tokens first, a hit on each repeat; (c)
       int8_wo weights (K8) at 2 layers f32: mixed equals alone; (e) the
       HTTP service on (b)'s engine: /v1/models lists the adapters, a
       <model>:l1 stream's engine-side tokens equal the in-process run, an
       unknown adapter is a 404 before any SSE byte; (d) a decode step's
       and a 512-row prefill call's device ms with and without adapters,
       in turns, graph pool bytes beside the adapter pool's, a slot load's
       host ms and stream span; K1 / K2 / K8 replay tallies of the LoRA
       engines
  9. refusals: an int8 cache on tiny-mla and on K4a, K3b over float16 and
     K4b at a folded head dim raise on the card; K1 at head_dim 640 and K3a
     at 520, which the launchers refused before, launch and hold their plain
     versions
 10. 2-layer f32 greedy parity: the engine's tokens must equal a dense
     no-paging forward's on Llama-3-8B geometry, on TinyLlama geometry with
     an f32 and with an int8 KV cache (the dense forward quantizes and
     dequantizes each K/V row), and on V2-Lite geometry (capacity factor 11,
     nothing drops) against a dense non-absorbed forward; graph against
     eager: Llama-3-8B and DeepSeek-V2-Lite at full width, 2 layers, bf16,
     one prefill and one 8-step decode window replayed from the runner's
     graphs and run through its eager bodies from the same state, equal
     greedy tokens and bit-equal written KV pages, last-step logits within
     TOL["bf16"]; on Llama-3-8B geometry with DYNTPU_DECODE_KERNEL=chunked
     and =grouped (the rounding is the identity at f32); then the CLI as a
     subprocess (`python -m
     dynamo_tpu_torch.launch.run run 'tiny:{...}' --in http --out torch` on
     a 2-layer f32 Llama-3-8B-width model with the byte vocabulary, 256):
     three greedy completions' text equals naive_greedy's bytes, and SIGINT
     ends it with exit code 0. The graph-against-eager check also runs a
     prefill with penalties, min_tokens and logprobs, an extras window and a
     logprobs window (tokens, logprobs and penalty state equal). Features
     against the dense forward (2 layers, f32): three prompts sharing a
     160-token prefix, the first alone, then the other two, then all three,
     cached_tokens as the allocation rule gives and greedy tokens equal, on
     Llama-3-8B geometry, on TinyLlama geometry with the int8 cache and on
     V2-Lite geometry (non-absorbed forward); on Llama-3-8B geometry,
     repetition / frequency / presence penalties (the formula written out
     in naive_featured), min_tokens past an EOS id the plain stream emits
     second, and logprobs 20 within 1e-4 of the log-softmax; int8_wo (K8's
     f32 activations): Llama-3-8B and V2-Lite geometry at 2 layers, greedy
     tokens equal the dense forwards over the dequantized weights
 11. instruments: tools/profile_attn.py (K1, K7b, K7c, K4a, K4b at the
     reference bench's headline geometry, gated against perseq and each
     held to its plain version on the profiler's own inputs, K7b exactly
     over exact pools) and tools/profile_prefill.py (the 1.3B bench engine's
     prefill split, K2 held to its plain version and K7a to its checksum,
     then timed against each other); every variant must pass

Kernel and SDPA times are device times (``ms``, ``library_ms``: the
host's enqueueing hidden behind a sleep kernel), each beside its back-to-back
time (``b2b_ms``, ``library_b2b_ms``: the host's enqueueing counts where it
is the longer) and the host's time to enqueue one call (``host_ms``,
``library_host_ms``); the plain versions' are back-to-back times
(``cuda_ms``). Then a {"kernels": [...]}
summary line, and as the last line {"ok": true, "device": {...}}. The
script imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}



def log(msg: str) -> None:
    print(msg, flush=True)


def lap(what: str, since: float) -> float:
    """Log the seconds ``what`` took since ``since``; returns now."""
    now = time.monotonic()
    log(f"time: {what} {now - since:.1f} s")
    return now


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls (CUDA events,
    after warm-up), the host's enqueueing included where it is the longer:
    the plain versions' timer, since some of their ops wait for the device
    (a CPU scalar copied to the card), which a sleep kernel cannot hide."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters: int, key: str = "") -> dict:
    """Times of ``fn`` over ``iters`` calls, after as many warm-up calls
    (``tools/timing.py launch_times``), in ms under ``key`` + "ms" (device
    time: the host's enqueueing hidden behind a sleep kernel, so a launcher's
    Python time does not count as its kernel's), + "b2b_ms" (back to back
    with nothing in front: the host's enqueueing counts where it is the
    longer) and + "host_ms" (the host's enqueueing of one call)."""
    from dynamo_tpu_torch.tools.timing import launch_times

    dev_us, b2b_us, host_us = launch_times(lambda i: fn(), iters)
    return {f"{key}ms": dev_us / 1e3, f"{key}b2b_ms": b2b_us / 1e3, f"{key}host_ms": host_us / 1e3}


def held_to_plain(what: str, dtype: str, got, ref, tol: str | None = None, slack=None) -> dict:
    """Raise unless ``got`` is finite and within the elementwise limit
    ``TOL[tol or dtype]`` of ``ref`` (``tools/checks.py``, which says why),
    plus ``slack`` (elementwise, ``tools/checks.py rounding_slack``) where
    given; returns {max_abs_err, tol_share}: the max abs error and the
    largest share of the limit used."""
    from dynamo_tpu_torch.tools.checks import TOL, tol_share

    atol, rtol = TOL[tol or dtype]
    err, share = tol_share(got, ref, tol or dtype)
    if slack is not None and share != float("inf"):
        diff = (got.float() - ref.float()).abs()
        share = (diff / (atol + rtol * ref.float().abs() + slack)).max().item()
    log(f"{what} {dtype}: max_abs_err {err:.3e}; max |got-ref| / (atol + rtol*|ref|) = "
        f"{share:.3f} (must be <= 1; atol {atol:g}, rtol {rtol:g})")
    if not share <= 1.0:
        raise AssertionError(f"{what} {dtype}: error {share:.3f}x its tolerance (inf: non-finite output)")
    return dict(max_abs_err=err, tol_share=share)


def held_exactly(what: str, dtype: str, got, ref) -> dict:
    """Raise unless ``got`` equals ``ref`` (the K7 checksums over exact
    data); the same keys as held_to_plain, the limit 0."""
    import torch

    if got.dtype != torch.float32 or not torch.isfinite(got).all():
        raise AssertionError(f"{what} {dtype}: want finite float32 checksums, got {got.dtype}")
    err = (got - ref).abs().max().item()
    log(f"{what} {dtype}: max_abs_err {err:.3e} (exact sums: must be 0)")
    if err != 0.0:
        raise AssertionError(f"{what} {dtype}: checksum differs from its plain version by {err}")
    return dict(max_abs_err=err, tol_share=0.0)


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_backends(fn) -> list[str]:
    """The SDPA backends that accept the call ``fn`` makes (PyTorch's
    default call takes the first of them in its priority order)."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    took = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                fn()
            torch.cuda.synchronize()
            took.append(backend.name)
        except RuntimeError:
            continue
    return took


# ---------------------------------------------------------------- K1 / K3a, K2 / K3b

# (Hq, Hkv, D) of each paged kernel's check: K1/K2 at Llama-3-8B's attention
# geometry, K3a/K3b at TinyLlama-1.1B's (head_dim 64, the folded kernels)
GEOMETRY = {"K1": (32, 8, 128), "K2": (32, 8, 128), "K3a": (32, 4, 64), "K3b": (32, 4, 64)}
# (name, query dtype, pool kind): plain pools of the query's dtype, and bf16
# queries over the int8 cache. The int8 mix is held to the bf16 limit (bf16
# output; both sides read the same codes and scales) and bounded at the bf16
# peak (its products take bf16 queries).
MIXES = (("f32", "float32", "plain"), ("bf16", "bfloat16", "plain"), ("int8", "bfloat16", "int8"))


def mix_pools(torch, k32, v32, qdt, kind):
    """(k, v, k_dense, v_dense, bytes a K/V element, bytes a row of scales):
    the pools a mix runs on, and plain pools of the same values for the SDPA
    yardstick (int8: dequantized to bf16, outside any timing)."""
    from dynamo_tpu_torch.quant.kv import QuantizedPages, dequantize_rows, quantize_kv_rows

    if kind == "plain":
        k, v = k32.to(qdt), v32.to(qdt)
        return k, v, k, v, k.element_size(), 0
    pools = []
    for x in (k32, v32):
        P, ps = x.shape[:2]
        q, s = quantize_kv_rows(x.reshape(P * ps, *x.shape[2:]))
        pools.append(QuantizedPages(q.reshape(x.shape), s.reshape(P, ps)))
    k, v = pools
    dense = [dequantize_rows(p.q, p.s, torch.bfloat16) for p in pools]
    return k, v, dense[0], dense[1], 1, 4


def decode_case(torch, dev, rng, Hq: int, Hkv: int, D: int, ps: int = 16, B: int = 64, rows: int = 2048) -> dict:
    """K1's check inputs: B 64, page size ``ps``, ragged contexts 1..2048 in
    distinct pages, 6 inactive slots (trash tables, position 0) and a row at
    position -1; f32 pools, queries, the SDPA mask, and the rows each
    sequence reads (``live_len``). ``B`` (at least 9) and ``rows`` make it
    smaller."""
    max_pages = rows // ps
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:2] = (1, max_pages * ps)
    inactive = np.zeros(B, bool)
    picked = rng.choice(np.arange(2, B), 7, replace=False)
    inactive[picked[:6]] = True
    negative = int(picked[6])  # a row at position -1: attends index 0 only
    pages_needed = [-(-int(n) // ps) for n in lengths]
    P = 1 + sum(pages_needed)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((B, max_pages), np.int32)
    off = 0
    for b in range(B):
        pt[b, : pages_needed[b]] = perm[off : off + pages_needed[b]]
        off += pages_needed[b]
    pos = (lengths - 1).astype(np.int32)
    pt[inactive] = 0  # inactive slots: trash-page tables, position 0
    pos[inactive] = 0
    pos[negative] = -1
    live_len = np.where(inactive, 1, lengths)
    live_len[negative] = 1
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    S = max_pages * ps
    return dict(
        B=B, P=P, ps=ps, pt=pt, pos=pos, pt_t=pt_t, pos_t=pos_t, live_len=live_len,
        k32=torch.randn((P, ps, Hkv, D), device=dev), v32=torch.randn((P, ps, Hkv, D), device=dev),
        q32=torch.randn((B, Hq, D), device=dev),
        mask=(torch.arange(S, device=dev)[None, :] <= pos_t[:, None].long().clamp(min=0))[:, None, None, :],
    )


def sdpa_decode_times(torch, plain, case, q, kd, vd) -> dict:
    """Yardstick only: one SDPA call over the gathered, masked context
    (``timed``'s library_ times)."""
    kc = plain.gather_pages(kd, case["pt_t"]).permute(0, 2, 1, 3).contiguous()  # [B, Hkv, S, D]
    vc = plain.gather_pages(vd, case["pt_t"]).permute(0, 2, 1, 3).contiguous()
    qs = q.to(kc.dtype)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return timed(lambda: sdpa(qs, kc, vc, attn_mask=case["mask"], enable_gqa=True), 20, "library_")


def decode_bound(case, q, Hkv: int, kv_bytes: int, scale_bytes: int, tol: str) -> tuple[float, str, float]:
    """K1's bound: each sequence's live rows of K and V (and int8 scales)
    read once, q read and the output written once; 4 FLOP a (head, row,
    column). Returns (ms, what bounds it, bytes)."""
    Hq, D = q.shape[1], q.shape[2]
    live = int(case["live_len"].sum())
    nbytes = (live * (Hkv * D * kv_bytes + scale_bytes) * 2 + 2 * q.numel() * q.element_size()
              + case["pt"].nbytes + case["pos"].nbytes)
    b_ms, b_by = bound(nbytes, 4 * Hq * D * live, tol)
    return b_ms, b_by, nbytes


def check_decode(torch, dev, rng, which: str, ps: int = 16, B: int = 64, rows: int = 2048, mixes=MIXES) -> dict:
    """K1 or K3a against the plain version at B 64, ps 16, ragged contexts
    1..2048, inactive slots and a row at position -1, in every mix (or at
    page size ``ps``, ``B`` slots, contexts up to ``rows``, in ``mixes``)."""
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import paged_attention as pa

    kernel = {"K1": pa.paged_decode_attention_kernel, "K3a": pa.paged_decode_attention_folded_kernel}[which]
    Hq, Hkv, D = GEOMETRY[which]
    case = decode_case(torch, dev, rng, Hq, Hkv, D, ps, B, rows)
    pt_t, pos_t = case["pt_t"], case["pos_t"]
    k32, v32, q32 = case["k32"], case["v32"], case["q32"]
    at = f" (ps {ps}, B {B}, contexts to {rows})" if (ps, B, rows) != (16, 64, 2048) else ""
    res = {}
    for name, qdt_name, kind in mixes:
        qdt = getattr(torch, qdt_name)
        q = q32.to(qdt)
        k, v, kd, vd, kv_bytes, scale_bytes = mix_pools(torch, k32, v32, qdt, kind)
        got = kernel(q, k, v, pt_t, pos_t)
        ref = plain.paged_decode_attention(q, k, v, pt_t, pos_t)
        tol = "f32" if qdt == torch.float32 else "bf16"
        held = held_to_plain(f"{which} paged decode{at}", name, got, ref, tol)
        if which == "K1" and qdt == torch.bfloat16 and not torch.equal(got, kernel(q, k, v, pt_t, pos_t)):
            raise AssertionError(f"K1 paged decode {name}: two launches on the same inputs differ")
        kt = timed(lambda: kernel(q, k, v, pt_t, pos_t), 50)
        plain_ms = cuda_ms(lambda: plain.paged_decode_attention(q, k, v, pt_t, pos_t), 5)
        lt = sdpa_decode_times(torch, plain, case, q, kd, vd)
        ms, lib_ms = kt["ms"], lt["library_ms"]
        b_ms, b_by, nbytes = decode_bound(case, q, Hkv, kv_bytes, scale_bytes, tol)
        note = " (SDPA over the dequantized bf16 context, dequantization untimed)" if kind == "int8" else ""
        log(f"{which} paged decode{at} {name}: kernel {ms:.4f} ms (back to back {kt['b2b_ms']:.4f}, host "
            f"{kt['host_ms']:.4f}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (back to back "
            f"{lt['library_b2b_ms']:.4f}){note}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB)")
        res[name] = dict(**held, **kt, plain_ms=plain_ms, **lt, bound_ms=b_ms, bound_by=b_by)
    return res


def check_prefill(torch, dev, rng, which: str, ps: int = 16, T: int = 512, starts=(0, 1024), max_pages: int = 128,
                  mixes=MIXES) -> dict:
    """K2 or K3b against the plain version: three 512-row lanes in one launch
    (cached prefixes 0 and 1024, and a pad lane: n=0, all-zero table), in
    every mix (or ``T``-row lanes at cached prefixes ``starts`` and a pad
    lane, at page size ``ps`` and table width ``max_pages``, in ``mixes``)."""
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pf

    kernel = {"K2": pf.paged_prefill_attention_kernel, "K3b": pf.paged_prefill_attention_folded_kernel}[which]
    Hq, Hkv, D = GEOMETRY[which]
    starts = [*starts, 0]  # the last lane is a pad lane: n=0, all-zero table
    L = len(starts)
    need = [-(-(s + T) // ps) for s in starts[:-1]]
    P = 1 + sum(need)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((L, max_pages), np.int32)
    for j, off in enumerate(np.cumsum([0, *need[:-1]])):
        pt[j, : need[j]] = perm[off : off + need[j]]
    pos = np.stack([s + np.arange(T) for s in starts]).astype(np.int32)
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    k32 = torch.randn((P, ps, Hkv, D), device=dev)
    v32 = torch.randn((P, ps, Hkv, D), device=dev)
    q32 = torch.randn((L * T, Hq, D), device=dev)
    at = f" ({L - 1} lanes of {T} rows, ps {ps}, prefixes {starts[:-1]})" if ps != 16 else ""
    S = max_pages * ps
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(S, device=dev)[None, None, :] <= pos_t[:, :, None].long())[:, None]
    # the bound counts the useful work, the real lanes; the pad lane's
    # output is discarded (its causal pairs are reported apart)
    real = pos[:-1]
    ctx_tokens = sum(int(p[-1]) + 1 for p in real)
    pairs = sum(int((p + 1).sum()) for p in real)
    pad_pairs = int((pos[-1] + 1).sum())
    res = {}
    for name, qdt_name, kind in mixes:
        qdt = getattr(torch, qdt_name)
        q = q32.to(qdt)
        k, v, kd, vd, kv_bytes, scale_bytes = mix_pools(torch, k32, v32, qdt, kind)
        got = kernel(q, k, v, pt_t, pos_t)
        ref = plain.paged_prefill_attention_lanes(q, k, v, pt_t, pos_t)
        tol = "f32" if qdt == torch.float32 else "bf16"
        held = held_to_plain(f"{which} prefill flash{at}", name, got, ref, tol)
        kt = timed(lambda: kernel(q, k, v, pt_t, pos_t), 20)
        ms = kt["ms"]
        plain_ms = cuda_ms(lambda: plain.paged_prefill_attention_lanes(q, k, v, pt_t, pos_t), 3)
        kc = plain.gather_pages(kd, pt_t).permute(0, 2, 1, 3).contiguous()  # [L, Hkv, S, D]
        vc = plain.gather_pages(vd, pt_t).permute(0, 2, 1, 3).contiguous()
        qs = q.to(kc.dtype).reshape(L, T, Hq, D).permute(0, 2, 1, 3)
        lt = timed(lambda: sdpa(qs, kc, vc, attn_mask=mask, enable_gqa=True), 10, "library_")
        lib_ms = lt["library_ms"]
        itemsize = q.element_size()
        nbytes = (ctx_tokens * (Hkv * D * kv_bytes + scale_bytes) * 2 + 2 * real.size * Hq * D * itemsize
                  + pt.nbytes + pos.nbytes)
        flops = 4 * Hq * D * pairs
        b_ms, b_by = bound(nbytes, flops, tol)
        note = " (SDPA over the dequantized bf16 context, dequantization untimed)" if kind == "int8" else ""
        log(f"{which} prefill flash{at} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms{note}, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP in the "
            f"real lanes, pad lane {4 * Hq * D * pad_pairs / 1e9:.2f} GFLOP more); achieved "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the bound")
        res[name] = dict(**held, **kt, plain_ms=plain_ms, **lt, bound_ms=b_ms, bound_by=b_by)
    return res


def sass_count(lib, pattern: str) -> dict:
    """{kernel function: instructions matching the regex ``pattern``} in
    ``cuobjdump -sass`` of a built library (HGMMA: wgmma on the tensor
    cores; HMMA: mma.sync; LDL / STL: local memory, i.e. spills)."""
    import re
    import subprocess

    from dynamo_tpu_torch.ops.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(pattern, line):
            counts[fn] += 1
    return counts


def sass_counts(jobs) -> list[dict]:
    """``sass_count`` of each (library, pattern) of ``jobs``, the cuobjdump
    processes run side by side."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda job: sass_count(*job), jobs))


def check_sass() -> dict:
    """The tensor-core bodies' SASS: K2 / K3b's bf16-query instances
    (tc_prefill_kernel, bf16 and int8 pools, DP 16..128 and 256) hold HGMMA
    (wgmma), the f32 FMA bodies none; K1's split body, which K3a shares
    (paged_decode_tc<bf16 | int8, D 16, 32, ..., 128, 256, 384, 512>),
    K4a's and K4b's (grouped_scores and grouped_pv at D 64, 128, 256, 384,
    512) and K5's and K6's bf16 bodies (mla_decode_tc, mla_prefill_tc) hold
    HMMA (mma.sync) and no local memory (LDL / STL: no spills). Returns
    {instance: count}."""
    from dynamo_tpu_torch.ops.kernels import _build

    mma = (("paged_attention", "paged_decode_tc", 22), ("decode_variants", "grouped_", 10),
           ("mla_attention", "mla_prefill_tc", 1), ("mla_attention", "mla_decode_tc", 1))
    libs = list(dict.fromkeys(lib for lib, _, _ in mma))  # each library disassembled once a pattern
    jobs = [(_build.library_path("prefill_attention"), r"\bHGMMA\b")]
    for lib in libs:
        jobs += [(_build.library_path(lib), r"\bHMMA\b"), (_build.library_path(lib), r"\b(LDL|STL)\b")]
    counts = sass_counts(jobs)
    tc = {fn: n for fn, n in counts[0].items() if "tc_prefill_kernel" in fn}
    fma = {fn: n for fn, n in counts[0].items() if "fma_prefill_kernel" in fn}
    log("prefill SASS: HGMMA in " + ", ".join(f"{fn} {n}" for fn, n in sorted(tc.items()))
        + f"; FMA body instances {sorted(fma.values())}")
    # tc_prefill_kernel<bf16 | int8, DP 16, 32, ..., 128, 256>: K2 and K3b share 64, 128 and 256
    if len(tc) != 18 or min(tc.values()) <= 0 or any(fma.values()):
        raise AssertionError(f"prefill SASS: tensor-core instances {tc}, FMA instances {fma}")
    found = dict(tc)
    for lib, mark, want in mma:
        i = libs.index(lib)
        hmma = {fn: n for fn, n in counts[1 + 2 * i].items() if mark in fn}
        local = {fn: n for fn, n in counts[2 + 2 * i].items() if mark in fn and n}
        log(f"{lib} SASS: HMMA in " + ", ".join(f"{fn} {n}" for fn, n in sorted(hmma.items()))
            + f"; local-memory instructions {local or 'none'}")
        if len(hmma) != want or min(hmma.values()) <= 0 or local:
            raise AssertionError(f"{lib} SASS: {mark} instances {hmma}, local memory {local}")
        found |= hmma
    return found


# ---------------------------------------------------------------- K4a, K4b, K7a-c

# (Hq, Hkv, D, page size) of the decode variants' checks: K1's (the chunked /
# grouped serve paths run Llama-3-8B at page size 16) and the profilers'
# (tools/profile_attn.py: the reference bench's 1.3B shape, G 2, page size
# 128), where K7b and K7c run on their main path
VARIANT_GEOMETRY = {"K1": (32, 8, 128, 16), "bench": (16, 8, 128, 128)}
# (Hq, Hkv, D, page size, lane starts, table width) of K7a's checks: K2's
# three 512-row lanes (cached prefixes 0 and 1024, and a pad lane: n=0,
# all-zero table) and tools/profile_prefill.py's (the last 512-row chunk of a
# 3072-row prompt, 24 pages of 128, beside a first chunk and a pad lane)
TWIN_GEOMETRY = {"K2": (32, 8, 128, 16, (0, 1024, 0), 128), "bench": (16, 8, 128, 128, (0, 2560, 0), 24)}


def check_decode_variants(torch, dev, rng, geometry: str) -> dict:
    """K4a, K4b and K7c at K1's check inputs (B 64, ragged contexts 1..2048,
    inactive slots, a row at -1) at ``VARIANT_GEOMETRY[geometry]``, in f32
    and bf16 (K7c without cast_f32 against its plain version, with it
    against K1's), with K1's bound and SDPA yardstick; K7b's checksum on the
    same tables over exact pools, exactly. Returns {kernel: {mix: numbers}},
    K7c's cast_f32 runs under "K7c cast_f32"."""
    import functools

    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import paged_attention as pa
    from dynamo_tpu_torch.tools.checks import exact_pools

    Hq, Hkv, D, ps = VARIANT_GEOMETRY[geometry]
    case = decode_case(torch, dev, rng, Hq, Hkv, D, ps)
    pt_t, pos_t = case["pt_t"], case["pos_t"]
    at = f"(G {Hq // Hkv}, ps {ps})"
    kernels = {
        "K4a": (pa.paged_decode_attention_chunked_kernel, plain.paged_decode_attention_chunked),
        "K4b": (pa.paged_decode_attention_grouped_kernel, plain.paged_decode_attention_grouped),
        "K7c": (functools.partial(pa.paged_decode_perseq_variant_kernel, cast_f32=False),
                plain.paged_decode_attention_grouped),
        "K7c cast_f32": (functools.partial(pa.paged_decode_perseq_variant_kernel, cast_f32=True),
                         plain.paged_decode_attention),
    }
    res = {name: {} for name in (*kernels, "K7b")}
    for name, qdt_name, _ in MIXES[:2]:
        qdt = getattr(torch, qdt_name)
        q, k, v = case["q32"].to(qdt), case["k32"].to(qdt), case["v32"].to(qdt)
        lt = sdpa_decode_times(torch, plain, case, q, k, v)
        lib_ms = lt["library_ms"]
        b_ms, b_by, nbytes = decode_bound(case, q, Hkv, k.element_size(), 0, name)
        same_as = {"K7c": pa.paged_decode_attention_grouped_kernel, "K7c cast_f32": pa.paged_decode_attention_kernel}
        for which, (kernel, ref_fn) in kernels.items():
            got = kernel(q, k, v, pt_t, pos_t)
            held = held_to_plain(f"{which} {at}", name, got, ref_fn(q, k, v, pt_t, pos_t), name)
            if which in ("K4a", "K4b") and not torch.equal(got, kernel(q, k, v, pt_t, pos_t)):
                raise AssertionError(f"{which} {at} {name}: two launches on the same inputs differ")
            # each bf16 toggle of K7c runs on the body that computes its function
            body = same_as.get(which) if qdt == torch.bfloat16 else None
            if body is not None and not torch.equal(got, body(q, k, v, pt_t, pos_t)):
                raise AssertionError(f"{which} {at} {name}: not the bits of {body.__name__}")
            kt = timed(lambda: kernel(q, k, v, pt_t, pos_t), 50)
            plain_ms = cuda_ms(lambda: ref_fn(q, k, v, pt_t, pos_t), 3)
            log(f"{which} decode {at} {name}: kernel {kt['ms']:.4f} ms (back to back {kt['b2b_ms']:.4f}, host "
                f"{kt['host_ms']:.4f}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (back to back "
                f"{lt['library_b2b_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB)")
            res[which][name] = dict(**held, **kt, plain_ms=plain_ms, **lt, bound_ms=b_ms, bound_by=b_by)
        # K7b over exact pools of the same shape and tables
        ke, ve = exact_pools(tuple(case["k32"].shape), qdt_name, dev)
        twin = pa.paged_decode_dmaonly_kernel
        held = held_exactly(f"K7b decode twin {at}", name, twin(q, ke, ve, pt_t, pos_t),
                            plain.paged_decode_dmaonly(q, ke, ve, pt_t, pos_t))
        kt = timed(lambda: twin(q, ke, ve, pt_t, pos_t), 50)
        ms = kt["ms"]
        plain_ms = cuda_ms(lambda: plain.paged_decode_dmaonly(q, ke, ve, pt_t, pos_t), 5)
        live = int(case["live_len"].sum())
        tw_bytes = live * Hkv * D * ke.element_size() * 2 + q.numel() * 4 + case["pt"].nbytes + case["pos"].nbytes
        tb_ms, tb_by = bound(tw_bytes, 2 * Hkv * D * live, "f32")  # K + V, then the running sum
        log(f"K7b decode twin {at} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {tb_ms:.4f} ms "
            f"({tb_by}; {tw_bytes / 1e6:.1f} MB); K1's load stream without its math")
        res["K7b"][name] = dict(**held, **kt, plain_ms=plain_ms, library_ms=None, bound_ms=tb_ms, bound_by=tb_by)
    return res


def check_prefill_twin(torch, dev, rng, geometry: str) -> dict:
    """K7a at ``TWIN_GEOMETRY[geometry]`` (three 512-row lanes in one
    launch, the last a pad lane) in every mix, over exact pools, against its
    plain version's checksums exactly. Its bound counts each context row
    once; beside it stand the bytes K2's blocks read (``block_bytes``: each
    query block re-reads its context, mostly from L2) and their time at the
    HBM rate (``block_bytes_ms``)."""
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pf
    from dynamo_tpu_torch.tools.checks import exact_pools

    twin = pf.paged_prefill_dmaonly_kernel
    Hq, Hkv, D, ps, starts, max_pages = TWIN_GEOMETRY[geometry]
    T = 512
    need = [(s + T) // ps if j < 2 else 0 for j, s in enumerate(starts)]  # the pad lane reads no page
    P = 1 + sum(need)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((3, max_pages), np.int32)
    pt[0, : need[0]] = perm[: need[0]]
    pt[1, : need[1]] = perm[need[0] : need[0] + need[1]]
    pos = np.stack([s + np.arange(T) for s in starts]).astype(np.int32)
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    # K2's blocks: BQ = 64 // G query positions, each reading context up to
    # its last row; counted over the two real lanes
    BQ = pf.ROWS_PER_BLOCK // (Hq // Hkv)
    real = pos[:2]
    block_ctx = sum(int(p[b + BQ - 1]) + 1 for p in real for b in range(0, T, BQ))
    ctx_tokens = sum(int(p[-1]) + 1 for p in real)
    at = f"(G {Hq // Hkv}, ps {ps}, prefixes {starts[0]} and {starts[1]})"
    res = {}
    for name, qdt_name, kind in MIXES:
        qdt = getattr(torch, qdt_name)
        q = torch.zeros((3 * T, Hq, D), device=dev, dtype=qdt)
        k, v = exact_pools((P, ps, Hkv, D), qdt_name if kind == "plain" else "int8", dev)
        held = held_exactly(f"K7a prefill twin {at}", name, twin(q, k, v, pt_t, pos_t),
                            plain.paged_prefill_dmaonly(q, k, v, pt_t, pos_t))
        kt = timed(lambda: twin(q, k, v, pt_t, pos_t), 20)
        ms = kt["ms"]
        plain_ms = cuda_ms(lambda: plain.paged_prefill_dmaonly(q, k, v, pt_t, pos_t), 3)
        kv_bytes, scale_bytes = (1, 4) if kind == "int8" else (q.element_size(), 0)
        nbytes = ctx_tokens * (Hkv * D * kv_bytes + scale_bytes) * 2 + real.size * Hq * D * 4 + pt.nbytes + pos.nbytes
        ops = block_ctx * Hkv * D * (4 if kind == "int8" else 2)  # (dequantize,) add, accumulate
        b_ms, b_by = bound(nbytes, ops, "f32")
        block_bytes = block_ctx * (Hkv * D * kv_bytes + scale_bytes) * 2
        block_ms = block_bytes / HBM_BYTES_S * 1e3
        log(f"K7a prefill twin {at} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {nbytes / 1e6:.1f} MB, each context row once); K2's blocks read "
            f"{block_bytes / 1e6:.1f} MB of K/V ({block_ctx / ctx_tokens:.2f}x the rows, mostly "
            f"from L2; {block_ms:.4f} ms at the HBM rate); K2's load stream without its math")
        res[name] = dict(**held, **kt, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                         block_bytes=block_bytes, block_bytes_ms=block_ms)
    return res


# ---------------------------------------------------------------- K5 / K6

# DeepSeek-V2-Lite's attention geometry: 16 heads, latent rows of d_c 512 +
# d_r 64. K5/K6 take f32 queries and return f32 in both page dtypes; both
# sides read the same page values, so both mixes are held to TOL["f32"]. The
# bound counts the function's own operations, 2 H (L + d_c) a (row, key)
# pair, at the rate of the pages' type: bf16 pages at the bf16 tensor rate
# (K6's tensor-core body splits q and P into hi + lo, extra products that are
# the kernel's cost, not the work), f32 pages at the f32 rate.
MLA_H, MLA_LATENT, MLA_DC = 16, 576, 512
MLA_MIXES = (("f32", "float32"), ("bf16", "bfloat16"))


def mla_tables(rng, lengths, ps, max_pages):
    """Distinct pages per sequence (page 0 stays the trash page)."""
    need = [-(-int(n) // ps) for n in lengths]
    P = 1 + sum(need)
    perm = 1 + rng.permutation(P - 1)
    pt = np.zeros((len(lengths), max_pages), np.int32)
    off = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[off : off + n]
        off += n
    return pt, P


def check_mla_decode(torch, dev, rng) -> dict:
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_decode_attention_kernel as k5

    B, H, L, dc, ps, max_pages = 16, MLA_H, MLA_LATENT, MLA_DC, 16, 128
    lengths = rng.integers(1, max_pages * ps + 1, B)
    lengths[:2] = (1, max_pages * ps)
    pt, P = mla_tables(rng, lengths, ps, max_pages)
    pos = (lengths - 1).astype(np.int32)
    picked = rng.choice(np.arange(2, B), 4, replace=False)
    pt[picked[:3]] = 0  # inactive slots: trash-page tables, position 0
    pos[picked[:3]] = 0
    pos[picked[3]] = -1  # attends row 0 only
    live = np.where(pos <= 0, 1, lengths)
    pt_t = torch.from_numpy(pt).to(dev)
    pos_t = torch.from_numpy(pos).to(dev)
    q = torch.randn((B, H, L), device=dev) / L**0.5
    pages32 = torch.randn((P, ps, L), device=dev)
    res = {}
    for name, dt in MLA_MIXES:
        pages = pages32.to(getattr(torch, dt))
        got = k5(q, pages, pt_t, pos_t, dc)
        ref = plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc)
        held = held_to_plain("K5 MLA decode", f"f32 q / {name} pages", got, ref, tol="f32")
        if not torch.equal(got, k5(q, pages, pt_t, pos_t, dc)):
            raise AssertionError(f"K5 MLA decode {name} pages: two launches on the same inputs differ")
        kt = timed(lambda: k5(q, pages, pt_t, pos_t, dc), 50)
        ms = kt["ms"]
        plain_ms = cuda_ms(lambda: plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc), 5)
        # yardstick only: one SDPA call on the gathered latent context (keys
        # the 576-wide rows, values their first 512 columns, one kv head)
        S = max_pages * ps
        ctx = plain.gather_pages(pages, pt_t)[:, None]  # [B, 1, S, L]
        vc = ctx[..., :dc].contiguous()
        qs = q.to(pages.dtype)[:, :, None, :]
        mask = (torch.arange(S, device=dev)[None, :] <= pos_t[:, None].long().clamp(min=0))[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ctx, vc, attn_mask=mask, scale=1.0, enable_gqa=True)

        backends = sdpa_backends(sdpa)
        lt = timed(sdpa, 10, "library_")
        lib_ms = lt["library_ms"]
        nbytes = int(live.sum()) * L * pages.element_size() + q.numel() * 4 + B * H * dc * 4 + pt.nbytes + pos.nbytes
        flops = 2 * H * (L + dc) * int(live.sum())
        b_ms, b_by = bound(nbytes, flops, name)  # bf16 pages: the bf16 tensor rate, f32 pages the f32 rate
        log(f"K5 MLA decode f32 q / {name} pages: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms (backends taking it: {backends}), bound {b_ms:.4f} ms ({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        res[name] = dict(**held, **kt, plain_ms=plain_ms, **lt, bound_ms=b_ms, bound_by=b_by)
    return res


def check_mla_prefill(torch, dev, rng) -> dict:
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_prefill_attention_kernel as k6

    T, H, L, dc, ps, max_pages = 512, MLA_H, MLA_LATENT, MLA_DC, 16, 128
    starts = (0, 1536)  # one sequence's chunks: from 0, and after a 1536-row prefix
    pt_np, P = mla_tables(rng, [max_pages * ps], ps, max_pages)
    pt = torch.from_numpy(pt_np[0]).to(dev)
    pos = [torch.arange(s, s + T, dtype=torch.int32, device=dev) for s in starts]
    qs = [torch.randn((T, H, L), device=dev) / L**0.5 for _ in starts]
    pages32 = torch.randn((P, ps, L), device=dev)
    res = {}
    for name, dt in MLA_MIXES:
        pages = pages32.to(getattr(torch, dt))
        helds = []
        for c, s in enumerate(starts):
            got = k6(qs[c], pages, pt, pos[c], dc)
            ref = plain.paged_mla_prefill_attention(qs[c], pages, pt, pos[c], dc)
            helds.append(held_to_plain(f"K6 MLA prefill (prefix {s})", f"f32 q / {name} pages", got, ref,
                                       tol="f32"))
        kt = timed(lambda: [k6(qs[c], pages, pt, pos[c], dc) for c in range(2)], 20)
        ms = kt["ms"]
        plain_ms = cuda_ms(lambda: [plain.paged_mla_prefill_attention(qs[c], pages, pt, pos[c], dc)
                                    for c in range(2)], 3)
        S = max_pages * ps
        ctx = plain.gather_pages(pages, pt)[None, None]  # [1, 1, S, L]
        vc = ctx[..., :dc].contiguous()
        q4 = [q.to(pages.dtype).permute(1, 0, 2)[None] for q in qs]  # [1, H, T, L]
        masks = [(torch.arange(S, device=dev)[None, :] <= p[:, None].long())[None, None] for p in pos]

        def sdpa():
            return [torch.nn.functional.scaled_dot_product_attention(
                q4[c], ctx, vc, attn_mask=masks[c], scale=1.0, enable_gqa=True) for c in range(2)]

        backends = sdpa_backends(sdpa)
        lt = timed(sdpa, 5, "library_")
        lib_ms = lt["library_ms"]
        rows = sum(s + T for s in starts)  # context rows each chunk reads
        pairs = sum(int((p.long() + 1).sum()) for p in pos)
        nbytes = rows * L * pages.element_size() + 2 * T * H * (L + dc) * 4 + 2 * (pt_np[0].nbytes + T * 4)
        flops = 2 * H * (L + dc) * pairs
        b_ms, b_by = bound(nbytes, flops, name)  # bf16 pages: the bf16 tensor rate, f32 pages the f32 rate
        log(f"K6 MLA prefill f32 q / {name} pages (both chunks): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (backends taking it: {backends}), bound "
            f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP)")
        res[name] = dict(max_abs_err=max(h["max_abs_err"] for h in helds),
                         tol_share=max(h["tol_share"] for h in helds), **kt, plain_ms=plain_ms, **lt,
                         bound_ms=b_ms, bound_by=b_by)
    return res


# The head geometries the launchers were widened to, at small sizes: GQA
# groups of 7 (Qwen2-VL's 28 / 4) and 6 (12 / 2) on K1 and K2; head_dim 256
# (Gemma's) and 384 to 1024 (no public family; the reference serves a tiny
# model at any multiple of 128) on K1, K2, K4a, K4b, K7a, K7b and K7c, past
# 512 on the runtime-D bodies; folded head dims 96 (G 3), 80, 8, 192, 264,
# 320, 520 and 1000 (over 2 kv heads), and 100 / 20 (no multiple of 8: rows
# start off 16 bytes) on K3a and K3b; MLA at 4 heads (the reference's
# tiny-mla), 20 heads, a latent row of d_c 1024 + d_r 64, and one of d_c 30
# + d_r 6 (rows that start off 16 bytes) on K5 and K6. (name, Hq, Hkv, D)
# or, for MLA, (name, H, latent, d_c).
WIDE_D = (("D256", 8, 2, 256), ("D384", 8, 2, 384), ("D512", 8, 2, 512), ("D640", 8, 2, 640),
          ("D768", 8, 2, 768), ("D1024", 8, 2, 1024))
FOLDED_D = (("D96 G3", 12, 4, 96), ("D80", 16, 8, 80), ("D8", 32, 16, 8), ("D192", 8, 2, 192),
            ("D100", 8, 2, 100), ("D20", 16, 4, 20), ("D264", 8, 2, 264), ("D320", 8, 2, 320),
            ("D520", 8, 2, 520), ("D1000", 8, 2, 1000))
MLA_WIDE = (("H4", 4, MLA_LATENT, MLA_DC), ("H20", 20, MLA_LATENT, MLA_DC), ("L1088", 4, 1088, 1024),
            ("L36", 4, 36, 30))
WIDENED = {
    "K1": (("G7", 28, 4, 128), ("G6", 12, 2, 128), *WIDE_D),
    "K2": (("G7", 28, 4, 128), ("G6", 12, 2, 128), *WIDE_D),
    "K3a": FOLDED_D,
    "K3b": FOLDED_D,
    "K4a": WIDE_D,
    "K4b": WIDE_D,
    "K7c": WIDE_D,
    "K7b": WIDE_D,
    "K7a": WIDE_D,
    "K5": MLA_WIDE,
    "K6": MLA_WIDE,
}


def check_widened(torch, dev, rng) -> dict:
    """Every WIDENED shape launches on the card and is held to its plain
    version: K1 / K3a / K4a / K4b / K7c at B 12 (ragged contexts up to 512
    rows, inactive slots, a row at -1) and K2 / K3b on two 96-row lanes (from
    0, after a 200-row prefix) and a pad lane, in every mix they take (the
    rounded variants with ``rounding_slack``); K7b / K7a on the same tables
    over exact pools, exactly; K5 / K6 over f32 and bf16 pages (K6 at prefixes
    0 and 200). Each launch is then timed at its test shape (device ms; K6
    the chunk after the prefix). Returns {kernel: {shape: {"tol_share": the
    largest share of the limit, "ms": {mix: ms}}}}."""
    import functools

    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels import mla_attention as mla
    from dynamo_tpu_torch.ops.kernels import paged_attention as pa
    from dynamo_tpu_torch.ops.kernels import prefill_attention as pf
    from dynamo_tpu_torch.tools.checks import exact_pools, rounding_slack

    res = {name: {} for name in WIDENED}

    def record(which, shape, shares, ms):
        res[which][shape] = {"tol_share": max(shares), "ms": ms}

    decode = {
        "K1": (pa.paged_decode_attention_kernel, plain.paged_decode_attention, MIXES),
        "K3a": (pa.paged_decode_attention_folded_kernel, plain.paged_decode_attention, MIXES),
        "K4a": (pa.paged_decode_attention_chunked_kernel, plain.paged_decode_attention_chunked, MIXES[:2]),
        "K4b": (pa.paged_decode_attention_grouped_kernel, plain.paged_decode_attention_grouped, MIXES[:2]),
        "K7c": (functools.partial(pa.paged_decode_perseq_variant_kernel, cast_f32=False),
                plain.paged_decode_attention_grouped, MIXES[:2]),
    }
    for which, (kernel, ref_fn, mixes) in decode.items():
        for shape, Hq, Hkv, D in WIDENED[which]:
            case = decode_case(torch, dev, rng, Hq, Hkv, D, B=12, rows=512)
            shares, ms = [], {}
            for name, qdt_name, kind in mixes:
                qdt = getattr(torch, qdt_name)
                q = case["q32"].to(qdt)
                k, v = mix_pools(torch, case["k32"], case["v32"], qdt, kind)[:2]
                got = kernel(q, k, v, case["pt_t"], case["pos_t"])
                ms[name] = timed(lambda: kernel(q, k, v, case["pt_t"], case["pos_t"]), 10)["ms"]
                ref = ref_fn(q, k, v, case["pt_t"], case["pos_t"])
                slack = None
                if which in ("K4a", "K4b", "K7c"):  # probabilities rounded at a bf16 boundary
                    unit = pa.chunk_pages(case["ps"], case["pt"].shape[1]) if which == "K4a" else 1
                    slack = rounding_slack(q, k, v, case["pt_t"], case["pos_t"], unit * case["ps"])
                shares.append(held_to_plain(f"{which} {shape}", name, got, ref,
                                            "f32" if qdt == torch.float32 else "bf16", slack)["tol_share"])
            record(which, shape, shares, ms)
    twin = pa.paged_decode_dmaonly_kernel
    for shape, Hq, Hkv, D in WIDENED["K7b"]:
        case = decode_case(torch, dev, rng, Hq, Hkv, D, B=12, rows=512)
        ms = {}
        for name, qdt_name, _ in MIXES[:2]:
            q = case["q32"].to(getattr(torch, qdt_name))
            ke, ve = exact_pools(tuple(case["k32"].shape), qdt_name, dev)
            held_exactly(f"K7b {shape}", name, twin(q, ke, ve, case["pt_t"], case["pos_t"]),
                         plain.paged_decode_dmaonly(q, ke, ve, case["pt_t"], case["pos_t"]))
            ms[name] = timed(lambda: twin(q, ke, ve, case["pt_t"], case["pos_t"]), 10)["ms"]
        record("K7b", shape, [0.0], ms)
    T, ps, max_pages = 96, 16, 24
    prefill = {"K2": pf.paged_prefill_attention_kernel, "K3b": pf.paged_prefill_attention_folded_kernel,
               "K7a": pf.paged_prefill_dmaonly_kernel}
    for which, kernel in prefill.items():
        for shape, Hq, Hkv, D in WIDENED[which]:
            P = 1 + 2 * max_pages
            pt = np.zeros((3, max_pages), np.int32)
            pt[:2] = (1 + rng.permutation(P - 1)).reshape(2, max_pages)
            pt_t = torch.from_numpy(pt).to(dev)
            pos_t = torch.from_numpy(np.stack([s + np.arange(T) for s in (0, 200, 0)]).astype(np.int32)).to(dev)
            k32, v32 = (torch.randn((P, ps, Hkv, D), device=dev) for _ in range(2))
            q32 = torch.randn((3 * T, Hq, D), device=dev)
            shares, ms = [], {}
            for name, qdt_name, kind in MIXES:
                qdt = getattr(torch, qdt_name)
                q = q32.to(qdt)
                if which == "K7a":  # exact pools: the checksums hold exactly
                    k, v = exact_pools((P, ps, Hkv, D), qdt_name if kind == "plain" else "int8", dev)
                    held_exactly(f"K7a {shape}", name, kernel(q, k, v, pt_t, pos_t),
                                 plain.paged_prefill_dmaonly(q, k, v, pt_t, pos_t))
                    shares.append(0.0)
                else:
                    k, v = mix_pools(torch, k32, v32, qdt, kind)[:2]
                    got = kernel(q, k, v, pt_t, pos_t)
                    ref = plain.paged_prefill_attention_lanes(q, k, v, pt_t, pos_t)
                    shares.append(held_to_plain(f"{which} {shape}", name, got, ref,
                                                "f32" if qdt == torch.float32 else "bf16")["tol_share"])
                ms[name] = timed(lambda: kernel(q, k, v, pt_t, pos_t), 10)["ms"]
            record(which, shape, shares, ms)
    for shape, H, L, dc in WIDENED["K5"]:
        B, max_pages = 12, 32
        lengths = rng.integers(1, max_pages * ps + 1, B)
        lengths[0] = max_pages * ps  # its table holds the prefill chunks' context too
        pt, P = mla_tables(rng, lengths, ps, max_pages)
        pos = (lengths - 1).astype(np.int32)
        pos[-1] = -1
        pt_t, pos_t = torch.from_numpy(pt).to(dev), torch.from_numpy(pos).to(dev)
        pages32 = torch.randn((P, ps, L), device=dev)
        q = torch.randn((B, H, L), device=dev) / L**0.5
        qp = torch.randn((T, H, L), device=dev) / L**0.5
        shares = {"K5": [], "K6": []}
        ms = {"K5": {}, "K6": {}}
        k5, k6 = mla.paged_mla_decode_attention_kernel, mla.paged_mla_prefill_attention_kernel
        for name, dt in MLA_MIXES:
            pages = pages32.to(getattr(torch, dt))
            got = k5(q, pages, pt_t, pos_t, dc)
            ref = plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc)
            shares["K5"].append(held_to_plain(f"K5 {shape}", f"f32 q / {name} pages", got, ref, "f32")["tol_share"])
            ms["K5"][name] = timed(lambda: k5(q, pages, pt_t, pos_t, dc), 10)["ms"]
            for start in (0, 200):
                pos_p = torch.arange(start, start + T, dtype=torch.int32, device=dev)
                got = k6(qp, pages, pt_t[0], pos_p, dc)
                ref = plain.paged_mla_prefill_attention(qp, pages, pt_t[0], pos_p, dc)
                shares["K6"].append(held_to_plain(f"K6 {shape} (prefix {start})", f"f32 q / {name} pages", got, ref,
                                                  "f32")["tol_share"])
            ms["K6"][name] = timed(lambda: k6(qp, pages, pt_t[0], pos_p, dc), 10)["ms"]
        for which in ("K5", "K6"):
            record(which, shape, shares[which], ms[which])
    log("widened shapes, largest share of the limit and device ms a mix: " + "; ".join(
        f"{k} " + ", ".join(f"{s} {v['tol_share']:.3f} (" + ", ".join(f"{m} {t:.4f}" for m, t in v["ms"].items()) + ")"
                            for s, v in shapes.items()) for k, shapes in res.items()))
    return res


def phase_refusals(torch, dev) -> None:
    """What the port does not take raises on the card and falls back to
    nothing: an int8 cache on the MLA family and on K4a, a float16 query on
    K3b, K4b at a head dim it does not take. K1 at head_dim 640 and K3a at
    520, refused before, launch through the dispatcher and hold their plain
    versions."""
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.ops import attention as att

    pt = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]], dtype=torch.int32, device=dev)
    pos = torch.tensor([20, 5], dtype=torch.int32, device=dev)
    for what, D in (("K1 at head_dim 640", 640), ("K3a at head_dim 520", 520)):
        q = torch.randn((2, 8, D), device=dev)
        k, v = (torch.randn((5, 16, 2, D), device=dev) for _ in range(2))
        held_to_plain(f"formerly refused: {what}", "f32", att.dispatch_paged_decode_attention(q, k, v, pt, pos),
                      att.paged_decode_attention(q, k, v, pt, pos))
    cases = {
        "tiny-mla with an int8 KV cache": lambda: load_model("tiny-mla", device="cuda", kv_cache_dtype="int8"),
        "K3b over float16": lambda: att.dispatch_paged_prefill_attention(
            torch.zeros((16, 32, 64), device=dev, dtype=torch.float16),
            *[torch.zeros((5, 16, 4, 64), device=dev, dtype=torch.float16)] * 2, pt[0], pos.repeat(8)),
    }
    from dynamo_tpu_torch.ops.kernels import paged_attention as pa
    from dynamo_tpu_torch.quant.kv import QuantizedPages

    q8 = torch.zeros((2, 8, 128), device=dev, dtype=torch.bfloat16)
    int8_pool = QuantizedPages(torch.zeros((5, 16, 2, 128), device=dev, dtype=torch.int8),
                               torch.ones((5, 16), device=dev))
    cases |= {
        "K4a over an int8 cache": lambda: pa.paged_decode_attention_chunked_kernel(q8, int8_pool, int8_pool, pt, pos),
        "K4b at head_dim 32": lambda: pa.paged_decode_attention_grouped_kernel(
            torch.zeros((2, 8, 32), device=dev), *[torch.zeros((5, 16, 2, 32), device=dev)] * 2, pt, pos),
    }
    for what, call in cases.items():
        try:
            call()
        except ValueError as e:
            log(f"refused on the card: {what} ({e})")
            continue
        raise AssertionError(f"{what} did not raise")


# ---------------------------------------------------------------- K8

# Llama-3-8B's seven projections (in, out) at the serve path's row counts: a
# 16-slot decode step, 64 rows, and packed prefill calls of 512 and 2048
# rows; DeepSeek-V2-Lite's 2-D int8_wo products (attention, the dense
# layer's MLP, the shared experts) at a decode step and a 512-row prefill
# chunk; its gate / up expert banks [64, C, 2048] x [64, 2048, 1408] at a
# 16-slot decode step's capacity (3 rows an expert) and a 512-row prefill
# chunk's (96); and one shape that is no multiple of the 128-column tile nor
# of 16 (the mma body, 4-byte copies)
K8_LLAMA = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
            "gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}
K8_ROWS = (16, 64, 512, 2048)
K8_V2_LITE = {"w_q": (2048, 3072), "w_dkv": (2048, 576), "wo": (2048, 2048), "mlp gate": (2048, 10944),
              "mlp down": (10944, 2048), "shared gate": (2048, 2816), "shared down": (2816, 2048)}
K8_V2_ROWS = (16, 512)
K8_EXPERTS = {"E64 C3": (64, 3, 2048, 1408), "E64 C96": (64, 96, 2048, 1408)}
K8_ODD = (37, 1000, 1000)
# the shapes whose numbers stand in the kernels line's rows: the decode
# step's largest projection, and the decode step's expert bank
K8_MAIN, K8_EXPERT_MAIN = "gate T16", "E64 C3"
# a decode step reads each layer's weights once from HBM (32 layers of
# Llama-3-8B int8 are 7 GB): at decode sizes K8 and torch.matmul are also
# timed over copies of the weight that together exceed the 50 MB L2, one
# copy a call
L2_BYTES = 50 * 2**20


def k8_inputs(torch, dev, lead, K: int, N: int):
    """(h, q, s, the dequantized bf16 weight) for a [.., in, out] weight of
    normal(0, 1 / sqrt(in)) values quantized by the port, h normal bf16."""
    from dynamo_tpu_torch.quant.int8 import dequantize_int8, quantize_int8

    qw = quantize_int8(torch.randn((*lead[:-1], K, N), device=dev) / K**0.5)
    h = torch.randn((*lead, K), device=dev).to(torch.bfloat16)
    return h, qw.q, qw.s, dequantize_int8(qw, torch.bfloat16)


def k8_plan(h, q):
    """K8's plan for (h, q): its body ("wgmma" or "mma"), tile rows,
    splits and K rows a split (``ops/kernels/int8_linear.py plan``)."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import plan

    return plan(h.shape[-2], q.shape[-2], q.shape[-1], q.shape[0] if q.dim() == 3 else 1, h.dtype)


def cold_copies(torch, t) -> list:
    """``t`` and enough copies of it that together they exceed the L2."""
    return [t] + [t.clone() for _ in range(L2_BYTES // (t.numel() * t.element_size()) + 1)]


def k8_entry(torch, what: str, kernel, h, q, s, wb) -> dict:
    """K8 on (h, q, s) held to its plain version (bf16 limit), timed beside
    the plain version, the library call over the dequantized bf16 weight
    (``torch.matmul``, which reads 2 bytes a weight) and the bound: the int8
    weight, its scales, h and the output moved once, or 2 T in out
    operations at the bf16 tensor rate. At decode sizes (T <= 64) both are
    also timed cold (``cold_ms``, ``library_cold_ms``): each call reads
    another copy of the weight, as a decode step reads each layer's."""
    from dynamo_tpu_torch.quant.int8 import qlinear_plain
    from dynamo_tpu_torch.tools.timing import launch_times

    p = k8_plan(h, q)
    got = kernel(h, q, s)
    held = held_to_plain(f"K8 {what} ({p.body} body)", "bf16", got, qlinear_plain(h, q, s))
    kt = timed(lambda: kernel(h, q, s), 30)
    plain_ms = cuda_ms(lambda: qlinear_plain(h, q, s), 3)
    lt = timed(lambda: torch.matmul(h, wb), 30, "library_")
    nbytes = q.numel() + 4 * s.numel() + 2 * h.numel() + 2 * got.numel()
    b_ms, b_by = bound(nbytes, 2 * h.numel() * q.shape[-1], "bf16")
    cold = {}
    if h.shape[-2] <= 64:
        qs, ss, wbs = cold_copies(torch, q), cold_copies(torch, s), cold_copies(torch, wb)
        n = min(len(qs), len(ss))
        cold["cold_ms"] = launch_times(lambda i: kernel(h, qs[i % len(qs)], ss[i % n]), 30)[0] / 1e3
        cold["library_cold_ms"] = launch_times(lambda i: torch.matmul(h, wbs[i % len(wbs)]), 30)[0] / 1e3
        del qs, ss, wbs
    log(f"K8 {what}: {p.body} body (tile rows {p.rows}, {p.splits} split(s) of {p.k_per_split}), kernel "
        f"{kt['ms']:.4f} ms (back to back {kt['b2b_ms']:.4f}), plain {plain_ms:.4f} ms, torch.matmul over the bf16 "
        f"weight {lt['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB), "
        f"{b_ms / kt['ms']:.3f} of the bound"
        + (f"; cold weights: kernel {cold['cold_ms']:.4f} ms, torch.matmul {cold['library_cold_ms']:.4f} ms"
           if cold else ""))
    return dict(**held, **kt, plain_ms=plain_ms, **lt, bound_ms=b_ms, bound_by=b_by, body=p.body,
                plan=[p.rows, p.splits, p.k_per_split], **cold)


def check_int8_linear(torch, dev) -> dict:
    """K8 in both forms at the shapes above, bf16 activations (the serve
    paths': every served shape on the wgmma body); its f32 activations (the
    parity phases': bf16 hi + lo products on the mma body) at Llama's
    wq, T 16, held to the f32 limit; the 1000-wide shape on the mma body;
    two launches of a split-K shape (a cluster's partials summed through
    distributed shared memory) give the same bits. Returns {"K8": {shape:
    entry}, "K8 experts": {shape: entry}}."""
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_expert_kernel, int8_linear_kernel
    from dynamo_tpu_torch.quant.int8 import qlinear_plain

    def body_is(h, q, want: str, what: str) -> None:
        if k8_plan(h, q).body != want:
            raise AssertionError(f"K8 {what}: the {k8_plan(h, q).body} body, not the {want} body")

    # the plan's split rule assumes CLUSTER_BLOCKS blocks resident at once
    # in clusters of each size: hold it to this card
    import ctypes

    from dynamo_tpu_torch.ops.kernels import _build
    from dynamo_tpu_torch.ops.kernels.int8_linear import CLUSTER_BLOCKS

    resident = _build.entry("int8_linear", "w8a16_wgmma_max_clusters", [ctypes.c_int, ctypes.c_int])
    for bt in (16, 128):
        blocks = {n: n * resident(bt, n) for n in CLUSTER_BLOCKS}
        log(f"K8 blocks resident in clusters of 1-8, tile rows {bt}: {blocks} (the plan assumes {CLUSTER_BLOCKS})")
        if any(blocks[n] < CLUSTER_BLOCKS[n] for n in CLUSTER_BLOCKS):
            raise AssertionError(f"K8: this card holds fewer resident blocks than the plan assumes: {blocks}")
    out = {"K8": {}, "K8 experts": {}}
    shapes = [("Llama-3-8B", name, "", K, N, T) for name, (K, N) in K8_LLAMA.items() for T in K8_ROWS]
    shapes += [("DeepSeek-V2-Lite", name, "V2-Lite ", K, N, T) for name, (K, N) in K8_V2_LITE.items()
               for T in K8_V2_ROWS]
    for model, name, prefix, K, N, T in shapes:
        h, q, s, wb = k8_inputs(torch, dev, (T,), K, N)
        body_is(h, q, "wgmma", f"{model} {name} T {T}")
        out["K8"][f"{prefix}{name} T{T}"] = k8_entry(torch, f"{model} {name} [{T}, {K}] x [{K}, {N}]",
                                                     int8_linear_kernel, h, q, s, wb)
        if (model, name, T) in (("Llama-3-8B", "wq", 16), ("Llama-3-8B", "wq", 512)):
            if k8_plan(h, q).splits < 2:
                raise AssertionError(f"K8: Llama-3-8B wq T {T} is not split")
            if not torch.equal(int8_linear_kernel(h, q, s), int8_linear_kernel(h, q, s)):
                raise AssertionError(f"K8: two launches of a split-K shape (wq T {T}) differ")
        if (model, name, T) == ("Llama-3-8B", "wq", 16):
            h32 = h.float()
            body_is(h32, q, "mma", "f32 activations")
            held_to_plain("K8 Llama-3-8B wq T 16, f32 activations (mma body)", "f32", int8_linear_kernel(h32, q, s),
                          qlinear_plain(h32, q, s))
        del h, q, s, wb
    T, K, N = K8_ODD
    h, q, s, wb = k8_inputs(torch, dev, (T,), K, N)
    body_is(h, q, "mma", f"out {N}")
    out["K8"][f"odd T{T} in {K} out {N}"] = k8_entry(torch, f"[{T}, {K}] x [{K}, {N}]", int8_linear_kernel,
                                                    h, q, s, wb)
    for key, (E, C, K, N) in K8_EXPERTS.items():
        h, q, s, wb = k8_inputs(torch, dev, (E, C), K, N)
        body_is(h, q, "wgmma", f"expert bank {key}")
        out["K8 experts"][key] = k8_entry(torch, f"DeepSeek-V2-Lite expert bank [{E}, {C}, {K}] x [{E}, {K}, {N}]",
                                          int8_linear_expert_kernel, h, q, s, wb)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- engine


@contextlib.contextmanager
def decode_kernel_env(choice: str | None):
    """DYNTPU_DECODE_KERNEL set to ``choice`` (None: unset) inside, restored
    after."""
    from dynamo_tpu_torch.ops.attention import DECODE_KERNEL_ENV

    old = os.environ.pop(DECODE_KERNEL_ENV, None)
    if choice is not None:
        os.environ[DECODE_KERNEL_ENV] = choice
    try:
        yield
    finally:
        os.environ.pop(DECODE_KERNEL_ENV, None)
        if old is not None:
            os.environ[DECODE_KERNEL_ENV] = old


async def serve_on(engine, requests):
    """Run ``requests`` concurrently through a started engine's
    ``generate``; returns ({rid: (tokens, finish_reason, ttft_s)}, wall_s)."""

    async def one(req):
        t0 = time.monotonic()
        toks, reason, ttft = [], None, None
        async for out in engine.generate(req):
            if out.token is not None:
                if ttft is None:
                    ttft = time.monotonic() - t0
                toks.append(out.token)
            reason = out.finish_reason
        return req.request_id, (toks, reason, ttft)

    t0 = time.monotonic()
    results = dict(await asyncio.gather(*(one(r) for r in requests)))
    return results, time.monotonic() - t0


async def serve(config, requests, model=None, before_serve=None):
    """Run ``requests`` concurrently through a fresh AsyncTorchEngine, after
    ``before_serve()`` (once the engine has started and warmed up); returns
    ({rid: (tokens, finish_reason, ttft_s)}, wall_s, engine, graph captures
    during the serve)."""
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine

    engine = AsyncTorchEngine(config, model=model)
    await engine.start()
    try:
        if before_serve is not None:
            before_serve()
        captures = engine.runner.compile_monitor.compiles
        results, wall = await serve_on(engine, requests)
        captures = engine.runner.compile_monitor.compiles - captures
    finally:
        await engine.shutdown()
    return results, wall, engine, captures


def graphs_line(engine) -> str:
    """The engine's warmup seconds, graph captures and replays and the
    graphs' memory pool."""
    runner = engine.runner
    snap = runner.compile_monitor.snapshot()
    pool = runner.graphs.pool_bytes()
    replays = sum(e.replays for e in runner.graphs.entries.values())
    return (f"warmup {engine.warmup_s:.1f} s, {snap['compiles']} graph captures in {snap['compile_s']:.1f} s "
            f"({json.dumps(snap['per_label'])}), {replays} replays, graph pool "
            + ("not reported" if pool is None else f"{pool / 2**20:.1f} MiB"))


def anatomy_line(anatomy) -> str:
    """The step anatomy's host fraction, roofline fractions, prefill fixed
    ms and decode dispatch gap (None: no such dispatch)."""

    def f(v, nd=4):
        return "None" if v is None else f"{v:.{nd}f}"

    return (f"host fraction {f(anatomy.host_fraction())} (decode {f(anatomy.host_fraction(('decode_window',)))}, "
            f"prefill {f(anatomy.host_fraction(('prefill_packed', 'prefill_chunk')))}), roofline fraction "
            f"{f(anatomy.roofline_fraction())}, prefill roofline fraction {f(anatomy.prefill_roofline_fraction())}, "
            f"prefill fixed {f(anatomy.prefill_fixed_ms(), 3)} ms, decode dispatch gap p50 "
            f"{f(anatomy.dispatch_gap_ms(), 3)} ms, dispatches {json.dumps(anatomy.dispatch_counts)}")


def phase_serve(torch, gpu_name: str, what: str, config, requests, kernels: dict,
                forbidden: dict | None = None, after=None, record: dict | None = None) -> dict:
    """Serve ``requests`` on ``config``; every stream must end with exactly
    MAX_TOKENS tokens, each of ``kernels`` ({name: launcher}) must have
    launched and none of ``forbidden``; an int8 config must have served from
    int8 pools, an int8_wo one from int8 weights. ``after(engine)``, when
    given, runs on the served engine once the counts are read; ``record``,
    when given, takes the run's streams, wall and TTFTs under ``what``.
    Returns {name: launches in this run}."""
    from dynamo_tpu_torch.quant.kv import QuantizedPages
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS as max_tokens

    import dataclasses

    forbidden = forbidden or {}
    lens = np.array([len(r.token_ids) for r in requests])
    # every step graph captured before the timed serve, whose launches are
    # then the replays' tallies: the counts start at 0 after the warmup
    config = dataclasses.replace(config, warmup=True)

    def zero_counts():
        for fn in (*kernels.values(), *forbidden.values()):
            fn.launches = 0

    results, wall, engine, captures = asyncio.run(serve(config, requests, before_serve=zero_counts))
    launches = {name: fn.launches for name, fn in kernels.items()}
    stray = {name: fn.launches for name, fn in forbidden.items() if fn.launches}
    for rid, (toks, reason, _) in results.items():
        if len(toks) != max_tokens or reason != "length":
            raise AssertionError(f"{what} {rid}: {len(toks)} tokens, finish {reason!r} (want {max_tokens}, 'length')")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{what}: main path skipped a kernel: launches {launches}")
    if stray:
        raise AssertionError(f"{what}: kernels off this path launched: {stray}")
    if captures:
        raise AssertionError(f"{what}: {captures} graph captures inside the timed serve")
    quantized = any(isinstance(pool, QuantizedPages) for pool in engine.runner.kv_cache.values())
    if quantized != (config.kv_cache_dtype == "int8"):
        raise AssertionError(f"{what}: kv_cache_dtype {config.kv_cache_dtype!r} but int8 pools: {quantized}")
    int8_weights = any(p.dtype == torch.int8 for p in engine.model.parameters())
    if int8_weights != (engine.model.config.quantize == "int8_wo"):
        raise AssertionError(f"{what}: quantize {engine.model.config.quantize!r} but int8 weights: {int8_weights}")
    if "K5" in kernels:  # the body is chosen by the pool's dtype and widths alone: every K5 call ran it
        from dynamo_tpu_torch.ops.kernels.mla_attention import decode_on_tensor_cores

        pool, d_c = engine.runner.kv_cache["ckv"], engine.model.config.kv_lora_rank
        if not decode_on_tensor_cores(pool.shape[-1], d_c, pool.dtype):
            raise AssertionError(f"{what}: K5 ran its FMA body (pool {pool.dtype}, latent {pool.shape[-1]}, d_c {d_c})")
        log(f"{what}: every K5 call ran mla_decode_tc (latent pool {pool.dtype}, width {pool.shape[-1]}, d_c {d_c})")
    n_out = sum(len(t) for t, _, _ in results.values())
    ttfts = sorted(t for _, _, t in results.values())
    if record is not None:
        record[what] = dict(results=results, wall=wall, n_out=n_out, ttfts=ttfts)
    log(f"{what}: {len(results)}/{len(requests)} streams finished with {max_tokens} tokens; prompts "
        f"{int(lens.min())}-{int(lens.max())} (sum {int(lens.sum())}); KV cache "
        f"{'int8' if quantized else 'bf16'}; launches " + " ".join(f"{k} {v}" for k, v in launches.items())
        + (" (none of " + ", ".join(forbidden) + ")" if forbidden else ""))
    log(f"{what} [{gpu_name}]: {n_out / wall:.1f} output tok/s, "
        f"{(n_out + int(lens.sum())) / wall:.1f} total tok/s, wall {wall:.2f} s, "
        f"TTFT p50 {np.median(ttfts) * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms")
    # after the last first token only decode windows run: the decode rate
    n_after = n_out - len(results)
    log(f"{what} decode phase [{gpu_name}]: {n_after / (wall - ttfts[-1]):.1f} tok/s over "
        f"{wall - ttfts[-1]:.3f} s ({n_after} tokens, batch {len(results)})")
    log(f"{what} graphs: {graphs_line(engine)}; no capture in the timed serve")
    log(f"{what} step anatomy [{gpu_name}]: {anatomy_line(engine.scheduler.anatomy)}")
    if after is not None:
        after(engine)
    del engine
    torch.cuda.empty_cache()
    return launches


# decode contexts of the decode-step measurement: the serve workload's mean
# prompt (17036 / 16 tokens) plus half its output
DECODE_STEP_CTX = 1065 + 32


def decode_step(torch, gpu_name: str, what: str):
    """``after`` for phase_serve: a decode step of the served engine (every
    slot active at DECODE_STEP_CTX, as graph replays of 8- and 64-step
    windows, differenced: host walls by ``tools/profile_decode.py measure``,
    and the model alone's device time by its ``device_model_ms``, CUDA
    events around each replay, 7 pairs: median and range) against the
    weight floor, every weight but the embedding table read once a step at
    3.35 TB/s, and that floor with the live KV pages."""

    def run(engine):
        from dynamo_tpu_torch.tools.profile_decode import STEPS, decode_state, device_model_ms, measure
        from dynamo_tpu_torch.utils.step_anatomy import roofline_for_runner

        runner, cfg = engine.runner, engine.config
        B = cfg.max_seqs
        t = measure(runner, cfg, B, DECODE_STEP_CTX, modes=("graph",))["graph"]
        span = STEPS[1] - STEPS[0]
        window_ms = (t["window"][1] - t["window"][0]) / span * 1e3
        model_ms = (t["model_only"][1] - t["model_only"][0]) / span * 1e3
        device = sorted(device_model_ms(runner, cfg, B, DECODE_STEP_CTX))
        weight_bytes = sum(p.numel() * p.element_size() for n, p in engine.model.named_parameters() if n != "embed")
        live = decode_state(cfg, B, DECODE_STEP_CTX)["live_pages"]
        floor_kv = roofline_for_runner(runner, cfg).step_floor_seconds(live) * 1e3
        log(f"{what} decode step [{gpu_name}] (B {B}, context {DECODE_STEP_CTX}, graph replays, "
            f"{STEPS[1]}- less {STEPS[0]}-step windows): host walls: window {window_ms:.3f} ms a step, model "
            f"alone {model_ms:.3f} ms; model alone on the device (CUDA events, {len(device)} pairs): median "
            f"{device[len(device) // 2]:.4f} ms a step, range {device[0]:.4f}-{device[-1]:.4f}; weight floor "
            f"{weight_bytes / HBM_BYTES_S * 1e3:.3f} ms ({weight_bytes / 1e9:.2f} GB of weights but the "
            f"embedding), with the live KV pages and the embedding table {floor_kv:.3f} ms; device median / "
            f"weight floor {device[len(device) // 2] / (weight_bytes / HBM_BYTES_S * 1e3):.2f}")

    return run


def hash_times_us(prompt_len: int = 2048, page_sizes=(4, 16, 128), reps: int = 20) -> dict:
    """{page size: median host µs to hash one ``prompt_len``-token prompt}
    (``TokenSequence``: every full block's hash and chained hash in one call
    of the C library, and the block objects)."""
    from dynamo_tpu_torch.llm.tokens import TokenSequence

    prompt = np.random.default_rng(1).integers(0, 128256, prompt_len).tolist()
    out = {}
    for ps in page_sizes:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            TokenSequence(prompt, ps)
            times.append(time.perf_counter() - t0)
        out[ps] = float(np.median(times)) * 1e6
    return out


def check_featured_stream(rid: str, req, got: dict) -> None:
    """A prefix-serve stream ends as its parameters say, and its logprobs
    (where asked) are finite and <= 0, the chosen one equal to its entry
    among the alternatives where it appears there."""
    import math

    from dynamo_tpu_torch.tools.workload import MAX_TOKENS

    toks, finish, sam = got["tokens"], got["finish"], req.sampling
    if req.eos_token_ids:
        early = [t for t in toks[: sam.min_tokens] if t in req.eos_token_ids]
        stop_ok = finish == "stop" and sam.min_tokens < len(toks) <= MAX_TOKENS and toks[-1] in req.eos_token_ids
        if early or not (stop_ok or (finish == "length" and len(toks) == MAX_TOKENS)):
            raise AssertionError(f"prefix serve {rid}: {len(toks)} tokens, finish {finish!r}, EOS before min_tokens "
                                 f"{early}")
    elif finish != "length" or len(toks) != MAX_TOKENS:
        raise AssertionError(f"prefix serve {rid}: {len(toks)} tokens, finish {finish!r}")
    if req.logprobs is None:
        if any(v is not None for v in got["logprobs"]):
            raise AssertionError(f"prefix serve {rid}: logprobs nobody asked for")
        return
    for tok, lp, top in zip(toks, got["logprobs"], got["top"]):
        vals = [v for _, v in top or []]
        if (lp is None or not math.isfinite(lp) or lp > 0 or len(vals) != req.logprobs
                or not all(math.isfinite(v) and v <= 0 for v in vals) or vals != sorted(vals, reverse=True)):
            raise AssertionError(f"prefix serve {rid}: logprob {lp}, alternatives {top}")
        if tok in dict(top) and dict(top)[tok] != lp:
            raise AssertionError(f"prefix serve {rid}: chosen {tok} logprob {lp} != its alternative {dict(top)[tok]}")


def phase_prefix_serve(torch, gpu_name: str, kernels: dict, forbidden: dict) -> dict:
    """The prefix workload (tools/workload.py prefix_serve_*: Llama-3-8B
    geometry, 32 layers, bf16, page size 16, 4096 pages, 16 slots, warmup
    True; 16 prompts sharing a 1024-token prefix with distinct tails of
    64-960 tokens, 64 output tokens each, the feature mix by i % 4) in three
    timed rounds on one engine: (a) request 0 alone; (b) requests 1-15 at
    once, each hitting the 64 prefix blocks; (c) all 16 again, each hitting
    every full block of its prompt (all but the last when the whole prompt
    is cached). Gates: every stream ends as its parameters say, its
    logprobs are sane (``check_featured_stream``); cached_tokens equal
    ``expected_cached`` exactly; each round's prefill rows (step anatomy)
    equal its prompt tokens less the cached ones; the stored events equal
    the blocks the prefix cache holds (no eviction at this size); no graph
    capture inside a round; K1 and K2 launch and none of ``forbidden``.
    Returns {name: launches over the three rounds}."""
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS, NUM_REQUESTS, prefix_serve_config, prefix_serve_requests

    config = prefix_serve_config()
    config.warmup = True
    events = []

    async def run():
        engine = AsyncTorchEngine(config, kv_event_sink=events.append)
        await engine.start()
        try:
            for fn in (*kernels.values(), *forbidden.values()):
                fn.launches = 0
            served, rounds = [], []
            for tag, idx in (("a", [0]), ("b", list(range(1, NUM_REQUESTS))), ("c", list(range(NUM_REQUESTS)))):
                reqs = prefix_serve_requests(tag, idx)
                expect = {r.request_id: expected_cached(config.page_size, served, r.token_ids) for r in reqs}
                anatomy = engine.scheduler.anatomy = type(engine.scheduler.anatomy)(
                    roofline=engine.scheduler.anatomy.roofline)
                captures = engine.runner.compile_monitor.compiles
                results, wall = await serve_outputs(engine, reqs)
                if engine.runner.compile_monitor.compiles != captures:
                    raise AssertionError(f"prefix serve round {tag}: "
                                         f"{engine.runner.compile_monitor.compiles - captures} captures inside it")
                for req in reqs:
                    got = results[req.request_id]
                    check_featured_stream(req.request_id, req, got)
                    if got["cached"] != expect[req.request_id]:
                        raise AssertionError(f"prefix serve {req.request_id}: cached_tokens {got['cached']}, the "
                                             f"allocation rule gives {expect[req.request_id]}")
                    served.append((req.token_ids, got["tokens"]))
                rows = sum(r["tokens"] for r in anatomy.records(limit=100_000) if r["kind"].startswith("prefill"))
                want_rows = sum(len(r.token_ids) - expect[r.request_id] for r in reqs)
                if rows != want_rows:
                    raise AssertionError(f"prefix serve round {tag}: {rows} prefill rows, prompts less cached "
                                         f"{want_rows}")
                rounds.append(dict(tag=tag, results=results, wall=wall, rows=rows, cached=expect))
            return engine, rounds
        finally:
            await engine.shutdown()

    engine, rounds = asyncio.run(run())
    launches = {name: fn.launches for name, fn in kernels.items()}
    stray = {name: fn.launches for name, fn in forbidden.items() if fn.launches}
    if min(launches.values()) <= 0 or stray:
        raise AssertionError(f"prefix serve: launches {launches}, off this path {stray}")
    alloc = engine.allocator
    stored = [b.block_hash for e in events if e.kind == "stored" for b in e.blocks]
    removed = [h for e in events if e.kind == "removed" for h in e.block_hashes]
    if removed or len(stored) != len(set(stored)) or set(stored) != set(alloc._cache):
        raise AssertionError(f"prefix serve: {len(stored)} stored events ({len(set(stored))} distinct), "
                             f"{len(removed)} removed, {len(alloc._cache)} blocks cached")
    a, b, c = rounds
    same = sum(c["results"][f"prefix-c-{i}"]["tokens"] == b["results"][f"prefix-b-{i}"]["tokens"]
               for i in range(1, NUM_REQUESTS))
    hashes = hash_times_us()

    def line(r):
        n_out = sum(len(x["tokens"]) for x in r["results"].values())
        ttft = np.median([x["ttft"] for x in r["results"].values()]) * 1e3
        cached = sum(r["cached"].values())
        return (f"{len(r['results'])} requests, {n_out / r['wall']:.1f} output tok/s, wall {r['wall']:.2f} s, TTFT p50 "
                f"{ttft:.1f} ms, {cached} cached of {cached + r['rows']} prompt tokens, {r['rows']} prefill rows")

    log(f"prefix serve: streams end as asked (greedy + logprobs 5, greedy + penalties, min_tokens "
        f"32 + EOS ids, sampled + seeded + penalties + logprobs 3), logprobs finite <= 0 and the chosen equal to its "
        f"alternative; cached_tokens as the allocation rule gives in every round; {len(stored)} stored events = the "
        f"{len(alloc._cache)} cached blocks, none removed; launches "
        + " ".join(f"{k} {v}" for k, v in launches.items()) + " (none of " + ", ".join(forbidden) + ")")
    for r in rounds:
        log(f"prefix serve round ({r['tag']}) [{gpu_name}]: {line(r)}")
    log(f"prefix serve: {same}/{NUM_REQUESTS - 1} streams' round (c) tokens equal their round (b) tokens "
        "(bf16; other packings may round otherwise)")
    log(f"prefix serve hash of one 2048-token prompt on the host [{gpu_name}]: "
        + ", ".join(f"page size {ps} {us:.1f} us" for ps, us in hashes.items()))
    log(f"prefix serve graphs: {graphs_line(engine)}; no capture in the timed rounds")
    log(f"prefix serve metrics: {json.dumps(engine.metrics().to_wire())}")
    del engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- HTTP

# the HTTP path's engine: `run` takes the tiny card's KV block size
# (llm/model_card.py for_tiny) as its page size, and a context that holds the
# serve workload's longest prompt and its 64 tokens
HTTP_PAGE_SIZE, HTTP_MAX_MODEL_LEN = 4, 2112


@contextlib.contextmanager
def http_engine(args):
    """``run``'s engine and HTTP service for the parsed ``args`` (``--in http
    --out torch``), the service on a background event loop; yields (engine,
    port, on_loop), ``on_loop(coro)`` running a coroutine there. Both stop
    after."""
    import threading

    from dynamo_tpu_torch.frontends.http import build_service
    from dynamo_tpu_torch.launch._run_impl import _build_engine

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="http-serve", daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(600)

    async def boot():
        engine = await _build_engine(args)
        service = build_service(engine, args, host="127.0.0.1")
        return engine, service, await service.start()

    engine = service = None
    try:
        engine, service, port = on_loop(boot())
        yield engine, port, on_loop
    finally:
        if service is not None:
            on_loop(service.stop())
        if engine is not None:
            on_loop(engine.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()


def wait_background_warmup(engine, on_loop, what: str) -> float:
    """Wait for ``run``'s background warmup (its engines warm up so); its
    seconds after start returned."""
    if engine.config.warmup != "background":
        raise AssertionError(f"{what}: run built its engine with warmup={engine.config.warmup!r}")
    t_warm = time.monotonic()
    on_loop(engine.wait_warmup())  # the background captures end before the timed requests
    return time.monotonic() - t_warm


def stream_completions(port: int, requests, kernels: dict, forbidden: dict, what: str):
    """The requests' prompts as token-id lists to /v1/completions, each
    streamed from a client in its own thread (temperature 0, MAX_TOKENS,
    ext.ignore_eos and the timing annotation), with every count set to 0
    just before. Every stream must end with finish_reason "length",
    MAX_TOKENS completion tokens and data: [DONE]; each of ``kernels`` must
    have launched and none of ``forbidden``. Returns (launches, wall s,
    client TTFTs, service TTFTs): the client's TTFT is its wait less the
    service's time after the first token (the timing event), since a token
    that decodes to no text sends no event."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.tools.profile_http import http_stream
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS

    bodies = [{"prompt": r.token_ids, "stream": True, "temperature": 0, "max_tokens": MAX_TOKENS,
               "ext": {"ignore_eos": True, "annotations": ["timing"]}} for r in requests]
    for fn in (*kernels.values(), *forbidden.values()):
        fn.launches = 0
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(bodies)) as pool:
        results = list(pool.map(lambda b: http_stream(port, b), bodies))
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    stray = {name: fn.launches for name, fn in forbidden.items() if fn.launches}
    client_ttft, service_ttft = [], []
    for i, (msgs, waited) in enumerate(results):
        finish = msgs[-2].json() if len(msgs) >= 2 else {}
        timing = [m.json() for m in msgs if m.event == "timing"]
        if (not msgs[-1].is_done or finish.get("choices", [{}])[0].get("finish_reason") != "length"
                or finish.get("usage", {}).get("completion_tokens") != MAX_TOKENS or len(timing) != 1):
            raise AssertionError(f"{what} request {i}: stream ended {[m.data for m in msgs[-3:]]}")
        t = timing[0]
        service_ttft.append(t["ttft_ms"] / 1e3)
        client_ttft.append(waited - (t["total_ms"] - t["ttft_ms"]) / 1e3)
    if min(launches.values()) <= 0:
        raise AssertionError(f"{what}: main path skipped a kernel: launches {launches}")
    if stray:
        raise AssertionError(f"{what}: kernels off this path launched: {stray}")
    return launches, wall, client_ttft, service_ttft


def phase_http_serve(torch, gpu_name: str, kernels: dict, forbidden: dict) -> dict:
    """The CLI's own parse of ``run 'tiny:{LLAMA3_8B}' --in http --out torch
    --http-port 0 --max-model-len 2112 --num-pages N --max-seqs 16`` (page
    size 4, the tiny card's block size; N holds the workload above the
    admission watermark), ``run_http``'s service on a background event loop,
    and the serve workload's 16 prompts (tools/workload.py serve_requests,
    full width and depth, nothing cut) as token-id lists to
    /v1/completions, each from a client in its own thread: stream,
    temperature 0, max_tokens 64, ext.ignore_eos and the timing annotation.
    Every stream must end with finish_reason "length", 64 completion tokens
    and data: [DONE]; K1 and K2 must launch and none of ``forbidden``;
    /v1/models and /metrics must answer, and a unary chat request must give
    a chat.completion. Then the same requests run in process on the same
    engine (``serve_on``), for the HTTP edge's share of the wall. The
    workload's tokens decode to no text through the tiny card's
    ByteTokenizer (ids past 255), so the completions stream carries no event
    at the first token: the client's TTFT is its wait less the service's
    time after the first token (the timing event). Returns {name: launches
    in this run}."""
    from dynamo_tpu_torch.launch import run
    from dynamo_tpu_torch.tools.profile_http import http_call
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B, MAX_TOKENS, serve_requests

    requests = serve_requests()
    pages = sum(-(-(len(r.token_ids) + MAX_TOKENS) // HTTP_PAGE_SIZE) for r in requests)
    argv = ["run", "tiny:" + json.dumps(LLAMA3_8B), "--in", "http", "--out", "torch", "--http-port", "0",
            "--max-model-len", str(HTTP_MAX_MODEL_LEN), "--num-pages", str(int(pages / 0.9) + 2),
            "--max-seqs", str(len(requests))]
    args = run.build_parser().parse_args(argv)
    with http_engine(args) as (engine, port, on_loop):
        if engine.config.page_size != HTTP_PAGE_SIZE or engine.device.type != "cuda":
            raise AssertionError(f"http serve: engine at page size {engine.config.page_size} on {engine.device}")
        background_s = wait_background_warmup(engine, on_loop, "http serve")
        captures = engine.runner.compile_monitor.compiles
        anatomy = engine.scheduler.anatomy
        http_anatomy = engine.scheduler.anatomy = type(anatomy)(roofline=anatomy.roofline)
        launches, wall, client_ttft, service_ttft = stream_completions(port, requests, kernels, forbidden,
                                                                       "http serve")
        status, body = http_call(port, "GET", "/v1/models")
        if status != 200 or [m["id"] for m in json.loads(body)["data"]] != [args.model]:
            raise AssertionError(f"http serve /v1/models: {status} {body[:200]!r}")
        status, body = http_call(port, "GET", "/metrics")
        served = [line for line in body.decode().splitlines() if line.startswith("llm_http_service_requests_total")
                  and 'request_type="stream",status="200"}' in line]
        if status != 200 or len(served) != 1 or not served[0].endswith(f" {len(requests)}"):
            raise AssertionError(f"http serve /metrics: {status}, stream counters {served}")
        # the same engine driven in process (engine.generate, no HTTP), for
        # the HTTP edge's share of the wall: one pair in one call, the
        # prefix cache emptied first so that both prefill every prompt
        on_loop(engine.run_on_engine(engine.allocator.reset_prefix_cache))
        direct_anatomy = engine.scheduler.anatomy = type(anatomy)(roofline=anatomy.roofline)
        direct, direct_wall = on_loop(serve_on(engine, serve_requests()))
        if engine.runner.compile_monitor.compiles != captures:
            raise AssertionError(f"http serve: {engine.runner.compile_monitor.compiles - captures} graph captures "
                                 "inside the timed requests")
        if any(len(toks) != MAX_TOKENS for toks, _, _ in direct.values()):
            raise AssertionError(f"http serve, in process: tokens {[len(t) for t, _, _ in direct.values()]}")
        status, body = http_call(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Hello"}], "max_tokens": 8, "temperature": 0})
        chat = json.loads(body)
        choice = (chat.get("choices") or [{}])[0]
        n = chat.get("usage", {}).get("completion_tokens", 0)
        if (status != 200 or chat.get("object") != "chat.completion" or choice["message"]["role"] != "assistant"
                or not isinstance(choice["message"]["content"], str) or not 1 <= n <= 8
                or choice["finish_reason"] != ("length" if n == 8 else "stop")):
            raise AssertionError(f"http serve chat: {status} {chat}")
        features = http_features(port, requests[0].token_ids[:200])
    n_out = len(requests) * MAX_TOKENS
    log(f"http serve: {len(requests)}/{len(requests)} streams ended with {MAX_TOKENS} tokens, length and [DONE]; "
        f"launches " + " ".join(f"{k} {v}" for k, v in launches.items()) + " (none of " + ", ".join(forbidden)
        + f"); /v1/models, /metrics and a unary chat.completion ({n} tokens) answered")
    log(f"http serve [{gpu_name}]: {n_out / wall:.1f} output tok/s, wall {wall:.2f} s, client TTFT p50 "
        f"{np.median(client_ttft) * 1e3:.1f} ms (max {max(client_ttft) * 1e3:.1f}), service TTFT p50 "
        f"{np.median(service_ttft) * 1e3:.1f} ms")
    log(f"http serve, the same engine in process [{gpu_name}]: {n_out / direct_wall:.1f} output tok/s, wall "
        f"{direct_wall:.2f} s, TTFT p50 {np.median([t for _, _, t in direct.values()]) * 1e3:.1f} ms; HTTP wall / in-process "
        f"wall {wall / direct_wall:.3f} (one pair, HTTP first)")
    log(f"http serve features (untimed): {features}")
    log(f"http serve graphs (run's warmup=\"background\", its captures ended {background_s:.1f} s after start "
        f"returned): {graphs_line(engine)}; no capture in the timed requests")
    log(f"http serve step anatomy over HTTP [{gpu_name}]: {anatomy_line(http_anatomy)}")
    log(f"http serve step anatomy in process [{gpu_name}]: {anatomy_line(direct_anatomy)}")
    del engine
    torch.cuda.empty_cache()
    return launches


def http_features(port: int, prompt: list[int]) -> str:
    """Untimed requests to the http serve's service: a completion with
    logprobs 5, a chat with logprobs and top_logprobs 3 and a completion with
    repetition_penalty 1.3 must each carry their fields; then a fresh
    token-id prompt streamed twice, whose second timing event must report
    cached tokens."""
    from dynamo_tpu_torch.tools.profile_http import http_call, http_stream

    base = {"max_tokens": 8, "temperature": 0, "ext": {"ignore_eos": True}}
    status, body = http_call(port, "POST", "/v1/completions", dict(base, prompt=prompt, logprobs=5))
    lp = json.loads(body)["choices"][0].get("logprobs") if status == 200 else None
    # the legacy API keys each step's alternatives by token text, and the
    # tiny card's ByteTokenizer gives ids past 255 no text: they may collapse
    if (not lp or len(lp["token_logprobs"]) != 8 or any(not 1 <= len(t) <= 5 for t in lp["top_logprobs"])
            or not all(x <= 0 for x in lp["token_logprobs"])):
        raise AssertionError(f"http serve completion with logprobs 5: {status} {body[:400]!r}")
    status, body = http_call(port, "POST", "/v1/chat/completions", dict(
        base, messages=[{"role": "user", "content": "Hello"}], logprobs=True, top_logprobs=3))
    chat = json.loads(body) if status == 200 else {}
    content = ((chat.get("choices") or [{}])[0].get("logprobs") or {}).get("content") or []
    if (len(content) != chat.get("usage", {}).get("completion_tokens", -1)
            or any(len(e["top_logprobs"]) != 3 for e in content)):
        raise AssertionError(f"http serve chat with top_logprobs 3: {status} {body[:400]!r}")
    status, body = http_call(port, "POST", "/v1/completions", dict(base, prompt=prompt, repetition_penalty=1.3))
    if status != 200 or json.loads(body)["usage"]["completion_tokens"] != 8:
        raise AssertionError(f"http serve completion with repetition_penalty: {status} {body[:400]!r}")
    fresh = [(t * 7919 + 13) % 251 for t in prompt]  # ids every vocabulary holds
    cached = []
    for _ in range(2):
        msgs, _ = http_stream(port, dict(base, prompt=fresh, stream=True,
                                         ext={"ignore_eos": True, "annotations": ["timing"]}))
        cached.append([m.json() for m in msgs if m.event == "timing"][0]["cached_tokens"])
    if cached[1] <= 0:
        raise AssertionError(f"http serve: the repeated prompt's cached_tokens {cached}")
    return (f"logprobs 5 completion, top_logprobs 3 chat ({len(content)} entries) and repetition_penalty completion "
            f"answered with their fields; a {len(fresh)}-token prompt twice: cached_tokens {cached[0]} then "
            f"{cached[1]}")


# ---------------------------------------------------------------- checkpoints


def hf_state(torch, tensors: dict, cfg) -> dict:
    """The port's state dict from HF-named tensors, mapped here apart from
    ``models/loader.py`` (the model it builds is what the loaded one is held
    to): HF's [out, in] linears transposed, DeepSeek's kv_b_proj split into
    the k-up and v-up banks, the experts stacked into banks."""
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    def hf(layer: int, sub: str, transpose: bool = False):
        t = tensors[f"model.layers.{layer}.{sub}.weight"]
        return t.t() if transpose else t

    sd = {"embed": tensors["model.embed_tokens.weight"], "final_norm": tensors["model.norm.weight"],
          "lm_head": tensors["lm_head.weight"]}
    if not isinstance(cfg, DeepseekConfig):
        names = {"input_norm": "input_layernorm", "post_norm": "post_attention_layernorm", "wq": "self_attn.q_proj",
                 "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                 "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}
        for layer in range(cfg.num_layers):
            for name, sub in names.items():
                sd[f"layers.{layer}.{name}"] = hf(layer, sub, not name.endswith("norm"))
        return sd
    Ld, H = cfg.first_k_dense_replace, cfg.num_heads
    dn, dv, dc = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    for layer in range(cfg.num_layers):
        pre = f"dense_layers.{layer}." if layer < Ld else f"moe_layers.{layer - Ld}."
        sd[pre + "input_norm"] = hf(layer, "input_layernorm")
        sd[pre + "post_norm"] = hf(layer, "post_attention_layernorm")
        sd[pre + "kv_norm"] = hf(layer, "self_attn.kv_a_layernorm")
        sd[pre + "w_dkv"] = hf(layer, "self_attn.kv_a_proj_with_mqa", True)
        sd[pre + "wo"] = hf(layer, "self_attn.o_proj", True)
        if cfg.q_lora_rank:
            sd[pre + "w_dq"] = hf(layer, "self_attn.q_a_proj", True)
            sd[pre + "q_norm"] = hf(layer, "self_attn.q_a_layernorm")
            sd[pre + "w_uq"] = hf(layer, "self_attn.q_b_proj", True)
        else:
            sd[pre + "w_q"] = hf(layer, "self_attn.q_proj", True)
        kv_b = hf(layer, "self_attn.kv_b_proj", True).reshape(dc, H, dn + dv)
        sd[pre + "w_kb"], sd[pre + "w_vb"] = kv_b[..., :dn], kv_b[..., dn:]
        if layer < Ld:
            for name in ("gate", "up", "down"):
                sd[pre + name] = hf(layer, f"mlp.{name}_proj", True)
            continue
        sd[pre + "router"] = hf(layer, "mlp.gate", True)
        for name in ("gate", "up", "down"):
            sd[pre + f"w_{name}"] = torch.stack([hf(layer, f"mlp.experts.{e}.{name}_proj", True)
                                                 for e in range(cfg.n_routed_experts)])
            sd[pre + f"shared_{name}"] = hf(layer, f"mlp.shared_experts.{name}_proj", True)
    return sd


def prefill_logits(torch, model, toks: list[int]):
    """The last row's logits of one prefill chunk of ``toks`` on fresh
    pages of 16 rows."""
    dev, n, ps = model.device, len(toks), 16
    pages = -(-n // ps)
    kv = model.init_kv_cache(pages + 1, ps)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)
    positions = torch.arange(n, dtype=torch.int32, device=dev)
    logits, _ = model.prefill(kv, torch.tensor(toks, dtype=torch.int32, device=dev), positions, table,
                              torch.ones(n, dtype=torch.bool, device=dev), n - 1)
    return logits


def phase_checkpoint_serve(torch, gpu_name: str, kernels: dict, forbidden: dict, k8) -> dict:
    """HF checkpoint directories, written by the port's tool with the port's
    safetensors writer (seeded bf16 weights drawn on the card) into a
    temporary directory: TinyLlama-1.1B geometry (the reference tool's
    default, no tokenizer: the byte tokenizer serves it) and DeepSeek-V2-Lite
    width at 2 layers (one dense, one MoE) in DeepSeek's names. Each loads
    through ``load_model(dir)`` in bf16 and in int8_wo (load seconds and
    GB/s of the file), and its prefill logits on 100 seeded tokens must
    equal, bit for bit, those of a model built from the same tensors here
    (``hf_state``). Then ``run <TinyLlama dir> --in http --out torch`` and
    the same with ``--quantize int8_wo`` serve the folded workload's 16
    prompts over HTTP (``stream_completions``): ``kernels`` (K3a, K3b) must
    launch, and ``k8`` too under int8_wo, nothing of ``forbidden`` (nor
    ``k8`` in bf16), and no capture after the background warmup. Returns
    {path: {name: launches}}."""
    import dataclasses
    import tempfile

    from dynamo_tpu_torch.launch import run
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools import make_hf_checkpoint as tool
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS, folded_serve_requests

    rng = np.random.default_rng(13)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="hf-ckpt-") as tmp:
        for what, deepseek, geometry in (("TinyLlama-1.1B", False, None),
                                         ("DeepSeek-V2-Lite width, 2 layers", True, {"num_hidden_layers": 2})):
            t0 = time.monotonic()
            path = tool.make_checkpoint(Path(tmp) / ("deepseek" if deepseek else "tinyllama"), geometry,
                                        deepseek=deepseek, device="cuda")
            nbytes = (path / "model.safetensors").stat().st_size
            config = json.loads((path / "config.json").read_text())
            log(f"checkpoint {what}: the port's tool wrote {nbytes / 1e9:.3f} GB of bf16 safetensors in "
                f"{time.monotonic() - t0:.1f} s (tokenizer.json: {(path / 'tokenizer.json').exists()})")
            tensors = tool.checkpoint_tensors(config, 0, "cuda")
            toks = rng.integers(0, config["vocab_size"], 100).tolist()
            for quantize in (None, "int8_wo"):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                model = load_model(str(path), device="cuda", quantize=quantize)
                torch.cuda.synchronize()
                load_s = time.monotonic() - t0
                direct = type(model)(dataclasses.replace(model.config), device="cuda")
                direct.load_state_dict(hf_state(torch, tensors, model.config))
                direct.quantize_()
                a, b = prefill_logits(torch, model, toks), prefill_logits(torch, direct, toks)
                if not torch.equal(a, b):
                    raise AssertionError(f"checkpoint {what} {quantize or 'bf16'}: logits of the loaded model differ "
                                         f"from the directly built one by {(a - b).abs().max().item()}")
                log(f"checkpoint {what} {quantize or 'bf16'} [{gpu_name}]: load_model(dir) {load_s:.2f} s, "
                    f"{nbytes / load_s / 1e9:.2f} GB/s of the file; prefill logits bit-equal to the model built "
                    f"from the same tensors ({type(model).__name__}, {sum(p.dtype == torch.int8 for p in model.parameters())} "
                    f"int8 weights)")
                del model, direct
                torch.cuda.empty_cache()
            del tensors
            if deepseek:
                continue
            requests = folded_serve_requests()
            for quantize in (None, "int8_wo"):
                argv = ["run", str(path), "--in", "http", "--out", "torch", "--http-port", "0"]
                argv += ["--quantize", quantize] if quantize else []
                args = run.build_parser().parse_args(argv)
                label = "checkpoint serve" + (" int8_wo" if quantize else "")
                want = dict(kernels, K8=k8) if quantize else kernels
                shun = forbidden if quantize else dict(forbidden, K8=k8)
                with http_engine(args) as (engine, port, on_loop):
                    if engine.config.page_size != 16 or engine.config.model_id != str(path):
                        raise AssertionError(f"{label}: engine {engine.config.model_id} at page size "
                                             f"{engine.config.page_size}")
                    warm_s = wait_background_warmup(engine, on_loop, label)
                    captures = engine.runner.compile_monitor.compiles
                    launches, wall, client_ttft, _ = stream_completions(port, requests, want, shun, label)
                    if engine.runner.compile_monitor.compiles != captures:
                        raise AssertionError(f"{label}: graph captures inside the timed requests")
                n_out = len(requests) * MAX_TOKENS
                log(f"{label} [{gpu_name}]: `run {path.name} --in http --out torch"
                    + (f" --quantize {quantize}" if quantize else "") + f"`: {n_out / wall:.1f} output tok/s, "
                    f"wall {wall:.2f} s, client TTFT p50 {np.median(client_ttft) * 1e3:.1f} ms; launches "
                    + " ".join(f"{k} {v}" for k, v in launches.items()) + f" (none of {', '.join(shun)}); "
                    f"background warmup ended {warm_s:.1f} s after start; {graphs_line(engine)}")
                runs[label] = launches
                del engine
                torch.cuda.empty_cache()
    return runs


def phase_graph_vs_eager(torch, rng, gpu_name: str) -> None:
    """Llama-3-8B and DeepSeek-V2-Lite at full width, 2 layers, bf16: one
    prefill (Llama: one packed call of three prompts; V2-Lite: a call a
    prompt) and one 8-step decode window of those slots, replayed from the
    runner's graphs (captured by its warmup first, so the calls capture
    nothing) and run through its eager bodies from the same state
    (``tools/checks.py graph_against_eager``): the greedy tokens and the
    written KV pages must be equal, the window's last-step logits within
    TOL["bf16"]."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.checks import graph_against_eager, same_run, tol_share
    from dynamo_tpu_torch.tools.workload import DEEPSEEK_V2_LITE, LLAMA3_8B

    for what, family, geometry in (("Llama-3-8B", "tiny", LLAMA3_8B), ("DeepSeek-V2-Lite", "tiny-mla",
                                                                       DEEPSEEK_V2_LITE)):
        model_id = f"{family}:" + json.dumps(dict(geometry, num_layers=2))
        config = EngineConfig(model_id=model_id, device="cuda", page_size=16, num_pages=512, max_seqs=4,
                              max_model_len=1024)
        runner = ModelRunner(config, load_model(model_id, device="cuda"))
        prompts = [rng.integers(0, geometry["vocab_size"], n).tolist() for n in (37, 100, 211)]
        t0 = time.monotonic()
        got = graph_against_eager(runner, prompts)
        g, e = got["graph"], got["eager"]
        if got["captures"]:
            raise AssertionError(f"graph vs eager, {what}: {got['captures']} captures in the graph run")
        differ = same_run(g, e)
        if differ:
            raise AssertionError(f"graph vs eager, {what}: {differ} differ; tokens {g['first']} "
                                 f"{g['window'].T.tolist()} / {e['first']} {e['window'].T.tolist()}")
        err, share = tol_share(g["logits"], e["logits"], "bf16")
        if not share <= 1:
            raise AssertionError(f"graph vs eager, {what}: last-step logits off by {err} (share {share} of TOL)")
        n_pages = sum(-(-(len(p) + 2 * config.decode_steps) // config.page_size) for p in prompts)
        log(f"graph vs eager, {what} (2 layers, full width, bf16) [{gpu_name}]: prefill tokens {g['first'].tolist()} "
            f"and {g['window'].shape[0]}-step window tokens equal; the prefill with penalties, min_tokens and "
            f"logprobs, the extras window and the logprobs window: tokens, logprobs and penalty state equal; "
            f"{n_pages} written KV pages a layer bit-equal, "
            f"last-step logits max |diff| {err:.3g} (share {share:.3f} of TOL bf16); "
            f"{runner.compile_monitor.compiles} captures ({time.monotonic() - t0:.1f} s)")
        del runner
        torch.cuda.empty_cache()


def phase_cli(torch, rng) -> None:
    """``python -m dynamo_tpu_torch.launch.run run 'tiny:{...}' --in http
    --out torch`` as a subprocess on a free port, over a 2-layer f32 model
    of Llama-3-8B's width with vocab_size 256 (the byte vocabulary of the
    tiny card's ByteTokenizer, so every greedy token is text): /ready within
    300 s, three greedy completions whose text must equal the bytes of
    naive_greedy on the same seeded weights (decoded as the service's
    detokenizer does: invalid bytes replaced, a trailing incomplete
    character held back), then SIGINT, after which the process must exit
    with code 0 within 60 s."""
    import signal
    import socket
    import subprocess
    import tempfile

    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.profile_http import http_call
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    steps = 16
    model_id = "tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=2, dtype="f32", vocab_size=256))
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 21, 40)]  # + 16 tokens: inside the card's 64
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "run", model_id, "--in", "http", "--out", "torch",
           "--http-port", str(port)]
    t0 = time.monotonic()
    with tempfile.TemporaryFile() as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)
        try:
            while True:
                try:
                    if http_call(port, "GET", "/ready")[0] == 200:
                        break
                except OSError:
                    pass
                if proc.poll() is not None or time.monotonic() - t0 > 300:
                    err.seek(0)
                    raise AssertionError(f"cli: not ready (exit {proc.poll()}): {err.read()[-2000:]!r}")
                time.sleep(0.5)
            ready_s = time.monotonic() - t0
            model = load_model(model_id, device="cuda")  # the subprocess's weights: the same seed and device
            for i, p in enumerate(prompts):
                status, body = http_call(port, "POST", "/v1/completions",
                                         {"prompt": p, "max_tokens": steps, "temperature": 0})
                got = json.loads(body)["choices"][0]["text"] if status == 200 else body
                want = bytes(naive_greedy(torch, model, p, steps)).decode("utf-8", errors="replace").rstrip("\ufffd")
                if got != want:
                    raise AssertionError(f"cli request {i}: text {got!r} != naive greedy {want!r}")
            del model
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
            if rc != 0:
                err.seek(0)
                raise AssertionError(f"cli: exit code {rc} after SIGINT: {err.read()[-2000:]!r}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"cli: `run {model_id[:24]}... --in http --out torch` ready in {ready_s:.1f} s; {len(prompts)} greedy "
        f"completions x {steps} tokens equal naive_greedy's bytes; exit 0 on SIGINT")
    torch.cuda.empty_cache()


def dense_weight(w):
    """A weight as the dense forwards read it: an int8_wo weight
    dequantized to f32 (its codes times its scales), anything else as it
    is."""
    from dynamo_tpu_torch.quant.int8 import QuantizedLinear, dequantize_int8

    return dequantize_int8(w) if isinstance(w, QuantizedLinear) else w


def naive_logits(torch, model, toks: list[int]):
    """Last-row logits of a dense no-paging forward (attention_with_positions
    on the whole sequence) on the model's own weights (int8_wo weights
    dequantized, ``dense_weight``). With an int8 KV cache in the model's
    config, every K/V row goes through the port's quantize_kv_rows and back
    before it is attended, as the pool stores it."""
    from dynamo_tpu_torch.ops.attention import attention_with_positions
    from dynamo_tpu_torch.ops.norms import rms_norm
    from dynamo_tpu_torch.ops.rotary import apply_rope
    from dynamo_tpu_torch.quant.kv import dequantize_rows, quantize_kv_rows

    c = model.config
    with torch.no_grad():
        ids = torch.tensor(toks, device=model.device)
        pos = torch.arange(len(toks), device=model.device, dtype=torch.int32)
        h = model.embed[ids]
        for lp in model.layers:
            x = rms_norm(h, lp.input_norm, c.rms_norm_eps)
            q = apply_rope((x @ dense_weight(lp.wq)).reshape(len(toks), -1, c.head_dim), pos, c.rope_theta)
            k = apply_rope((x @ dense_weight(lp.wk)).reshape(len(toks), -1, c.head_dim), pos, c.rope_theta)
            v = (x @ dense_weight(lp.wv)).reshape(len(toks), -1, c.head_dim)
            if c.kv_quantized:
                k = dequantize_rows(*quantize_kv_rows(k))
                v = dequantize_rows(*quantize_kv_rows(v))
            h = h + attention_with_positions(q, k, v, pos).reshape(len(toks), -1) @ dense_weight(lp.wo)
            x = rms_norm(h, lp.post_norm, c.rms_norm_eps)
            gated = torch.nn.functional.silu(x @ dense_weight(lp.gate)) * (x @ dense_weight(lp.up))
            h = h + gated @ dense_weight(lp.down)
        return model._unembed(h[-1:])[0]


def naive_greedy(torch, model, prompt: list[int], steps: int, logits_fn=None) -> list[int]:
    """Greedy tokens of the dense forward (``naive_logits``, or
    ``logits_fn(toks)``), recomputed on the whole sequence every step."""
    logits_fn = logits_fn or (lambda toks: naive_logits(torch, model, toks))
    toks, out = list(prompt), []
    for _ in range(steps):
        nxt = int(logits_fn(toks).argmax())
        toks.append(nxt)
        out.append(nxt)
    return out


def naive_featured(torch, logits_fn, prompt: list[int], steps: int, penalties: dict | None = None,
                   eos: tuple = (), min_tokens: int = 0) -> list[int]:
    """The greedy loop of the dense forward with the reference's penalties
    and min_tokens written out: repetition divides a positive / multiplies a
    negative logit of every token seen in prompt or output, then each output
    token's logit loses frequency x its count, then presence once; while
    fewer than ``min_tokens`` tokens are out, the EOS ids get -1e30; EOS
    stops the loop once more than ``min_tokens`` are out."""
    toks, out, counts = list(prompt), [], {}
    for _ in range(steps):
        logits = logits_fn(toks).float().clone()
        if penalties:
            seen = torch.tensor(sorted(set(toks)), device=logits.device)
            rep = penalties["repetition_penalty"]
            raw = logits[seen]
            logits[seen] = torch.where(raw > 0, raw / rep, raw * rep)
            for t, n in counts.items():
                logits[t] = logits[t] - penalties["frequency_penalty"] * n
                logits[t] = logits[t] - penalties["presence_penalty"]
        if len(out) < min_tokens:
            for t in eos:
                logits[t] = logits[t] + -1e30
        nxt = int(logits.argmax())
        out.append(nxt)
        toks.append(nxt)
        counts[nxt] = counts.get(nxt, 0) + 1
        if nxt in eos and len(out) > min_tokens:
            break
    return out


def expected_cached(page_size: int, served: list, prompt: list[int]) -> int:
    """The prefix-cache hit the reference's allocation rule gives ``prompt``
    after ``served`` [(prompt, generated tokens)]: each served sequence has
    registered its prompt's full blocks and, one token late, the blocks its
    decoding filled; the hit is the leading chain of registered blocks, less
    the last when it would cover the whole prompt."""
    from dynamo_tpu_torch.llm.tokens import TokenSequence

    registered = set()
    for p, gen in served:
        blocks = TokenSequence(list(p) + list(gen), page_size).blocks
        n = max(len(p) // page_size, (len(p) + len(gen) - 1) // page_size)
        registered |= {b.sequence_hash for b in blocks[:n]}
    hits = 0
    for block in TokenSequence(prompt, page_size).blocks:
        if block.sequence_hash not in registered:
            break
        hits += 1
    if hits and hits * page_size >= len(prompt):
        hits -= 1
    return hits * page_size


async def serve_outputs(engine, requests):
    """Run ``requests`` concurrently through a started engine; returns
    ({rid: {"tokens", "finish", "ttft", "cached", "logprobs", "top"}},
    wall_s)."""

    async def one(req):
        t0 = time.monotonic()
        got = dict(tokens=[], finish=None, ttft=None, cached=None, logprobs=[], top=[])
        async for out in engine.generate(req):
            if got["cached"] is None:
                got["cached"] = out.cached_tokens
            if out.token is not None:
                if got["ttft"] is None:
                    got["ttft"] = time.monotonic() - t0
                got["tokens"].append(out.token)
                got["logprobs"].append(out.logprob)
                got["top"].append(out.top_logprobs)
            got["finish"] = out.finish_reason
        return req.request_id, got

    t0 = time.monotonic()
    results = dict(await asyncio.gather(*(one(r) for r in requests)))
    return results, time.monotonic() - t0


def prefix_rounds(torch, config, model, logits_fn, prompts: list, steps: int, what: str) -> str:
    """Three prompts that share a prefix through one engine: the first
    alone, then the other two, then all three. Every request's
    ``cached_tokens`` must equal ``expected_cached`` (a zero where a hit is
    due fails) and its greedy tokens the dense forward's. Returns a
    summary."""
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest

    want = [naive_greedy(torch, model, p, steps, logits_fn) for p in prompts]

    async def run():
        engine = AsyncTorchEngine(config, model=model)
        await engine.start()
        try:
            served, rounds = [], []
            for r, idx in enumerate(([0], [1, 2], [0, 1, 2])):
                expect = {i: expected_cached(config.page_size, served, prompts[i]) for i in idx}
                reqs = [EngineRequest(f"pfx-{r}-{i}", prompts[i], SamplingParams(max_tokens=steps)) for i in idx]
                results, _ = await serve_outputs(engine, reqs)
                for i in idx:
                    got = results[f"pfx-{r}-{i}"]
                    if got["cached"] != expect[i]:
                        raise AssertionError(f"{what} prefix round {r} request {i}: cached_tokens {got['cached']}, "
                                             f"the allocation rule gives {expect[i]}")
                    if got["tokens"] != want[i]:
                        raise AssertionError(f"{what} prefix round {r} request {i}: engine {got['tokens']} != "
                                             f"naive {want[i]}")
                    served.append((prompts[i], got["tokens"]))
                rounds.append([expect[i] for i in idx])
            return rounds
        finally:
            await engine.shutdown()

    rounds = asyncio.run(run())
    return f"cached_tokens by round {rounds}"


def phase_features_vs_naive(torch, rng) -> None:
    """2 layers, f32, against the dense forward:

      - prefix: three prompts sharing a 160-token prefix (``prefix_rounds``)
        on Llama-3-8B geometry, on TinyLlama geometry with the int8 cache
        (K3a / K3b over a cached prefix), and on V2-Lite geometry against
        the non-absorbed forward (K5 / K6);
      - on Llama-3-8B geometry, one batch of: repetition 1.3, frequency 0.5,
        presence 0.5 (``naive_featured``); min_tokens 6 past an EOS id the
        plain greedy stream emits second; and logprobs 20, whose chosen and
        top-20 logprobs must lie within 1e-4 of the dense forward's
        log-softmax (each returned id's, and the sorted values)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.engine.sampling import LOGPROBS_K, SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.workload import DEEPSEEK_V2_LITE, LLAMA3_8B, PENALTIES, TINYLLAMA_1_1B

    steps = 16
    for what, family, geometry, kv in (("Llama-3-8B geometry", "tiny", LLAMA3_8B, None),
                                       ("TinyLlama geometry, int8 KV", "tiny", TINYLLAMA_1_1B, "int8"),
                                       ("V2-Lite geometry", "tiny-mla", DEEPSEEK_V2_LITE, None)):
        cfg = dict(geometry, num_layers=2, dtype="f32")
        if family == "tiny-mla":
            cfg["moe_capacity_factor"] = 11.0  # every expert holds every token (phase_mla_vs_naive)
        config = EngineConfig(model_id=f"{family}:" + json.dumps(cfg), device="cuda", page_size=16, num_pages=256,
                              max_seqs=4, max_model_len=1024, decode_steps=4, kv_cache_dtype=kv)
        model = load_model(config.model_id, device="cuda", kv_cache_dtype=kv)
        shared = rng.integers(0, cfg["vocab_size"], 160).tolist()
        prompts = [shared + rng.integers(0, cfg["vocab_size"], n).tolist() for n in (37, 64, 85)]
        if family == "tiny-mla":
            with torch.no_grad():
                summary = prefix_rounds(torch, config, model, lambda t: mla_naive_logits(torch, model, t), prompts,
                                        steps, what)
        else:
            summary = prefix_rounds(torch, config, model, None, prompts, steps, what)
        log(f"{what} prefix vs naive forward (2 layers, f32): {summary}; greedy tokens identical")
        if family != "tiny" or kv is not None:
            del model
            torch.cuda.empty_cache()
            continue

        def logits_fn(toks):
            return naive_logits(torch, model, toks)

        p_pen, p_min, p_lp = (rng.integers(0, cfg["vocab_size"], n).tolist() for n in (120, 57, 300))
        eos = naive_greedy(torch, model, p_min, 2)[1]
        want_pen = naive_featured(torch, logits_fn, p_pen, steps, penalties=PENALTIES)
        want_min = naive_featured(torch, logits_fn, p_min, steps, eos=(eos,), min_tokens=6)
        requests = [
            EngineRequest("pen", p_pen, SamplingParams(max_tokens=steps, **PENALTIES)),
            EngineRequest("min", p_min, SamplingParams(max_tokens=steps, min_tokens=6), eos_token_ids=(eos,)),
            EngineRequest("lp", p_lp, SamplingParams(max_tokens=steps), logprobs=LOGPROBS_K),
        ]

        async def run():
            engine = AsyncTorchEngine(config, model=model)
            await engine.start()
            try:
                return (await serve_outputs(engine, requests))[0]
            finally:
                await engine.shutdown()

        got = asyncio.run(run())
        if got["pen"]["tokens"] != want_pen:
            raise AssertionError(f"{what} penalties: engine {got['pen']['tokens']} != naive {want_pen}")
        if got["min"]["tokens"] != want_min or eos in want_min[:6]:
            raise AssertionError(f"{what} min_tokens: engine {got['min']['tokens']} != naive {want_min}")
        lp, toks, worst = got["lp"], list(p_lp), 0.0
        for k, tok in enumerate(lp["tokens"]):
            ref = torch.log_softmax(naive_logits(torch, model, toks).float(), -1)
            if tok != int(ref.argmax()):
                raise AssertionError(f"{what} logprobs request step {k}: token {tok} != naive {int(ref.argmax())}")
            ids = [i for i, _ in lp["top"][k]]
            vals = torch.tensor([v for _, v in lp["top"][k]], device=ref.device)
            errs = [abs(lp["logprobs"][k] - ref[tok].item()), (vals - ref[ids]).abs().max().item(),
                    (vals - ref.topk(LOGPROBS_K).values).abs().max().item()]
            worst = max(worst, *errs)
            if len(ids) != LOGPROBS_K or max(errs) > 1e-4:
                raise AssertionError(f"{what} logprobs step {k}: {len(ids)} alternatives, errors {errs}")
            toks.append(tok)
        log(f"{what} features vs naive forward (2 layers, f32): penalties (repetition 1.3, frequency 0.5, presence "
            f"0.5) and min_tokens 6 past EOS id {eos} ({len(want_min)} tokens, "
            f"{'stopped' if len(want_min) < steps else 'no stop'}) tokens identical; logprobs 20 x {steps} steps "
            f"within {worst:.3g} of the log-softmax (limit 1e-4)")
        del model
        torch.cuda.empty_cache()


def phase_engine_vs_naive(torch, rng, what: str, geometry: dict, kv_cache_dtype: str | None = None,
                          decode_kernel: str | None = None, launcher=None, quantize: str | None = None) -> None:
    """``geometry`` at 2 layers in f32: the engine's greedy tokens (3
    requests x 16) must equal naive_greedy's. ``decode_kernel``: the run's
    DYNTPU_DECODE_KERNEL; ``quantize``: int8_wo weights (K8's f32
    activations), held to the dense forward over the dequantized weights;
    ``launcher`` must then have launched."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.registry import load_model

    steps = 16
    cfg = dict(geometry, num_layers=2, dtype="f32", **({"quantize": quantize} if quantize else {}))
    config = EngineConfig(
        model_id="tiny:" + json.dumps(cfg), device="cuda", page_size=16, num_pages=256,
        max_seqs=4, max_model_len=1024, decode_steps=4, kv_cache_dtype=kv_cache_dtype, quantize=quantize,
    )
    model = load_model(config.model_id, device="cuda", kv_cache_dtype=kv_cache_dtype)
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (100, 37, 600)]
    requests = [
        EngineRequest(f"naive-{i}", p, SamplingParams(temperature=0.0, max_tokens=steps))
        for i, p in enumerate(prompts)
    ]
    if launcher is not None:
        launcher.launches = 0
    with decode_kernel_env(decode_kernel):
        results, *_ = asyncio.run(serve(config, requests, model=model))
    if launcher is not None and launcher.launches <= 0:
        raise AssertionError(f"{what} with {decode_kernel or quantize}: its kernel never launched")
    for i, p in enumerate(prompts):
        got = results[f"naive-{i}"][0]
        want = naive_greedy(torch, model, p, steps)
        if got != want:
            raise AssertionError(f"{what} request {i}: engine {got} != naive {want}")
    log(f"{what} engine vs naive forward (2 layers, f32, {kv_cache_dtype or 'f32'} KV"
        + (f", DYNTPU_DECODE_KERNEL={decode_kernel}, {launcher.launches} launches" if decode_kernel else "")
        + (f", {quantize} weights, dense forward over the dequantized weights, K8 {launcher.launches} launches"
           if quantize else "")
        + f"): {len(prompts)} requests x {steps} greedy tokens identical")
    del model
    torch.cuda.empty_cache()


def mla_naive_logits(torch, model, toks: list[int]):
    """Last-row logits of a dense NON-absorbed MLA forward on the model's own
    weights (tests/test_deepseek_mla.py's naive_forward in torch): per-head
    K = [W_kb c ; k_rope] and V = W_vb c materialized from the latents,
    standard causal attention, and each routed expert run on the tokens
    whose top-k chose it (no capacity, no dispatch slots); int8_wo weights
    dequantized (``dense_weight``)."""
    from dynamo_tpu_torch.ops.norms import rms_norm
    from dynamo_tpu_torch.ops.rotary import apply_rope

    c = model.config
    T, H = len(toks), c.num_heads
    dn, dr, dc = c.qk_nope_head_dim, c.qk_rope_head_dim, c.kv_lora_rank
    dev = model.device
    pos = torch.arange(T, device=dev, dtype=torch.int32)
    silu = torch.nn.functional.silu
    h = model.embed[torch.tensor(toks, device=dev)]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    for lp in model.layers():
        x = rms_norm(h, lp.input_norm, c.rms_norm_eps)
        if c.q_lora_rank:
            x_q = rms_norm(x @ dense_weight(lp.w_dq), lp.q_norm, c.rms_norm_eps) @ dense_weight(lp.w_uq)
        else:
            x_q = x @ dense_weight(lp.w_q)
        q = x_q.reshape(T, H, dn + dr)
        q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], pos, c.rope_theta)], dim=-1)
        ckv = x @ dense_weight(lp.w_dkv)
        latent = rms_norm(ckv[:, :dc], lp.kv_norm, c.rms_norm_eps)
        k_rope = apply_rope(ckv[:, None, dc:], pos, c.rope_theta)
        k = torch.cat([torch.einsum("sc,chn->shn", latent, lp.w_kb), k_rope.expand(T, H, dr)], dim=-1)
        v = torch.einsum("sc,chv->shv", latent, lp.w_vb)
        s = torch.einsum("thd,shd->hts", q.float(), k.float()) / (dn + dr) ** 0.5
        s = torch.where(causal[None], s, -1e30)
        a = torch.einsum("hts,shv->thv", torch.softmax(s, -1), v.float()).to(c.dtype)
        h = h + a.reshape(T, -1) @ dense_weight(lp.wo)
        x = rms_norm(h, lp.post_norm, c.rms_norm_eps)
        W = {name: dense_weight(getattr(lp, name)) for name in ("w_gate", "w_up", "w_down", "shared_gate",
                                                                "shared_up", "shared_down", "gate", "up", "down")
             if hasattr(lp, name)}
        if lp.moe:
            probs = torch.softmax(x.float() @ lp.router.float(), dim=-1)
            top_w, top_i = torch.topk(probs, c.num_experts_per_tok, dim=-1)
            if c.norm_topk_prob:
                top_w = top_w / top_w.sum(-1, keepdim=True)
            routed = torch.zeros_like(h, dtype=torch.float32)
            for e in range(c.n_routed_experts):
                chose = top_i == e  # [T, K]
                rows = chose.any(-1).nonzero()[:, 0]
                if rows.numel():
                    xe = x[rows]
                    y = (silu(xe @ W["w_gate"][e]) * (xe @ W["w_up"][e])) @ W["w_down"][e]
                    routed[rows] += (top_w * chose).sum(-1)[rows, None] * y.float()
            shared = (silu(x @ W["shared_gate"]) * (x @ W["shared_up"])) @ W["shared_down"]
            h = h + shared + c.routed_scaling_factor * routed.to(c.dtype)
        else:
            h = h + (silu(x @ W["gate"]) * (x @ W["up"])) @ W["down"]
    return model._unembed(h[-1:])[0]


def phase_mla_vs_naive(torch, rng, quantize: str | None = None, launchers: dict | None = None) -> None:
    """V2-Lite geometry at 2 layers in f32 (capacity factor 11): the
    engine's greedy tokens (3 requests x 16) must equal the dense
    non-absorbed forward's; ``quantize``: int8_wo weights, and each of
    ``launchers`` must have launched."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.workload import DEEPSEEK_V2_LITE

    steps = 16
    # capacity factor 11 >= E/K = 64/6: every expert holds every token, so
    # nothing drops whatever the batch, and the capacity dispatch equals the
    # plain top-k mixture
    cfg = dict(DEEPSEEK_V2_LITE, num_layers=2, dtype="f32", moe_capacity_factor=11.0,
               **({"quantize": quantize} if quantize else {}))
    config = EngineConfig(
        model_id="tiny-mla:" + json.dumps(cfg), device="cuda",
        page_size=16, num_pages=256, max_seqs=4, max_model_len=1024, decode_steps=4, quantize=quantize,
    )
    model = load_model(config.model_id, device="cuda")
    prompts = [rng.integers(0, cfg["vocab_size"], n).tolist() for n in (100, 37, 600)]
    requests = [
        EngineRequest(f"mla-naive-{i}", p, SamplingParams(temperature=0.0, max_tokens=steps))
        for i, p in enumerate(prompts)
    ]
    launchers = launchers or {}
    for fn in launchers.values():
        fn.launches = 0
    results, *_ = asyncio.run(serve(config, requests, model=model))
    if any(fn.launches <= 0 for fn in launchers.values()):
        raise AssertionError(f"MLA {quantize}: a kernel never launched: "
                             + " ".join(f"{k} {fn.launches}" for k, fn in launchers.items()))
    with torch.no_grad():
        for i, p in enumerate(prompts):
            got = results[f"mla-naive-{i}"][0]
            want = naive_greedy(torch, model, p, steps, lambda t: mla_naive_logits(torch, model, t))
            if got != want:
                raise AssertionError(f"MLA request {i}: engine {got} != naive {want}")
    log(f"MLA engine vs naive non-absorbed forward (2 layers, f32, capacity factor 11"
        + (f", {quantize} weights, dense forward over the dequantized weights, launches "
           + " ".join(f"{k} {fn.launches}" for k, fn in launchers.items()) if quantize else "")
        + f"): {len(prompts)} requests x {steps} greedy tokens identical")
    del model
    torch.cuda.empty_cache()


def phase_instruments(torch, twins: dict) -> dict:
    """Both profilers' ``main`` at their defaults (tools/profile_attn.py,
    tools/profile_prefill.py): every profile_attn variant must pass its
    numerics gate and its check against its plain version, and be timed;
    profile_prefill's K2 and K7a must pass theirs. ``twins`` ({name: launcher}) are counted over
    the phase and must each have launched. Returns {"launches", "attn",
    "prefill"}."""
    from dynamo_tpu_torch.tools import profile_attn, profile_prefill

    for fn in twins.values():
        fn.launches = 0
    attn = profile_attn.main([])
    if attn["failed"] or set(attn["us_per_call"]) != set(profile_attn.VARIANTS):
        raise AssertionError(f"profile_attn: failed {attn['failed']}, timed {sorted(attn['us_per_call'])}")
    pre = profile_prefill.main([])
    if pre["failed"]:
        raise AssertionError(f"profile_prefill: failed {pre['failed']}")
    launches = {name: fn.launches for name, fn in twins.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"instruments: a twin never launched: {launches}")
    log("instruments: profile_attn variants " + ", ".join(f"{k} {v:.1f} us" for k, v in attn["us_per_call"].items())
        + f"; profile_prefill K2 {pre['attn_kernel_ab']['attn_us_per_layer']:.1f} us, K7a "
        f"{pre['attn_kernel_ab']['dma_floor_us_per_layer']:.1f} us; launches "
        + " ".join(f"{k} {v}" for k, v in launches.items()))
    torch.cuda.empty_cache()
    return dict(launches=launches, attn=attn, prefill=pre)


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- speculative decoding

SPEC_K = 4  # drafts a round: the verify pass feeds k + 1 rows a lane


def verify_anchors(n: int) -> list[int]:
    """Verify anchors at the serve workload's shapes: the first ``n``
    prompts' lengths plus half the output (the middle of a stream)."""
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS, serve_requests

    return [len(r.token_ids) + MAX_TOKENS // 2 for r in serve_requests()[:n]]


def check_mla_verify(torch, dev, rng) -> dict:
    """K5 at the MLA verify's call: 16 lanes of k + 1 = 5 query rows (80
    rows, 16 heads, latent 576, d_c 512, bf16 pages, page size 16), each row
    with its lane's table (the table repeated k + 1 times) and its own
    position, at the serve workload's anchors; held to the plain version,
    timed beside it and one SDPA call over the gathered context (a 5-row
    causal mask a lane). The bound reads each lane's rows ONCE (K5 reads
    them k + 1 times, once a query row) and counts the rows' operations."""
    from dynamo_tpu_torch.ops import attention as plain
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_decode_attention_kernel as k5

    B, T, H, L, dc, ps = 16, SPEC_K + 1, MLA_H, MLA_LATENT, MLA_DC, 16
    anchors = np.array(verify_anchors(B))
    max_pages = -(-int(anchors.max() + T) // ps)
    pt, P = mla_tables(rng, anchors + T, ps, max_pages)
    pos = (anchors[:, None] + np.arange(T)[None]).astype(np.int32)
    pt_t = torch.from_numpy(np.repeat(pt, T, axis=0)).to(dev)
    pos_t = torch.from_numpy(pos.reshape(B * T)).to(dev)
    q = torch.randn((B * T, H, L), device=dev) / L**0.5
    pages = torch.randn((P, ps, L), device=dev).to(torch.bfloat16)
    got = k5(q, pages, pt_t, pos_t, dc)
    ref = plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc)
    held = held_to_plain(f"K5 MLA verify ({B} lanes x {T} rows)", "f32 q / bf16 pages", got, ref, tol="f32")
    kt = timed(lambda: k5(q, pages, pt_t, pos_t, dc), 50)
    plain_ms = cuda_ms(lambda: plain.paged_mla_decode_attention(q, pages, pt_t, pos_t, dc), 5)
    S = max_pages * ps
    lane_pt = torch.from_numpy(pt).to(dev)
    ctx = plain.gather_pages(pages, lane_pt)[:, None]  # [B, 1, S, L]
    vc = ctx[..., :dc].contiguous()
    qs = q.to(pages.dtype).reshape(B, T, H, L).permute(0, 2, 1, 3)  # [B, H, T, L]
    mask = (torch.arange(S, device=dev)[None, None, :] <= torch.from_numpy(pos).to(dev)[:, :, None].long())[:, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ctx, vc, attn_mask=mask, scale=1.0,
                                                                enable_gqa=True)

    lt = timed(sdpa, 20, "library_")
    rows = int((anchors + T).sum())  # each lane's context rows, read once
    pairs = int((pos + 1).sum())
    nbytes = rows * L * pages.element_size() + q.numel() * 4 + B * T * H * dc * 4 + pt.nbytes + pos.nbytes
    flops = 2 * H * (L + dc) * pairs
    b_ms, b_by = bound(nbytes, flops, "bf16")
    ms = kt["ms"]
    log(f"K5 MLA verify ({B} lanes x {T} rows, anchors {int(anchors.min())}-{int(anchors.max())}) f32 q / bf16 "
        f"pages: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lt['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes / 1e6:.1f} MB with each lane's rows read once, K5 reads them {T} times: "
        f"{rows * L * pages.element_size() * T / 1e6:.1f} MB); {b_ms / ms:.3f} of the bound")
    return dict(bf16=dict(**held, **kt, plain_ms=plain_ms, **lt, bound_ms=b_ms, bound_by=b_by))


def check_verify_shapes(torch, dev, rng) -> dict:
    """K2 and K5 at the verify pass's shapes, bf16: K2 over 15 lanes of k + 1
    = 5 rows at the serve workload's anchors and a pad lane (16 lanes, Llama-3-8B
    heads, page size 16, the serve engine's 132-page tables), K5 as
    ``check_mla_verify``."""
    return {
        "K2": check_prefill(torch, dev, rng, "K2", ps=16, T=SPEC_K + 1, starts=tuple(verify_anchors(15)),
                            max_pages=132, mixes=MIXES[1:2]),
        "K5": check_mla_verify(torch, dev, rng),
    }


def spec_tally(engine, launcher) -> int:
    """Launches of ``launcher`` the engine's verify graphs replayed (each
    graph's capture tally times its replays)."""
    return sum(dict(e.tally).get(launcher, 0) * e.replays
               for key, e in engine.runner.graphs.entries.items() if key[0] == "verify")


def spec_serve(torch, config, rounds: list, kernels: dict, forbidden: dict) -> dict:
    """Serve each request list of ``rounds`` in turn on one engine with
    ``config`` (step graphs captured on first use; the prefix cache emptied
    between rounds, so each round prefills its prompts in full), the launch
    counts set to 0 before the last round. Returns the streams
    ({rid: (tokens, finish, ttft)}), wall and stage-counter deltas of every
    round, {name: launches in the last round}, the K2
    launches the verify graphs replayed over the engine's life, and the
    graphs captured in all and in the last round. Raises when a kernel of
    ``kernels`` did not launch in the last round, or one of ``forbidden``
    did."""
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_kernel as k2

    async def run():
        engine = AsyncTorchEngine(config)
        await engine.start()
        try:
            outs, walls, stages = [], [], []
            monitor = engine.runner.compile_monitor
            for i, requests in enumerate(rounds):
                if i:
                    await engine.run_on_engine(engine.allocator.reset_prefix_cache)
                if i == len(rounds) - 1:
                    for fn in (*kernels.values(), *forbidden.values()):
                        fn.launches = 0
                    captures = monitor.compiles
                before = dataclasses.asdict(engine.scheduler.stage)
                results, wall = await serve_on(engine, requests)
                after = dataclasses.asdict(engine.scheduler.stage)
                outs.append(results)
                walls.append(wall)
                stages.append({k: after[k] - before[k] for k in after})
            return dict(outs=outs, walls=walls, stages=stages,
                        launches={name: fn.launches for name, fn in kernels.items()},
                        stray={name: fn.launches for name, fn in forbidden.items() if fn.launches},
                        k2_tally=spec_tally(engine, k2), captures=monitor.compiles - captures,
                        graphs=monitor.compiles)
        finally:
            await engine.shutdown()

    got = asyncio.run(run())
    torch.cuda.empty_cache()
    if min(got["launches"].values()) <= 0:
        raise AssertionError(f"spec serve: main path skipped a kernel: launches {got['launches']}")
    if got["stray"]:
        raise AssertionError(f"spec serve: kernels off this path launched: {got['stray']}")
    for rid, (toks, reason, _) in got["outs"][-1].items():
        if reason not in ("length", "stop") or not toks:
            raise AssertionError(f"spec serve {rid}: {len(toks)} tokens, finish {reason!r}")
    return got


def spec_line(what: str, gpu_name: str, run: dict, base: dict | None, i: int = -1) -> str:
    """Acceptance, verify rounds, tok/s and TTFT of round ``i`` of a spec
    run, beside its base."""
    st, res, wall = run["stages"][i], run["outs"][i], run["walls"][i]
    n_out = sum(len(t) for t, _, _ in res.values())
    ttft = float(np.median([t for _, _, t in res.values()]))
    rate = st["spec_accepted"] / st["spec_proposed"] if st["spec_proposed"] else float("nan")
    line = (f"{what} [{gpu_name}]: proposed {st['spec_proposed']}, accepted {st['spec_accepted']} (acceptance "
            f"{rate:.4f}), emitted {st['spec_emitted']} in {st['spec_rounds']} verify rounds "
            f"({st['spec_emitted'] / max(1, st['spec_emitted'] - st['spec_accepted']):.3f} tokens a lane a "
            f"round), draft steps {st['spec_draft_calls']}; {n_out / wall:.1f} output tok/s, TTFT p50 "
            f"{ttft * 1e3:.1f} ms, wall {wall:.2f} s; launches in the last round {run['launches']}; graphs "
            f"{run['graphs']} ({run['captures']} captured in the last round)")
    if base is not None:
        bttft = float(np.median(base["ttfts"]))
        line += (f"; without speculation {base['n_out'] / base['wall']:.1f} output tok/s, TTFT p50 "
                 f"{bttft * 1e3:.1f} ms, wall {base['wall']:.2f} s")
    return line


def stream_diffs(got: dict, want: dict) -> list:
    """[(rid, first differing token)] of the streams of ``want`` whose
    tokens or finish reason ``got`` does not repeat."""
    out = []
    for rid, (w, w_reason, *_) in want.items():
        g, g_reason = got[rid][:2]
        if (g, g_reason) != (w, w_reason):
            out.append((rid, next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))))
    return out


def same_streams(what: str, got: dict, want: dict, against: str) -> None:
    """Raise unless every stream's tokens and finish reason equal ``want``'s."""
    differ = stream_diffs(got, want)
    if differ:
        raise AssertionError(f"{what}: {len(differ)}/{len(want)} streams differ from {against} (first "
                             f"divergences {differ[:4]})")
    log(f"{what}: all {len(want)} greedy streams equal {against}, token for token")


def phase_spec_serve(torch, gpu_name: str, served: dict, kernels: dict) -> dict:
    """Speculative decoding on the card (``kernels``: {name: launcher} of
    every serving kernel). Greedy speculation is token-identical to the
    engine without it in exact arithmetic; in bf16 the verify pass (K2 over
    lanes of k + 1 rows, products of 16 (k + 1) rows) and the decode step
    (K1, products of 16 rows) round differently, so a greedy stream may
    take the other side of a near-tie. So the identities with the engine
    without speculation are held in f32 at full width, 4 layers (f32 keeps
    the two paths' argmaxes equal), and the bf16 runs at full depth are
    held to each other: two proposers that accept different drafts must
    emit the same streams. Returns {sub-phase: {name: launches in its timed
    round}}:

      (a) n-gram: Llama-3-8B geometry, 32 layers, bf16, ``serve_config()``,
          speculative "ngram:4", the 16-request workload, served twice (the
          second round timed): acceptance, verify rounds, tok/s and TTFT
          beside the serve phase's (``served["serve"]``), and the share of
          its streams that equal the serve phase's; K2 alone launches
          (verify and prefill: a spec-mode stream never takes a decode
          window), with the K2 launches the verify graphs replayed;
      (c) a smaller draft: TinyLlama-1.1B geometry with Llama-3's
          vocabulary drafting for the same 32-layer target (its decode
          steps on K3a, its catch-up and prefill on K3b): every stream
          equals (a)'s, token for token;
      (a', c') the same two proposers at Llama-3-8B width, 4 layers, f32
          (the draft TinyLlama-1.1B's width, 4 layers, f32): every stream
          equals the same engine's without speculation;
      (b) the target's own weights as its draft (Llama-3-8B width, 4
          layers, f32, "draft:<the same model>:4"): greedy acceptance
          exactly 1.0, the streams equal the engine's without speculation;
      (d) MLA with n-gram: DeepSeek-V2-Lite width, 4 layers, f32, capacity
          factor 11 (nothing drops, so the verify pass's 80 rows route as
          the decode step's 16 do; the default 2.0 drops pairs by the batch
          size), against the same engine without speculation: streams
          equal, K5 (verify) and K6 (prefill) launch and nothing else;
      (e) seeded sampled requests (temperature 0.8, distinct seeds) on the
          n-gram and self-draft engines of (a') and (b): each stream
          reproduced token for token beside other batch mates."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.tools.workload import (
        DEEPSEEK_V2_LITE,
        LLAMA3_8B,
        TINYLLAMA_1_1B,
        mla_serve_config,
        serve_config,
        serve_requests,
    )

    def only(*names):
        return {n: kernels[n] for n in names}, {n: fn for n, fn in kernels.items() if n not in names}

    def spec(config, model=None, speculative=None):
        return dataclasses.replace(config, model_id=model or config.model_id, speculative=speculative)

    out = {}
    requests = serve_requests()
    base = served["serve"]
    ngram = f"ngram:{SPEC_K}"
    tiny_draft = dict(TINYLLAMA_1_1B, vocab_size=LLAMA3_8B["vocab_size"])
    t0 = time.monotonic()
    # (a) n-gram at full width and depth, bf16
    a = spec_serve(torch, spec(serve_config(), speculative=ngram), [requests, requests], *only("K2"))
    log(spec_line("spec serve (a) n-gram, Llama-3-8B 32 layers bf16", gpu_name, a, base))
    differ = stream_diffs(a["outs"][-1], base["results"])
    log(f"spec serve (a): {len(requests) - len(differ)}/{len(requests)} greedy streams equal the serve phase's "
        f"(bf16 rounding; first divergences {differ}); K2 launched {a['launches']['K2']} times in the timed "
        f"round (verify and prefill), the verify graphs replayed {a['k2_tally']} K2 launches over both rounds")
    same_streams("spec serve (a)", a["outs"][0], a["outs"][-1], "its first round")
    out["spec ngram"] = a["launches"]
    t0 = lap("spec serve (a)", t0)
    # (c) a smaller draft for the 32-layer target, bf16
    c = spec_serve(torch, spec(serve_config(), speculative=f"draft:tiny:{json.dumps(tiny_draft)}:{SPEC_K}"),
                   [requests, requests], *only("K2", "K3a", "K3b"))
    log(spec_line("spec serve (c) TinyLlama-1.1B draft for Llama-3-8B 32 layers bf16", gpu_name, c, base))
    same_streams("spec serve (c) draft", c["outs"][-1], a["outs"][-1], "(a)'s (n-gram)")
    out["spec draft"] = c["launches"]
    t0 = lap("spec serve (c)", t0)

    # f32 at full width, 4 layers: identity with the engine without speculation
    small = "tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=4, dtype="f32"))
    tiny4 = "tiny:" + json.dumps(dict(tiny_draft, num_layers=4, dtype="f32"))

    def sampled(tag: str, idx, seed_base: int):
        return [EngineRequest(f"e{tag}-{i}", requests[i].token_ids[:256],
                              SamplingParams(temperature=0.8, seed=seed_base + i, max_tokens=32)) for i in idx]

    probe = sampled("p", range(4), 100)
    mates_1 = [EngineRequest(f"m1-{i}", r.token_ids[:128], SamplingParams(max_tokens=32))
               for i, r in enumerate(requests[4:8])]
    mates_2 = sampled("q", range(8, 14), 900)
    base4 = spec_serve(torch, spec(serve_config(), small), [requests], *only("K1", "K2"))["outs"][-1]
    for what, speculative, names in (("(a') n-gram", ngram, ("K2",)),
                                     ("(b) self-draft", f"draft:{small}:{SPEC_K}", ("K1", "K2")),
                                     ("(c') TinyLlama draft", f"draft:{tiny4}:{SPEC_K}", ("K2", "K3a", "K3b"))):
        e_rounds = [] if what.startswith("(c')") else [probe + mates_1, mates_2 + probe]
        r = spec_serve(torch, spec(serve_config(), small, speculative), [requests, *e_rounds], *only(*names))
        same_streams(f"spec serve {what}, Llama-3-8B width 4 layers f32", r["outs"][0], base4,
                     "the engine's without speculation")
        log(spec_line(f"spec serve {what}, Llama-3-8B width 4 layers f32, greedy round", gpu_name, r, None, 0))
        st = r["stages"][0]
        if what.startswith("(b)") and not 0 < st["spec_accepted"] == st["spec_proposed"]:
            raise AssertionError(f"spec serve (b): a self-draft accepted {st['spec_accepted']} of "
                                 f"{st['spec_proposed']} greedy drafts (want all)")
        if e_rounds:
            got1, got2 = r["outs"][1], r["outs"][2]
            differ = [q.request_id for q in probe if got1[q.request_id][:2] != got2[q.request_id][:2]]
            if differ or any(len(got1[q.request_id][0]) != 32 for q in probe):
                raise AssertionError(f"spec serve (e) {what}: seeded streams {differ} changed with their batch mates")
            log(f"spec serve (e) {what}: {len(probe)} seeded sampled streams (temperature 0.8) reproduced token for "
                f"token beside other batch mates")
        out[f"spec {what} f32"] = r["launches"]
    t0 = lap("spec serve (a') (b) (c') (e)", t0)

    # (d) MLA with n-gram against the same engine without speculation
    mla4 = "tiny-mla:" + json.dumps(dict(DEEPSEEK_V2_LITE, num_layers=4, dtype="f32", moe_capacity_factor=11.0))
    mla_requests = serve_requests(DEEPSEEK_V2_LITE["vocab_size"])
    d0 = spec_serve(torch, spec(mla_serve_config(), mla4), [mla_requests], *only("K5", "K6"))
    d = spec_serve(torch, spec(mla_serve_config(), mla4, ngram), [mla_requests], *only("K5", "K6"))
    same_streams("spec serve (d) MLA n-gram, DeepSeek-V2-Lite width 4 layers f32", d["outs"][-1], d0["outs"][-1],
                 "the engine's without speculation")
    log(spec_line("spec serve (d) n-gram, DeepSeek-V2-Lite width 4 layers f32 (capacity factor 11)", gpu_name, d,
                  None))
    rounds = d["stages"][-1]["spec_rounds"]
    if d["launches"]["K5"] != rounds * 4:
        raise AssertionError(f"spec serve (d): K5 launched {d['launches']['K5']} times, not once a layer of each of "
                             f"the {rounds} verify rounds")
    log(f"spec serve (d): K5 launched {d['launches']['K5']} times = {rounds} verify rounds x 4 layers (no decode "
        f"window ran)")
    out["spec MLA ngram"] = d["launches"]
    lap("spec serve (d)", t0)
    return out


# ---------------------------------------------------------------- preempt serve

PREEMPT_PAGES = 1100  # the serve prompts take 1073 pages of 16, with their outputs 1137
QOS_SLOTS = 4
PLANNER_PROMPT, PLANNER_MAX_LEN, PLANNER_FLAT = 16384, 16448, 2048


async def stream_outputs(engine, req, firsts: set):
    """(request id, {tokens, reason, ttft (s from the call)}); the id joins
    ``firsts`` at its first token."""
    t0 = time.monotonic()
    got = dict(tokens=[], reason=None, ttft=None)
    async for out in engine.generate(req):
        if out.token is not None:
            if got["ttft"] is None:
                got["ttft"] = time.monotonic() - t0
                firsts.add(req.request_id)
            got["tokens"].append(out.token)
        got["reason"] = out.finish_reason
    return req.request_id, got


class PreemptEngine:
    """A started AsyncTorchEngine on a shared model, every step graph
    captured first (warmup True); ``run`` serves a list of requests with the
    launch counts of ``kernels`` and ``forbidden`` set to 0 just before and
    read just after, and raises when a kernel of ``kernels`` did not launch,
    one of ``forbidden`` did, or a graph was captured while serving. Every
    admission's cached tokens are recorded (a preempted request's
    re-admission among them)."""

    def __init__(self, what: str, config, model, kernels: dict, forbidden: dict):
        from dynamo_tpu_torch.engine.engine import AsyncTorchEngine

        self.what, self.kernels, self.forbidden = what, kernels, forbidden
        self.engine = AsyncTorchEngine(dataclasses.replace(config, warmup=True), model=model)
        asyncio.run(self.engine.start())
        self.sched = self.engine.scheduler
        self.admissions = []  # (request id, cached tokens), on the engine thread
        start = self.sched._start_sequence

        def start_recorded(req, slot, **kw):
            start(req, slot, **kw)
            self.admissions.append((req.request_id, self.sched.slots[slot].cached_len))

        self.sched._start_sequence = start_recorded

    def on_engine(self, fn):
        async def call():
            return await self.engine.run_on_engine(fn)

        return asyncio.run(call())

    def run(self, requests, later=(), ready=None) -> dict:
        """Serve ``requests`` concurrently, and ``later`` once ``ready(ids
        of the streams that have their first token)`` holds; returns
        {streams, wall, launches, resumed: {id: cached tokens of each
        re-admission}, the scheduler's counter deltas}."""
        engine, monitor = self.engine, self.engine.runner.compile_monitor
        counters = ("preempt_count", "pressure_drain_count", "qos_sheds")
        before = {k: getattr(self.sched, k) for k in counters} | {"qos_preempted": dict(self.sched.qos_preempted)}

        async def serve_all():
            t0, firsts = time.monotonic(), set()
            tasks = [asyncio.ensure_future(stream_outputs(engine, r, firsts)) for r in requests]
            if later:
                while not ready(firsts):
                    await asyncio.sleep(0.002)
                tasks += [asyncio.ensure_future(stream_outputs(engine, r, firsts)) for r in later]
            results = dict(await asyncio.gather(*tasks))
            return results, time.monotonic() - t0

        for fn in (*self.kernels.values(), *self.forbidden.values()):
            fn.launches = 0
        captures, admitted = monitor.compiles, len(self.admissions)
        results, wall = asyncio.run(serve_all())
        resumed, seen = {}, set()
        for rid, cached in self.admissions[admitted:]:
            if rid in seen:
                resumed.setdefault(rid, []).append(cached)
            seen.add(rid)
        captured = monitor.compiles - captures
        launches = {name: fn.launches for name, fn in self.kernels.items()}
        stray = {name: fn.launches for name, fn in self.forbidden.items() if fn.launches}
        if min(launches.values()) <= 0:
            raise AssertionError(f"{self.what}: main path skipped a kernel: launches {launches}")
        if stray:
            raise AssertionError(f"{self.what}: kernels off this path launched: {stray}")
        if captured:
            raise AssertionError(f"{self.what}: {captured} graph captures after the warmup")
        delta = {k: getattr(self.sched, k) - before[k] for k in counters}
        delta["qos_preempted"] = {c: n - before["qos_preempted"].get(c, 0)
                                  for c, n in self.sched.qos_preempted.items()
                                  if n - before["qos_preempted"].get(c, 0)}
        return dict(streams=results, wall=wall, launches=launches, resumed=resumed, **delta)

    def close(self) -> None:
        import gc

        asyncio.run(self.engine.shutdown())
        self.engine = self.sched = None
        gc.collect()


def fresh(req, **changes):
    """A copy of ``req`` never submitted (an engine stamps its submission
    time and number on the request it is given)."""
    return dataclasses.replace(req, enqueue_ts=0.0, submission=0, **changes)


def all_length(what: str, streams: dict, n: int) -> None:
    """Raise unless every stream ended with "length" and ``n`` tokens."""
    bad = {rid: (len(s["tokens"]), s["reason"]) for rid, s in streams.items()
           if len(s["tokens"]) != n or s["reason"] != "length"}
    if bad:
        raise AssertionError(f"{what}: streams not ending with {n} tokens and 'length': {bad}")


def greedy_tokens(streams: dict) -> dict:
    return {rid: (s["tokens"], s["reason"]) for rid, s in streams.items()}


def phase_preempt_serve(torch, gpu_name: str, served: dict, kernels: dict) -> dict:
    """Preemption under page pressure, the QoS scheduler and the chunk
    planner on the card (``kernels``: {name: launcher} of every serving
    kernel; each sub-phase's engine captures every step graph first, and
    none is captured while it serves). Returns {sub-phase: {name: launches
    in its run}}:

      (a) Llama-3-8B geometry, 32 layers, bf16, the serve workload on
          ``serve_config()`` with PREEMPT_PAGES pages and watermark 0 (the
          prompts fit, their outputs do not): every stream ends "length"
          with 64 tokens and the scheduler preempted; prints preemptions,
          pressure drains, the resumed requests' cached tokens, tok/s and
          TTFT p50 beside the serve phase's (``served["serve"]``), the share
          of streams equal to the serve phase's (bf16: a resumed tail's KV is
          a K2 product where it was a K1 product), K1 and K2 launches;
      (b) Llama-3-8B width, 4 layers, f32, the same pool against 4096
          pages: every greedy stream equal, stream for stream;
      (c) bf16, 32 layers, ``max_seqs`` QOS_SLOTS: the 16 serve prompts as
          batch class, then two critical requests (fresh 512-token prompts)
          once every slot is busy, with ``qos`` True and then False on one
          engine: with QoS the scheduler sheds (preempts a batch lane), no
          critical stream is preempted, every stream ends with 64 tokens,
          and the critical TTFT p50 is below the FIFO run's;
      (d) n-gram speculation (k = SPEC_K) on (b)'s tight pool, f32: the
          streams equal (b)'s, and the pressure ladder preempted;
      (e) bf16, 32 layers, ``max_model_len`` PLANNER_MAX_LEN, page-table
          rungs (128, 1028): one PLANNER_PROMPT-token prompt beside the four
          shortest serve prompts decoding, at the default
          ``prefill_flat_depth`` and at PLANNER_FLAT (one engine, the prefix
          cache emptied between): each prefill call's rows (step anatomy)
          equal ``chunk_len_for``'s plan, the stream ends "length"; prints
          each call's device ms (CUDA events around the call) against its
          depth."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B, MAX_TOKENS, serve_config, serve_requests

    def only(*names):
        return {n: kernels[n] for n in names}, {n: fn for n, fn in kernels.items() if n not in names}

    out = {}
    requests = serve_requests()
    base = served["serve"]
    t0 = time.monotonic()
    model = load_model(serve_config().model_id, device="cuda")
    t0 = lap("preempt serve: the 32-layer bf16 model", t0)

    # (a) the serve workload on a pool its outputs outgrow
    tight = dataclasses.replace(serve_config(), num_pages=PREEMPT_PAGES, watermark=0.0)
    eng = PreemptEngine("preempt serve (a)", tight, model, *only("K1", "K2"))
    try:
        a = eng.run([fresh(r) for r in requests])
        graphs = graphs_line(eng.engine)
    finally:
        eng.close()
    all_length("preempt serve (a)", a["streams"], MAX_TOKENS)
    if a["preempt_count"] < 1:
        raise AssertionError(f"preempt serve (a): no preemption on {PREEMPT_PAGES} pages")
    ttfts = sorted(s["ttft"] for s in a["streams"].values())
    n_out = sum(len(s["tokens"]) for s in a["streams"].values())
    differ = stream_diffs(greedy_tokens(a["streams"]), {rid: r[:2] for rid, r in base["results"].items()})
    log(f"preempt serve (a) [{gpu_name}]: {len(requests)} streams ended 'length' with {MAX_TOKENS} tokens on "
        f"{PREEMPT_PAGES} pages, watermark 0: {a['preempt_count']} preemptions, {a['pressure_drain_count']} "
        f"pressure drains; re-admissions' cached tokens {json.dumps(a['resumed'])}; {n_out / a['wall']:.1f} output "
        f"tok/s, TTFT p50 {np.median(ttfts) * 1e3:.1f} ms, wall {a['wall']:.2f} s (serve on 4096 pages: "
        f"{base['n_out'] / base['wall']:.1f} output tok/s, TTFT p50 {np.median(base['ttfts']) * 1e3:.1f} ms, wall "
        f"{base['wall']:.2f} s); {len(requests) - len(differ)}/{len(requests)} streams equal the serve phase's "
        f"(bf16; first divergences {differ[:4]}); launches K1 {a['launches']['K1']} K2 {a['launches']['K2']}")
    log(f"preempt serve (a) graphs: {graphs}; no capture after the warmup")
    out["preempt serve"] = a["launches"]
    t0 = lap("preempt serve (a)", t0)

    # (c) QoS: batch requests fill every slot, then two critical requests
    rng = np.random.default_rng(16)
    batch = [fresh(r, request_id=f"batch-{i}", priority="batch") for i, r in enumerate(requests)]
    critical = [EngineRequest(f"critical-{i}", rng.integers(0, LLAMA3_8B["vocab_size"], 512).tolist(),
                              SamplingParams(max_tokens=MAX_TOKENS), priority="critical") for i in range(2)]
    eng = PreemptEngine("preempt serve (c)", dataclasses.replace(serve_config(), max_seqs=QOS_SLOTS), model,
                        *only("K1", "K2"))
    try:
        runs_c = {}
        for on in (True, False):
            eng.on_engine(eng.engine.allocator.reset_prefix_cache)
            eng.on_engine(lambda: setattr(eng.engine.config, "qos", on))
            runs_c[on] = eng.run([fresh(r) for r in batch], [fresh(r) for r in critical],
                                 ready=lambda _: eng.sched.num_running >= QOS_SLOTS)
    finally:
        eng.close()
    crit_ttft = {}
    for on, r in runs_c.items():
        all_length(f"preempt serve (c) qos={on}", r["streams"], MAX_TOKENS)
        crit_ttft[on] = float(np.median([r["streams"][q.request_id]["ttft"] for q in critical]))
        batch_ttft = float(np.median([r["streams"][q.request_id]["ttft"] for q in batch]))
        log(f"preempt serve (c) qos={on} [{gpu_name}]: critical TTFTs "
            f"{[round(r['streams'][q.request_id]['ttft'] * 1e3, 1) for q in critical]} ms (p50 "
            f"{crit_ttft[on] * 1e3:.1f}), batch TTFT p50 {batch_ttft * 1e3:.1f} ms, wall {r['wall']:.2f} s; "
            f"sheds {r['qos_sheds']}, preemptions {r['preempt_count']} by class {r['qos_preempted']}; launches "
            f"{r['launches']}")
    if runs_c[True]["qos_sheds"] < 1 or runs_c[True]["qos_preempted"].get("critical", 0):
        raise AssertionError(f"preempt serve (c): sheds {runs_c[True]['qos_sheds']}, preempted by class "
                             f"{runs_c[True]['qos_preempted']} (want a shed and no critical victim)")
    if not crit_ttft[True] < crit_ttft[False]:
        raise AssertionError(f"preempt serve (c): critical TTFT p50 {crit_ttft[True] * 1e3:.1f} ms with QoS, "
                             f"{crit_ttft[False] * 1e3:.1f} ms without")
    out["preempt serve qos"] = runs_c[True]["launches"]
    t0 = lap("preempt serve (c)", t0)

    # (e) the chunk planner: a long prompt beside four decoding streams
    shortest = sorted(requests, key=lambda r: len(r.token_ids))[:4]
    long_req = EngineRequest("long", rng.integers(0, LLAMA3_8B["vocab_size"], PLANNER_PROMPT).tolist(),
                             SamplingParams(max_tokens=PLANNER_MAX_LEN - PLANNER_PROMPT))
    cfg_e = dataclasses.replace(serve_config(), max_seqs=5, max_model_len=PLANNER_MAX_LEN, page_table_buckets=(128,))
    eng = PreemptEngine("preempt serve (e)", cfg_e, model, *only("K1", "K2"))
    runner = eng.engine.runner
    calls = []
    plain_batch = runner.prefill_chunk_batch

    def timed_batch(lanes, **kw):  # CUDA events around each prefill call, on the engine's stream
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = plain_batch(lanes, **kw)
        end.record()
        calls.append((lanes, start, end))
        return result

    runner.prefill_chunk_batch = timed_batch
    try:
        for flat in (cfg_e.prefill_flat_depth, PLANNER_FLAT):
            eng.on_engine(eng.engine.allocator.reset_prefix_cache)
            eng.on_engine(lambda: setattr(eng.engine.config, "prefill_flat_depth", flat))
            cfg = eng.engine.config
            plan, start = [], 0
            while start < PLANNER_PROMPT:
                plan.append(min(cfg.chunk_len_for(start, PLANNER_PROMPT - start), PLANNER_PROMPT - start))
                start += plan[-1]
            mark = max((rec.seq for rec in eng.sched.anatomy.ring), default=-1)
            calls.clear()
            # the long prompt goes in once the four short streams decode
            e = eng.run([fresh(r) for r in shortest], [fresh(long_req)],
                        ready=lambda firsts: len(firsts) >= len(shortest))
            all_length(f"preempt serve (e) flat {flat}", {"long": e["streams"]["long"]},
                       PLANNER_MAX_LEN - PLANNER_PROMPT)
            torch.cuda.synchronize()
            # one step-anatomy record a prefill call; the long prompt's
            # calls are those with its table rung, wider than the short ones'
            rows = [rec.tokens for rec in eng.sched.anatomy.ring if rec.seq > mark and rec.kind == "prefill_packed"]
            wide = [any(len(lane[2]) > 128 for lane in lanes) for lanes, _, _ in calls]
            if len(rows) != len(calls):
                raise AssertionError(f"preempt serve (e): {len(rows)} prefill records, {len(calls)} prefill calls")
            long_rows = [r for r, w in zip(rows, wide) if w]
            timed = [(lanes[0][1], len(lanes[0][0]), s.elapsed_time(t)) for (lanes, s, t), w in zip(calls, wide) if w]
            if long_rows != plan or [r for _, r, _ in timed] != plan:
                raise AssertionError(f"preempt serve (e) flat {flat}: the long prompt's prefill rows {long_rows}, "
                                     f"chunk_len_for's plan {plan}")
            ms = [m for _, _, m in timed]
            log(f"preempt serve (e) flat depth {flat} [{gpu_name}]: {len(plan)} prefill calls of rows "
                f"{sorted(set(plan), reverse=True)} as chunk_len_for plans them, long stream 'length' with "
                f"{len(e['streams']['long']['tokens'])} tokens, TTFT {e['streams']['long']['ttft'] * 1e3:.1f} ms, "
                f"prefill device ms sum {sum(ms):.1f}, max {max(ms):.3f}; launches {e['launches']}; (depth, rows, "
                f"device ms) a call: {json.dumps([(d, r, round(m, 3)) for d, r, m in timed])}")
            out[f"preempt serve planner {flat}"] = e["launches"]
    finally:
        runner.prefill_chunk_batch = plain_batch
        eng.close()
    del model
    torch.cuda.empty_cache()
    t0 = lap("preempt serve (e)", t0)

    # (b) and (d): f32 at Llama-3-8B width, 4 layers
    small = load_model("tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=4, dtype="f32")), device="cuda")
    streams = {}
    for what, pages, speculative in (("(b) roomy", 4096, None), ("(b) tight", PREEMPT_PAGES, None),
                                     ("(d) n-gram tight", PREEMPT_PAGES, f"ngram:{SPEC_K}")):
        cfg = dataclasses.replace(serve_config(), num_pages=pages, watermark=0.0, speculative=speculative)
        eng = PreemptEngine(f"preempt serve {what}", cfg, small, *(only("K2") if speculative else only("K1", "K2")))
        try:
            r = eng.run([fresh(q) for q in requests])
        finally:
            eng.close()
        all_length(f"preempt serve {what}", r["streams"], MAX_TOKENS)
        streams[what] = greedy_tokens(r["streams"])
        log(f"preempt serve {what}, Llama-3-8B width 4 layers f32, {pages} pages [{gpu_name}]: "
            f"{r['preempt_count']} preemptions, {r['pressure_drain_count']} pressure drains, re-admissions' cached "
            f"tokens {json.dumps(r['resumed'])}, wall {r['wall']:.2f} s, "
            f"launches {r['launches']}")
        if pages == PREEMPT_PAGES and r["preempt_count"] < 1:
            raise AssertionError(f"preempt serve {what}: no preemption on {PREEMPT_PAGES} pages")
        out[f"preempt serve {what} f32"] = r["launches"]
    same_streams("preempt serve (b) f32", streams["(b) tight"], streams["(b) roomy"], "the roomy pool's")
    same_streams("preempt serve (d) n-gram f32", streams["(d) n-gram tight"], streams["(b) tight"], "(b)'s")
    del small
    torch.cuda.empty_cache()
    lap("preempt serve (b) (d)", t0)
    return out


# ---------------------------------------------------------------- disagg serve

DISAGG_THRESHOLD = 256  # max_local_prefill_length: every longer prompt prefills remotely


def replay_tally(engine, launchers: dict) -> dict:
    """{name: launches of ``launcher`` that the engine's graphs replayed
    over its life} (each graph's capture tally times its replays)."""
    out = {name: 0 for name in launchers}
    for e in engine.runner.graphs.entries.values():
        tally = dict(e.tally)
        for name, fn in launchers.items():
            out[name] += tally.get(fn, 0) * e.replays
    return out


def prefill_engine_config(config):
    """The prefill engine beside a decode engine of ``config``, sized as
    the reference bench sizes its (``bench.py:907-911``): 4 slots, 6 x the
    pages of one sequence plus 8, one prefill lane (the worker's chain
    prefills one sequence a call)."""
    pages_per_seq = -(-config.max_model_len // config.page_size) + 2
    return dataclasses.replace(config, max_seqs=4, num_pages=6 * pages_per_seq + 8, prefill_lanes=1, warmup=False)


class DisaggPair:
    """On the running loop: a broker on localhost, two DistributedRuntimes,
    ``decode_engine`` behind a DisaggDecodeEngine (the router's threshold
    DISAGG_THRESHOLD) and, when given, ``prefill_engine`` behind a
    PrefillWorker. ``close`` stops everything it started, the decode engine
    included."""

    def __init__(self, ns: str, model: str):
        self.ns, self.model, self.stops = ns, model, []
        self.worker = None

    async def start(self, decode_engine, prefill_engine=None):
        from dynamo_tpu_torch.cplane.broker import Broker
        from dynamo_tpu_torch.disagg.decode_worker import DisaggDecodeEngine
        from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter, DisaggRouterConf
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        self.broker = Broker()
        self.addr = f"127.0.0.1:{await self.broker.start()}"
        self.stops.append(self.broker.stop)
        self.rts = [DistributedRuntime(cplane_address=self.addr) for _ in range(2)]
        for rt in self.rts:
            await rt.connect()
            self.stops.append(rt._shutdown_hook)
        router = DisaggregatedRouter(self.model, conf=DisaggRouterConf(max_local_prefill_length=DISAGG_THRESHOLD))
        self.decode = DisaggDecodeEngine(decode_engine, self.rts[0], self.ns, "decoder", self.model,
                                         disagg_router=router)
        await self.decode.start()
        self.stops.append(self.decode.shutdown)
        if prefill_engine is not None:
            await self.start_worker(prefill_engine)
        return self

    async def start_worker(self, prefill_engine):
        from dynamo_tpu_torch.disagg.prefill_worker import PrefillWorker

        self.worker = PrefillWorker(prefill_engine, self.rts[1], self.ns, self.model)
        await self.worker.start()
        self.stops.append(self.worker.stop)

    async def close(self) -> None:
        for stop in reversed(self.stops):
            await stop()
        self.stops = []


async def reset_prefix_caches(*engines) -> None:
    for e in engines:
        await e.run_on_engine(e.allocator.reset_prefix_cache)


async def no_leak(what: str, *engines) -> None:
    """Raise unless every engine holds no sequence and no page (the prefix
    cache's refcount-0 blocks aside) and the ici hub parks nothing."""
    from dynamo_tpu_torch.disagg import ici

    for e in engines:
        seqs, active = await e.run_on_engine(lambda e=e: (list(e.allocator._seqs), e.allocator.active_pages))
        if seqs or active:
            raise AssertionError(f"{what}: {e.config.model_id[:30]} engine holds {seqs} / {active} pages")
    if ici.transfer_count():
        raise AssertionError(f"{what}: {ici.transfer_count()} ici transfers left parked")


def disagg_gates(what: str, pair, results: dict, requests, before: tuple = (0, 0)) -> tuple[int, int]:
    """Every stream ends 'length' with MAX_TOKENS tokens; the remote
    prefills are exactly the prompts above DISAGG_THRESHOLD (none fell back
    to a local prefill). Returns this run's (remote, local) counts."""
    from dynamo_tpu_torch.tools.workload import MAX_TOKENS

    bad = {rid: (len(t), r) for rid, (t, r, _) in results.items() if len(t) != MAX_TOKENS or r != "length"}
    if bad:
        raise AssertionError(f"{what}: streams not ending 'length' with {MAX_TOKENS} tokens: {bad}")
    remote = pair.decode.remote_prefills - before[0]
    local = pair.decode.local_prefills - before[1]
    want = sum(len(r.token_ids) > DISAGG_THRESHOLD for r in requests)
    if remote != want or local != len(requests) - want or pair.decode.local_prefill_fallbacks:
        raise AssertionError(f"{what}: {remote} remote and {local} local prefills ({pair.decode.local_prefill_fallbacks} "
                             f"fallbacks) for {want} prompts above {DISAGG_THRESHOLD} tokens")
    return remote, local


def stream_line(pair) -> str:
    """The data plane's parts, bytes, send and overlap seconds and the
    checksum rate on both sides (cumulative over the pair's life)."""
    w, s = pair.worker, pair.decode.kv_server
    c = w.kv_client

    def rate(n, t):
        return f"{n / t / 1e9:.2f} GB/s" if t else "n/a"

    return (f"{w.stream_requests} streamed requests, {c.sent} parts sent ({w.stream_parts} streamed), "
            f"{c.bytes_sent / 1e6:.1f} MB sent, {s.parts_received} parts / {s.bytes_received / 1e6:.1f} MB received "
            f"over {c.lanes} lanes; stream_send_s {w.stream_send_s:.4f}, stream_overlap_s {w.stream_overlap_s:.4f}; "
            f"XXH3-64 checksums: sender {c.hashed_bytes / 1e6:.1f} MB in {c.hash_s:.4f} s "
            f"({rate(c.hashed_bytes, c.hash_s)}), receiver {s.hashed_bytes / 1e6:.1f} MB in {s.hash_s:.4f} s "
            f"({rate(s.hashed_bytes, s.hash_s)}); {s.checksum_failures} checksum failures")


def phase_disagg_serve(torch, gpu_name: str, served: dict, kernels: dict) -> dict:
    """Disaggregated prefill and decode on one card (``kernels``: {name:
    launcher} of every serving kernel). A DisaggDecodeEngine and a
    PrefillWorker over the port's broker (localhost), runtime and KV data
    plane; the router sends every prompt above DISAGG_THRESHOLD tokens to
    the prefill engine. Every stream ends with its MAX_TOKENS tokens, the
    remote prefills are exactly the prompts above the threshold, and no
    page stays held on either engine once the requests end. Returns the
    launches of (a) ("disagg serve": K1, K2) and (d) ("disagg MLA": K5, K6),
    {path: {name: launches in its run}}:

      (a) ici at full width: Llama-3-8B geometry, 32 layers, bf16; the
          decode engine on ``serve_config()`` (every step graph captured
          first), the prefill engine in this process on
          ``prefill_engine_config`` (its core graphs captured first); the
          KV handed over as device blocks (the ici hub); prints remote and
          local prefills, ici transfers and bytes, remote_prefill_wait_s and
          TTFT p50, output tok/s beside the serve phase's, K2 launches on
          the prefill engine and K1 on the decode engine (each engine's
          graph replay tallies; the decode engine captures nothing while
          serving), and the streams equal to serve's (bf16: the prefill
          worker's one-lane calls and serve's packed ones round apart);
      (b) the pair in this process at Llama-3-8B width, 4 layers, f32 (a
          depth cut: identity, not speed); the decode engine first serves
          the workload alone (the aggregated baseline), then through the
          pair over ici ((a)'s device handoff, whose bf16 streams cannot be
          held token for token), then with the ici hub bypassed over the
          socket data plane, streamed (a part per prefill chunk) and
          monolithic: every stream equals the baseline's; then the same at bf16 on the int8 KV cache (codes and
          scales on the wire): every stream ends, the share equal to its
          baseline is printed; prints parts, bytes, stream_send_s against
          stream_overlap_s and the checksums' GB/s;
      (c) two processes: (b)'s f32 decode engine and broker here, the
          prefill worker as ``python -m
          dynamo_tpu_torch.components.prefill_worker`` on the same card,
          streamed: every stream equals (b)'s baseline, and SIGTERM ends the
          process with exit code 0;
      (d) MLA over ici: DeepSeek-V2-Lite width, 4 layers, f32, capacity
          factor 11 (nothing drops, so the decode windows' batches route
          alike), the baseline on the decode engine first: every stream
          equal; K6 launches on the prefill engine, K5 on the decode
          engine."""
    import gc

    from dynamo_tpu_torch.disagg import ici
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.tools.workload import (
        DEEPSEEK_V2_LITE,
        LLAMA3_8B,
        mla_serve_config,
        serve_config,
        serve_requests,
    )

    def only(*names):
        return {n: kernels[n] for n in names}, {n: fn for n, fn in kernels.items() if n not in names}

    def zero(*groups):
        for g in groups:
            for fn in g.values():
                fn.launches = 0

    def check_launches(what, path, stray):
        bad = {n: fn.launches for n, fn in stray.items() if fn.launches}
        if bad:
            raise AssertionError(f"{what}: kernels off this path launched: {bad}")
        return {n: fn.launches for n, fn in path.items()}

    def free():
        dropped = ici.drain_all()
        if dropped:
            raise AssertionError(f"disagg serve: {dropped} ici transfers were left parked")
        gc.collect()
        torch.cuda.empty_cache()

    out = {}
    requests = serve_requests()
    base = served["serve"]
    t0 = time.monotonic()

    # (a) ici at full width and depth
    async def run_a():
        cfg = serve_config()
        decode_inner = AsyncTorchEngine(dataclasses.replace(cfg, warmup=True))
        prefill = AsyncTorchEngine(prefill_engine_config(cfg))
        pair = DisaggPair("disagg-a", cfg.model_id)
        try:
            await decode_inner.start()
            await prefill.start()
            await prefill.run_on_engine(prefill.runner.warmup_core)
            await pair.start(decode_inner, prefill)
            path, stray = only("K1", "K2")
            zero(path, stray)
            tallies = replay_tally(decode_inner, path)
            captures = decode_inner.runner.compile_monitor.compiles
            pre_mon = prefill.runner.compile_monitor
            pre_captures = (pre_mon.compiles, pre_mon.compile_s)
            transfers = ici.total_transfers()
            results, wall = await serve_on(pair.decode, [fresh(r) for r in requests])
            launches = check_launches("disagg serve (a)", path, stray)
            if decode_inner.runner.compile_monitor.compiles != captures:
                raise AssertionError("disagg serve (a): the decode engine captured a graph while serving")
            dec = {n: v - tallies[n] for n, v in replay_tally(decode_inner, path).items()}
            pre = {n: launches[n] - dec[n] for n in path}
            remote, local = disagg_gates("disagg serve (a)", pair, results, requests)
            n_ici = ici.total_transfers() - transfers
            if n_ici != remote or pre["K2"] <= 0 or pre["K1"] != 0 or dec["K1"] <= 0:
                raise AssertionError(f"disagg serve (a): {n_ici} ici transfers for {remote} remote prefills; "
                                     f"prefill engine {pre}, decode engine {dec}")
            await no_leak("disagg serve (a)", decode_inner, prefill)
            ps = cfg.page_size
            n_bytes = sum(-(-len(r.token_ids) // ps) for r in requests if len(r.token_ids) > DISAGG_THRESHOLD) \
                * decode_inner.model.kv_page_bytes(ps)
            waits = sorted(pair.decode.remote_prefill_waits)
            n_out = sum(len(t) for t, _, _ in results.values())
            ttfts = sorted(t for _, _, t in results.values())
            differ = stream_diffs({rid: r[:2] for rid, r in results.items()}, base["results"])
            log(f"disagg serve (a) ici, Llama-3-8B 32 layers bf16 [{gpu_name}]: {remote} remote prefills (prompts "
                f"above {DISAGG_THRESHOLD} tokens), {local} local; {n_ici} ici transfers, {n_bytes / 1e9:.3f} GB of "
                f"KV pages; remote_prefill_wait_s p50 {waits[len(waits) // 2] * 1e3:.1f} ms (max "
                f"{waits[-1] * 1e3:.1f}); TTFT p50 {np.median(ttfts) * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms; "
                f"{n_out / wall:.1f} output tok/s, wall {wall:.2f} s (aggregated serve in this call: "
                f"{base['n_out'] / base['wall']:.1f} output tok/s, TTFT p50 {np.median(base['ttfts']) * 1e3:.1f} "
                f"ms); launches: prefill engine K2 {pre['K2']} K1 {pre['K1']}, decode engine K1 {dec['K1']} K2 "
                f"{dec['K2']} (local prefills); {len(requests) - len(differ)}/{len(requests)} streams equal the "
                f"serve phase's (bf16; first divergences {differ[:4]}); no page held on either engine after")
            log(f"disagg serve (a) decode engine graphs [{gpu_name}]: {graphs_line(decode_inner)}; prefill engine "
                f"{pre_mon.compiles} graphs, {pre_mon.compiles - pre_captures[0]} of them captured while serving, "
                f"in {pre_mon.compile_s - pre_captures[1]:.2f} s")
            return launches
        finally:
            await pair.close()  # the decode engine with it
            await decode_inner.shutdown()
            await prefill.shutdown()

    out["disagg serve"] = asyncio.run(run_a())
    free()
    t0 = lap("disagg serve (a)", t0)

    # (b) the socket data plane in this process, and (c) the prefill worker
    # as a second process, at Llama-3-8B width, 4 layers
    def llama4(**over):
        return dataclasses.replace(serve_config(), model_id="tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=4, **over)))

    async def run_bc():
        local_ici = ici.is_local
        cfg = llama4(dtype="f32")
        decode_inner = AsyncTorchEngine(cfg)
        prefill = AsyncTorchEngine(prefill_engine_config(cfg))
        pair = DisaggPair("disagg-b", cfg.model_id)
        try:
            await decode_inner.start()
            await prefill.start()
            path, stray = only("K1", "K2")
            zero(path, stray)
            baseline, _ = await serve_on(decode_inner, [fresh(r) for r in requests])
            baseline = {rid: r[:2] for rid, r in baseline.items()}
            await reset_prefix_caches(decode_inner)
            await pair.start(decode_inner, prefill)
            # ici first: (a)'s handoff (a device block and its gather's
            # event) at a depth where f32 holds every stream to the baseline;
            # then the decode engine looks remote: KV over the data plane
            for mode in ("ici", "streamed", "monolithic"):
                ici.is_local = local_ici if mode == "ici" else (lambda worker_id: False)
                pair.worker.kv_stream = mode == "streamed"
                parts, transfers = pair.worker.kv_client.sent, ici.total_transfers()
                counts = (pair.decode.remote_prefills, pair.decode.local_prefills)
                results, wall = await serve_on(pair.decode, [fresh(r) for r in requests])
                remote, _ = disagg_gates(f"disagg serve (b) {mode}", pair, results, requests, counts)
                n_parts, n_ici = pair.worker.kv_client.sent - parts, ici.total_transfers() - transfers
                if (n_ici, n_parts > 0) != ((remote, False) if mode == "ici" else (0, True)):
                    raise AssertionError(f"disagg serve (b) {mode}: {n_ici} ici transfers and {n_parts} data-plane "
                                         f"parts for {remote} remote prefills")
                route = "ici" if mode == "ici" else f"socket {mode}"
                same_streams(f"disagg serve (b) {route}, Llama-3-8B width 4 layers f32",
                             {rid: r[:2] for rid, r in results.items()}, baseline, "the aggregated engine's")
                log(f"disagg serve (b) {route} [{gpu_name}]: {n_ici} ici transfers, {n_parts} parts for {remote} "
                    f"remote prefills, wall {wall:.2f} s")
                await no_leak(f"disagg serve (b) {mode}", decode_inner, prefill)
                await reset_prefix_caches(decode_inner, prefill)
            log(f"disagg serve (b) socket, Llama-3-8B width 4 layers f32 [{gpu_name}]: {stream_line(pair)}")
            check_launches("disagg serve (b)", path, stray)
            # the in-process worker leaves, with its runtime: a pull it had
            # parked must not take the next request (the broker nacks it when
            # the connection closes)
            for stop in (pair.worker.stop, pair.rts[1]._shutdown_hook):
                await stop()
                pair.stops.remove(stop)
            await prefill.shutdown()

            # (c) the same queue, served by a prefill worker process
            ici.is_local = lambda worker_id: False
            got_c = await disagg_process(pair, cfg, requests, gpu_name)
            same_streams("disagg serve (c) two processes, Llama-3-8B width 4 layers f32", got_c, baseline,
                         "the aggregated engine's")
            await no_leak("disagg serve (c)", decode_inner)
        finally:
            ici.is_local = local_ici
            await pair.close()
            await decode_inner.shutdown()
            await prefill.shutdown()

    asyncio.run(run_bc())
    free()
    t0 = lap("disagg serve (b) (c)", t0)

    async def run_b_int8():
        local_ici = ici.is_local
        ici.is_local = lambda worker_id: False
        cfg = dataclasses.replace(llama4(), kv_cache_dtype="int8")
        decode_inner = AsyncTorchEngine(cfg)
        prefill = AsyncTorchEngine(prefill_engine_config(cfg))
        pair = DisaggPair("disagg-b8", cfg.model_id)
        try:
            await decode_inner.start()
            await prefill.start()
            baseline, _ = await serve_on(decode_inner, [fresh(r) for r in requests])
            await reset_prefix_caches(decode_inner)
            await pair.start(decode_inner, prefill)
            results, wall = await serve_on(pair.decode, [fresh(r) for r in requests])
            disagg_gates("disagg serve (b) int8", pair, results, requests)
            await no_leak("disagg serve (b) int8", decode_inner, prefill)
            differ = stream_diffs({rid: r[:2] for rid, r in results.items()}, baseline)
            log(f"disagg serve (b) socket streamed, Llama-3-8B width 4 layers bf16, int8 KV cache [{gpu_name}]: "
                f"{len(requests) - len(differ)}/{len(requests)} streams equal the aggregated engine's (bf16; first "
                f"divergences {differ[:4]}); {stream_line(pair)}")
        finally:
            ici.is_local = local_ici
            await pair.close()
            await decode_inner.shutdown()
            await prefill.shutdown()

    asyncio.run(run_b_int8())
    free()
    t0 = lap("disagg serve (b) int8", t0)

    # (d) MLA over ici
    async def run_d():
        cfg = dataclasses.replace(mla_serve_config(), model_id="tiny-mla:" + json.dumps(
            dict(DEEPSEEK_V2_LITE, num_layers=4, dtype="f32", moe_capacity_factor=11.0)))
        mla_requests = serve_requests(DEEPSEEK_V2_LITE["vocab_size"])
        decode_inner = AsyncTorchEngine(cfg)
        prefill = AsyncTorchEngine(prefill_engine_config(cfg))
        pair = DisaggPair("disagg-d", cfg.model_id)
        try:
            await decode_inner.start()
            await prefill.start()
            baseline, _ = await serve_on(decode_inner, [fresh(r) for r in mla_requests])
            await reset_prefix_caches(decode_inner)
            await pair.start(decode_inner, prefill)
            path, stray = only("K5", "K6")
            zero(path, stray)
            tallies = replay_tally(decode_inner, path)
            captures = decode_inner.runner.compile_monitor.compiles
            pre_mon = prefill.runner.compile_monitor
            pre_captures = (pre_mon.compiles, pre_mon.compile_s)
            transfers = ici.total_transfers()
            results, wall = await serve_on(pair.decode, [fresh(r) for r in mla_requests])
            launches = check_launches("disagg serve (d)", path, stray)
            remote, local = disagg_gates("disagg serve (d)", pair, results, mla_requests)
            same_streams("disagg serve (d) MLA ici, DeepSeek-V2-Lite width 4 layers f32",
                         {rid: r[:2] for rid, r in results.items()}, {rid: r[:2] for rid, r in baseline.items()},
                         "the aggregated engine's")
            dec = {n: v - tallies[n] for n, v in replay_tally(decode_inner, path).items()}
            captured = decode_inner.runner.compile_monitor.compiles - captures
            pre = {n: launches[n] - dec[n] for n in path}
            if captured or pre["K6"] <= 0 or pre["K5"] != 0 or dec["K5"] <= 0:
                raise AssertionError(f"disagg serve (d): decode engine captured {captured} graphs; prefill engine "
                                     f"{pre}, decode engine {dec}")
            await no_leak("disagg serve (d)", decode_inner, prefill)
            log(f"disagg serve (d) MLA ici, DeepSeek-V2-Lite width 4 layers f32 [{gpu_name}]: {remote} remote "
                f"prefills, {local} local, {ici.total_transfers() - transfers} ici transfers of the latent pages; "
                f"wall {wall:.2f} s; launches: prefill engine K6 {pre['K6']}, decode engine K5 {dec['K5']} K6 "
                f"{dec['K6']} (local prefills)")
            return launches
        finally:
            await pair.close()
            await decode_inner.shutdown()
            await prefill.shutdown()

    out["disagg MLA"] = asyncio.run(run_d())
    free()
    lap("disagg serve (d)", t0)
    return out


async def disagg_process(pair, cfg, requests, gpu_name: str) -> dict:
    """(c): ``python -m dynamo_tpu_torch.components.prefill_worker`` on
    ``cfg``'s model in a subprocess on the same card, joined to ``pair``'s
    broker and namespace; serves ``requests`` through ``pair.decode`` once
    the worker's queue pull is parked, then SIGTERM, after which the process
    must exit with code 0 within 60 s. Returns {rid: (tokens, finish)}."""
    import signal
    import subprocess
    import tempfile

    from dynamo_tpu_torch.llm.remote_prefill import prefill_queue_name

    loop = asyncio.get_running_loop()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    pcfg = prefill_engine_config(cfg)
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.components.prefill_worker", cfg.model_id, "--namespace",
           pair.ns, "--cplane", pair.addr, "--page-size", str(pcfg.page_size), "--num-pages", str(pcfg.num_pages),
           "--max-seqs", str(pcfg.max_seqs), "--max-model-len", str(pcfg.max_model_len)]
    queue = prefill_queue_name(pair.ns, pair.model)
    t0 = time.monotonic()
    with tempfile.TemporaryFile() as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)

        def tail() -> str:
            err.seek(0)
            return err.read()[-3000:].decode(errors="replace")

        try:
            while not (await pair.decode.drt.cplane.queue_info(queue))["waiters"]:
                if proc.poll() is not None or time.monotonic() - t0 > 300:
                    raise AssertionError(f"disagg serve (c): prefill worker not ready (exit {proc.poll()}): {tail()}")
                await asyncio.sleep(0.2)
            ready_s = time.monotonic() - t0
            before = (pair.decode.remote_prefills, pair.decode.local_prefills)
            parts = pair.decode.kv_server.parts_received
            results, wall = await serve_on(pair.decode, [fresh(r) for r in requests])
            remote, _ = disagg_gates("disagg serve (c)", pair, results, requests, before)
            proc.send_signal(signal.SIGTERM)
            rc = await loop.run_in_executor(None, proc.wait, 60)
            if rc != 0:
                raise AssertionError(f"disagg serve (c): the prefill worker process exited {rc}: {tail()}")
        finally:
            if proc.poll() is None:
                proc.kill()
                await loop.run_in_executor(None, proc.wait)
    log(f"disagg serve (c) two processes [{gpu_name}]: `python -m dynamo_tpu_torch.components.prefill_worker` ready in "
        f"{ready_s:.1f} s; {remote} remote prefills over the data plane in "
        f"{pair.decode.kv_server.parts_received - parts} streamed parts, wall {wall:.2f} s; exit 0 on SIGTERM")
    return {rid: r[:2] for rid, r in results.items()}


# ---------------- routed serve: KV-aware routing across worker replicas ----------------

ROUTED_NS = "routed"
ROUTED_PAGE_SIZE = 16  # the worker's default and the processors' kv_block_size
# bench.py run_routing_parity: sessions, turns, prompt tokens, output tokens, history cap
ROUTED_SESSIONS, ROUTED_TURNS, ROUTED_PLEN, ROUTED_OUT, ROUTED_CAP = 4, 3, 3072, 8, 3600
# bench.py run_fleet_prefix at serving geometry: sessions, shared prefix, tail
PULL_SESSIONS, PULL_SHARED, PULL_TAIL = 3, 1536, 127
ROUTER_INTERVAL_S = 0.5  # the kv router's scrape interval (its aggregator's)


def vocab_of(g) -> int:
    return json.loads(g.workers[0].engine_config.model_id.split(":", 1)[1])["vocab_size"]


def routed_config(**geometry):
    """A worker engine of the routed serve: Llama-3-8B geometry (changed by
    ``geometry``), page size 16, 4096 pages (every prompt of every round
    stays cached), 8 slots, 4096 positions, one prefill lane (the traffic
    comes one request at a time, and each lane count is a graph to
    capture), every step graph captured first."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    return EngineConfig(model_id="tiny:" + json.dumps(dict(LLAMA3_8B, **geometry)), device="cuda",
                        page_size=ROUTED_PAGE_SIZE, num_pages=4096, max_seqs=8, max_model_len=4096, prefill_lanes=1,
                        warmup=True)


class RoutedGraph:
    """On the running loop: the port's broker on localhost; two
    WorkerServices on ``config`` (each on its own DistributedRuntime,
    registering the model ``name``); a ``kv`` and, when asked, a ``random``
    ProcessorService over them; a FrontendService on an ephemeral port; and
    a client runtime with clients to each processor and to the workers.
    ``served[worker id]`` lists the request ids each worker's backend
    took. ``close`` stops everything still running."""

    def __init__(self):
        self.stops, self.served, self.rts, self.workers = [], {}, [], []

    async def runtime(self):
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        rt = DistributedRuntime(cplane_address=self.addr)
        await rt.connect()
        self.stops.append(rt._shutdown_hook)
        return rt

    async def start(self, config, name: str, routings=("kv", "random"), frontend: bool = True):
        from dynamo_tpu_torch.components.frontend import FrontendService
        from dynamo_tpu_torch.components.processor import ProcessorService
        from dynamo_tpu_torch.components.worker import WorkerService
        from dynamo_tpu_torch.cplane.broker import Broker
        from dynamo_tpu_torch.frontends.pipeline import card_for_model

        self.broker = Broker()
        self.addr = f"127.0.0.1:{await self.broker.start()}"
        self.stops.append(self.broker.stop)
        card = card_for_model(config.model_id, config.max_model_len)
        card.display_name, card.kv_block_size = name, config.page_size
        self.name = name
        for _ in range(2):
            rt = await self.runtime()
            svc = WorkerService(rt, ROUTED_NS, "backend", card, config)
            await svc.start()
            self.stops.append(svc.stop)
            wid = rt.primary_lease.lease_id
            self.rts.append(rt)
            self.workers.append(svc)
            self.served[wid] = []
            self._record(svc, wid)
        self.ids = [rt.primary_lease.lease_id for rt in self.rts]
        self.procs = {}
        for routing in routings:
            proc = ProcessorService(await self.runtime(), ROUTED_NS, component=f"proc-{routing}",
                                    worker_component="backend", kv_block_size=config.page_size, routing=routing)
            await proc.start()
            if proc.router is not None:
                proc.router.aggregator.interval = ROUTER_INTERVAL_S
                proc.router.aggregator.scrape_timeout = 0.1
            self.stops.append(proc.stop)
            self.procs[routing] = proc
        self.client_rt = await self.runtime()
        self.clients = {r: await self.client_rt.client(ROUTED_NS, f"proc-{r}", "generate") for r in routings}
        self.worker_client = await self.client_rt.client(ROUTED_NS, "backend", "generate")
        for c in (*self.clients.values(), self.worker_client):
            await c.wait_for_instances(60)
        while len(self.worker_client.instance_ids()) < 2:
            await asyncio.sleep(0.05)
        self.frontend = None
        if frontend:
            self.frontend = FrontendService(await self.runtime(), host="127.0.0.1", port=0)
            self.port = await self.frontend.start()
            self.stops.append(self.frontend.stop)
        return self

    def _record(self, svc, wid):
        generate = svc.backend.generate

        async def recording(pre):
            self.served[wid].append(pre.request_id)
            async for out in generate(pre):
                yield out

        svc.backend.generate = recording

    def worker_of(self, rid: str) -> int:
        got = [wid for wid, rids in self.served.items() if rid in rids]
        if len(got) != 1:
            raise AssertionError(f"routed serve: request {rid} served by {len(got)} workers")
        return got[0]

    async def live_instances(self) -> int:
        backend = self.frontend._backends.get(self.name)
        return 0 if backend is None else await backend.live_instances()

    async def close(self):
        for stop in reversed(self.stops):
            try:
                await asyncio.wait_for(stop(), 60)
            except Exception as e:  # a runtime already shut down, a lost connection
                log(f"routed serve: cleanup {getattr(stop, '__qualname__', stop)}: {type(e).__name__}: {e}")
        self.stops.clear()


async def routed_request(client, rid: str, prompt: list, n: int = ROUTED_OUT, instance: int | None = None,
                         holder: tuple | None = None) -> dict:
    """One greedy request on the wire through ``client`` (random, or direct
    to ``instance``), ``holder`` = (pull address, blocks) attached; returns
    its tokens, first output's cached tokens, finish reason, client TTFT and
    wall."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    pre = PreprocessedRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True))
    if holder is not None:
        pre.kv_holder_addr, pre.kv_holder_blocks = holder
    t0 = time.monotonic()
    stream = await (client.direct(pre.to_wire(), instance) if instance is not None else client.random(pre.to_wire()))
    toks, cached, finish, ttft = [], None, None, None
    async for item in stream:
        if item.get("token_ids"):
            ttft = time.monotonic() - t0 if ttft is None else ttft
            toks += item["token_ids"]
        cached = item.get("cached_tokens", 0) if cached is None else cached
        finish = item.get("finish_reason") or finish
    return dict(tokens=toks, cached=cached or 0, finish=finish, ttft=ttft, wall=time.monotonic() - t0)


async def wait_for(pred, what: str, timeout: float = 30.0) -> float:
    """Poll ``pred()`` until true; returns the seconds it took, raises after
    ``timeout``."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"not within {timeout} s: {what}")
        await asyncio.sleep(0.01)
    return time.monotonic() - t0


def fetch_counts(svc) -> tuple:
    """A worker engine's (prefix pull hits, fallbacks, blocks, bytes, local
    prefill rows)."""
    s = svc._inner_engine.scheduler
    return s.prefix_fetch_hits, s.prefix_fetch_fallbacks, s.prefix_fetch_blocks, s.prefix_fetch_bytes, \
        s.local_prefill_rows


async def routing_arm(g, routing: str, seed: int, gpu_name: str, tally) -> dict:
    """(a): bench.py run_routing_parity's traffic through the ``routing``
    processor, sequentially, turn by turn; gates every stream's length and,
    under ``kv``, each later turn's worker and cached tokens. Returns the
    arm's prompts and numbers."""
    router = g.procs["kv"].router
    vocab = vocab_of(g)
    rng = np.random.default_rng(seed)
    hist = {s: rng.integers(0, vocab, ROUTED_PLEN).tolist() for s in range(ROUTED_SESSIONS)}
    held: dict = {}  # session -> (worker, [(prompt, tokens)] it served)
    recompute, ttfts, n_out, busy, prompts = 0, [], 0, 0.0, []
    rows0 = [fetch_counts(w)[4] for w in g.workers]
    t0 = tally()
    for t in range(ROUTED_TURNS):
        for s in range(ROUTED_SESSIONS):
            prompt, rid = hist[s], f"{routing}-{t}-{s}"
            prompts.append(prompt)
            res = await routed_request(g.clients[routing], rid, prompt)
            wid = g.worker_of(rid)
            if len(res["tokens"]) != ROUTED_OUT or res["finish"] != "length":
                raise AssertionError(f"routed serve (a) {routing} {rid}: {len(res['tokens'])} tokens, {res['finish']}")
            if routing == "kv" and t:
                want_w, past = held[s]
                want = expected_cached(ROUTED_PAGE_SIZE, past, prompt)
                if wid != want_w or res["cached"] != want:
                    raise AssertionError(f"routed serve (a) kv {rid}: worker {wid:x} (holder {want_w:x}), "
                                         f"cached {res['cached']} (want {want})")
            if held.get(s, (wid,))[0] == wid:
                held[s] = (wid, held.get(s, (wid, []))[1] + [(prompt, res["tokens"])])
            recompute += len(prompt) - res["cached"]
            ttfts.append(res["ttft"])
            n_out += len(res["tokens"])
            busy += res["wall"]
            # the holder's KV events reach the index, and a scrape refreshes
            # the loads (the optimistic bump), before the next placement
            await wait_for(lambda: router.indexer.find_matches_for_request(prompt).scores.get(wid, 0)
                           >= len(prompt) // ROUTED_PAGE_SIZE, f"{rid}'s blocks indexed")
            await asyncio.sleep(ROUTER_INTERVAL_S + 0.15)
            hist[s] = (prompt + res["tokens"] + [11 + t])[:ROUTED_CAP]
    rows = sum(fetch_counts(w)[4] for w in g.workers) - sum(rows0)
    if rows != recompute:
        raise AssertionError(f"routed serve (a) {routing}: {rows} prefill rows on the engines, {recompute} recomputed")
    t1 = tally()
    per = {f"{wid:x}": {k: t1[i][k] - t0[i][k] for k in t1[i]} for i, wid in enumerate(g.ids)}
    placed = {f"{wid:x}": len([r for r in g.served[wid] if r.startswith(routing + "-")]) for wid in g.ids}
    log(f"routed serve (a) {routing} routing, Llama-3-8B 32 layers bf16, {ROUTED_SESSIONS} sessions x "
        f"{ROUTED_TURNS} turns of {ROUTED_PLEN}+ tokens, {ROUTED_OUT} greedy tokens [{gpu_name}]: recomputed prefill "
        f"tokens {recompute} of {sum(map(len, prompts))}; client TTFT p50 {np.median(ttfts) * 1e3:.1f} ms (max "
        f"{max(ttfts) * 1e3:.1f}); {n_out / busy:.1f} output tok/s over the requests' own {busy:.2f} s; requests per "
        f"worker {json.dumps(placed)}; K1 / K2 replay tallies per worker {json.dumps(per)}; indexer backend "
        f"{router.indexer.backend}")
    return dict(recompute=recompute, ttft_p50=float(np.median(ttfts)), prompts=prompts)


async def fleet_pull(g, gpu_name: str, what: str, cold: bool) -> dict:
    """(b): bench.py run_fleet_prefix at this geometry. Each session's
    prompt (its own 1536-token shared prefix and a 127-token tail) warms
    worker A, then goes to worker B with the holder the kv router itself
    names (``best_remote_holder`` / ``pull_address``); with ``cold``, a
    third request of the same shape and no holder recomputes on B. Gates:
    B pulls exactly the router's holder blocks, recomputes only the rest,
    and no pull falls back. Returns {streams equal A's, ...}."""
    router = g.procs["kv"].router
    (a, b), (ida, idb) = g.workers, g.ids
    vocab = vocab_of(g)
    rng = np.random.default_rng(41)
    plen = PULL_SHARED + PULL_TAIL
    prompts = [rng.integers(0, vocab, PULL_SHARED).tolist() + rng.integers(0, vocab, PULL_TAIL).tolist()
               for _ in range(PULL_SESSIONS)]
    colds = [rng.integers(0, vocab, plen).tolist() for _ in range(PULL_SESSIONS)]
    fetcher = b._inner_engine.prefix_fetcher
    bytes0, secs0 = fetcher.bytes_received, fetcher.fetch_seconds.sum
    pull_ttfts, cold_ttfts, equal, pulled_total = [], [], 0, 0
    for i, p in enumerate(prompts):
        warm = await routed_request(g.worker_client, f"{what}-warm-{i}", p, instance=ida)
        await wait_for(lambda: router.indexer.find_matches_for_request(p).scores.get(ida, 0)
                       >= len(p) // ROUTED_PAGE_SIZE, f"{what} {i}: A's blocks indexed")
        await wait_for(lambda: router.pull_address(ida), f"{what}: A's pull address scraped")
        overlap = router._find_overlap(p)
        holder = router.best_remote_holder(overlap, idb)
        if holder is None or holder[0] != ida:
            raise AssertionError(f"routed serve (b) {what} {i}: the router names holder {holder}, want A {ida:x}")
        before = fetch_counts(b)
        res = await routed_request(g.worker_client, f"{what}-pull-{i}", p, instance=idb,
                                   holder=(router.pull_address(ida), holder[1]))
        after = fetch_counts(b)
        hits, falls, pulled, _, rows = (x - y for x, y in zip(after, before))
        if (hits, falls, pulled) != (1, 0, holder[1]) or rows != plen - pulled * ROUTED_PAGE_SIZE \
                or res["cached"] != pulled * ROUTED_PAGE_SIZE or len(res["tokens"]) != ROUTED_OUT:
            raise AssertionError(f"routed serve (b) {what} {i}: B pulled {pulled} blocks of the router's "
                                 f"{holder[1]} ({hits} hits, {falls} fallbacks), recomputed {rows} of {plen} tokens, "
                                 f"cached {res['cached']}, {len(res['tokens'])} tokens")
        pulled_total += pulled
        pull_ttfts.append(res["ttft"])
        equal += res["tokens"] == warm["tokens"]
        if cold:
            c = await routed_request(g.worker_client, f"{what}-cold-{i}", colds[i], instance=idb)
            if c["cached"] or len(c["tokens"]) != ROUTED_OUT:
                raise AssertionError(f"routed serve (b) {what} cold {i}: cached {c['cached']}")
            cold_ttfts.append(c["ttft"])
    nbytes, secs = fetcher.bytes_received - bytes0, fetcher.fetch_seconds.sum - secs0
    line = (f"routed serve (b) fleet prefix pull, {what} [{gpu_name}]: {PULL_SESSIONS} sessions of {PULL_SHARED} "
            f"shared + {PULL_TAIL} tail tokens; B pulled {pulled_total} blocks (each the router's holder count), "
            f"recomputed only past them, no fallback; {nbytes / 1e6:.1f} MB pulled in {secs:.3f} s of pulls "
            f"({nbytes / secs / 1e9:.2f} GB/s); pull TTFT p50 {np.median(pull_ttfts) * 1e3:.1f} ms")
    if cold:
        line += f" against a cold recompute's {np.median(cold_ttfts) * 1e3:.1f} ms"
    log(line + f"; {equal}/{PULL_SESSIONS} of B's greedy streams equal A's")
    return dict(equal=equal)


async def worker_death(g, gpu_name: str, prompts: list) -> None:
    """(c): B's runtime stops (its lease revoked). The kv router drops B from
    its index within its aggregator's interval; the frontend's next 8
    completions all land on A and none fails; /ready reports one live
    instance; once A stops too, /ready answers 503 and /live 200."""
    from dynamo_tpu_torch.tools.profile_http import http_call

    router = g.procs["kv"].router
    (ida, idb), b = g.ids, g.workers[1]
    if not any(idb in router.indexer.find_matches_for_request(p).scores for p in prompts):
        raise AssertionError("routed serve (c): B holds nothing in the index before its death")
    await g.rts[1]._shutdown_hook()
    g.stops.remove(g.rts[1]._shutdown_hook)
    dropped = await wait_for(lambda: not any(idb in router.indexer.find_matches_for_request(p).scores
                                             for p in prompts), "B dropped from the kv router's index",
                             timeout=router.aggregator.interval)
    # B's model card may go with its lease; A's registration refresh puts it back
    back = await wait_for_async(lambda: g.live_instances(), 1, "the frontend serving A alone", 20.0)
    for rids in g.served.values():
        rids.clear()
    rng = np.random.default_rng(5)
    bodies = [{"model": g.name, "prompt": rng.integers(0, vocab_of(g), 64).tolist(), "max_tokens": ROUTED_OUT,
               "temperature": 0, "ext": {"ignore_eos": True}} for _ in range(8)]
    answers = await asyncio.gather(*(asyncio.to_thread(http_call, g.port, "POST", "/v1/completions", body)
                                     for body in bodies))
    bad = [(s, r[:200]) for s, r in answers if s != 200 or json.loads(r)["usage"]["completion_tokens"] != ROUTED_OUT]
    if bad or len(g.served[ida]) != 8 or g.served[idb]:
        raise AssertionError(f"routed serve (c): failures {bad}; A served {len(g.served[ida])}, B "
                             f"{len(g.served[idb])}")
    status, body = await asyncio.to_thread(http_call, g.port, "GET", "/ready")
    ready = json.loads(body)
    if status != 200 or ready.get("instances") != {g.name: 1}:
        raise AssertionError(f"routed serve (c): /ready {status} {ready}")
    await b.engine.shutdown()  # its runtime is gone; free its engine now
    await g.rts[0]._shutdown_hook()
    g.stops.remove(g.rts[0]._shutdown_hook)

    async def unready():
        return (await asyncio.to_thread(http_call, g.port, "GET", "/ready"))[0]

    await wait_for_async(unready, 503, "/ready answering 503 once A is gone", 20.0)
    live = (await asyncio.to_thread(http_call, g.port, "GET", "/live"))[0]
    if live != 200:
        raise AssertionError(f"routed serve (c): /live {live} with no worker")
    log(f"routed serve (c) worker death [{gpu_name}]: B left the kv router's index {dropped * 1e3:.1f} ms after its "
        f"lease was revoked (aggregator interval {router.aggregator.interval * 1e3:.0f} ms); the frontend served A "
        f"alone {back:.2f} s after; 8/8 completions over HTTP on A, none failed; /ready 200 with one live instance, "
        f"then 503 once A stopped, /live 200")


async def wait_for_async(fn, want, what: str, timeout: float) -> float:
    t0 = time.monotonic()
    while await fn() != want:
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"routed serve: {what} within {timeout} s")
        await asyncio.sleep(0.05)
    return time.monotonic() - t0


async def dyn_processes(gpu_name: str, tmp: Path, device: str = "cuda") -> None:
    """(d): ``run '<2-layer f32>' --in dyn://routed.backend.generate --out
    torch`` as a second process on the card, on this process's broker. This
    process's frontend discovers the model; ``run --in batch:<file> --out
    dyn://...`` as a third process writes what an in-process engine on the
    same seed writes (the batch frontend samples, from a fresh engine's
    seeded generator: it runs first); greedy completions over HTTP equal the
    in-process engine's tokens (the text, and the wire's token ids); SIGINT
    ends the worker with code 0 and the frontend detaches the model."""
    import signal
    import subprocess

    from dynamo_tpu_torch.components.frontend import FrontendService
    from dynamo_tpu_torch.cplane.broker import Broker
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.frontends.pipeline import build_pipeline, card_for_model
    from dynamo_tpu_torch.launch import run
    from dynamo_tpu_torch.launch._run_impl import engine_config_for
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream, get_tokenizer
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.tools.profile_http import http_call
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    model_id = "tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=2, dtype="f32", vocab_size=256))
    endpoint = f"dyn://{ROUTED_NS}.backend.generate"
    broker = Broker()
    addr = f"127.0.0.1:{await broker.start()}"
    env = dict(os.environ, DYNTPU_CPLANE=addr,
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    loop = asyncio.get_running_loop()
    argv = ["run", model_id, "--in", endpoint, "--out", "torch", "--device", device]
    err_path = tmp / "dyn_worker.err"
    rt = fe = proc = None
    t0 = time.monotonic()
    try:
        with open(err_path, "wb") as err:
            proc = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.launch.run", *argv], cwd=ROOT, env=env,
                                    stdout=subprocess.DEVNULL, stderr=err)
        rt = DistributedRuntime(cplane_address=addr)
        await rt.connect()
        fe = FrontendService(rt, host="127.0.0.1", port=0)
        port = await fe.start()
        while model_id not in fe.service.manager.list_models() or not await fe._backends[model_id].live_instances():
            if proc.poll() is not None or time.monotonic() - t0 > 300:
                raise AssertionError(f"routed serve (d): the dyn:// worker never registered (exit {proc.poll()}): "
                                     f"{err_path.read_text()[-2000:]}")
            await asyncio.sleep(0.2)
        ready_s = time.monotonic() - t0
        # first, on the worker's fresh engine: batch through --out dyn://
        src = tmp / "dyn_prompts.jsonl"
        src.write_text(json.dumps({"text": "hello from the routed serve", "max_tokens": 12}) + "\n")
        batch = await loop.run_in_executor(None, lambda: subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "run", model_id, "--in", f"batch:{src}", "--out",
             endpoint], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300))
        if batch.returncode != 0:
            raise AssertionError(f"routed serve (d): batch through {endpoint} exited {batch.returncode}: "
                                 f"{batch.stderr[-2000:]}")
        rows = [json.loads(line) for line in src.with_suffix(".out.jsonl").read_text().splitlines()]
        args = run.build_parser().parse_args(argv)
        engine = AsyncTorchEngine(engine_config_for(args))  # this process, the same seed: the child's weights
        await engine.start()
        try:
            pipeline = build_pipeline(engine, card_for_model(model_id))
            pre, _ = pipeline.preprocessor.preprocess_chat(ChatCompletionRequest.from_dict(
                {"messages": [{"role": "user", "content": "hello from the routed serve"}], "max_tokens": 12}))
            chunks, n = [], 0
            async for out in pipeline.backend.generate(pre):
                chunks.append(out.text)
                n = out.cumulative_tokens
            if [(r["output"], r["tokens_out"]) for r in rows] != [("".join(chunks), n)]:
                raise AssertionError(f"routed serve (d): batch through dyn:// wrote {rows}, the in-process engine "
                                     f"{('' .join(chunks), n)}")
            # then greedy completions over HTTP through the discovered model
            rng = np.random.default_rng(17)
            prompts = [rng.integers(0, 256, k).tolist() for k in (5, 21, 40)]
            client = await rt.client(ROUTED_NS, "backend", "generate")
            for i, p in enumerate(prompts):
                want = await routed_request_engine(engine, f"d-{i}", p, 16)
                status, body = await asyncio.to_thread(
                    http_call, port, "POST", "/v1/completions",
                    {"model": model_id, "prompt": p, "max_tokens": 16, "temperature": 0, "ext": {"ignore_eos": True}})
                d = DecodeStream(get_tokenizer("byte"), prompt_ids=p)
                text = "".join(d.step(t) or "" for t in want)
                got = json.loads(body)["choices"][0]["text"] if status == 200 else body
                wire = await routed_request(client, f"w-{i}", p, n=16)
                if got != text or wire["tokens"] != want:
                    raise AssertionError(f"routed serve (d) {i}: HTTP text {got!r} / wire tokens {wire['tokens']} "
                                         f"against the in-process engine's {text!r} / {want}")
        finally:
            await engine.shutdown()
        proc.send_signal(signal.SIGINT)
        rc = await loop.run_in_executor(None, proc.wait, 60)
        if rc != 0:
            raise AssertionError(f"routed serve (d): the dyn:// worker exited {rc} on SIGINT: "
                                 f"{err_path.read_text()[-2000:]}")
        await wait_for(lambda: not fe.service.manager.list_models(), "the model detached after the worker exited")
        log(f"routed serve (d) dyn:// across processes [{gpu_name}]: `run {model_id[:24]}... --in {endpoint} --out "
            f"torch` discovered by this process's frontend in {ready_s:.1f} s; `run --in batch:<file> --out "
            f"{endpoint}` wrote the in-process engine's output; {len(prompts)} greedy completions x 16 tokens over "
            f"HTTP (text) and the wire (token ids) equal the in-process engine's; exit 0 on SIGINT, model detached")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            await loop.run_in_executor(None, proc.wait)
        if fe is not None:
            await fe.stop()
        if rt is not None:
            await rt._shutdown_hook()
        await broker.stop()


async def routed_request_engine(engine, rid: str, prompt: list, n: int) -> list:
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest

    toks = []
    async for out in engine.generate(EngineRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=n,
                                                                                     ignore_eos=True))):
        if out.token is not None:
            toks.append(out.token)
    return toks


def phase_routed_serve(torch, gpu_name: str, kernels: dict) -> dict:
    """KV-aware routing across two worker replicas on one card
    (``kernels``: {name: launcher} of every serving kernel). Two
    WorkerServices of Llama-3-8B geometry (32 layers, bf16, page size 16,
    4096 pages each, one prefill lane, every step graph captured first), a
    ``kv`` and a
    ``random`` ProcessorService and a FrontendService, over the port's
    broker on localhost, in this process:

      (a) bench.py run_routing_parity's traffic (4 sessions x 3 turns,
          3072-token prompts, 8 greedy tokens, each turn's history extended
          by its output and one token), once through each processor on its
          own seeded prompts; every stream ends with 8 tokens; under ``kv``
          every later turn lands on the worker that served the session's
          previous one, with the cached tokens ``expected_cached`` gives;
          prints recomputed prefill tokens, client TTFT p50, tok/s, each
          worker's K1 / K2 replay tallies and the indexer's backend, which
          must be the native tree, whose scores on the phase's recorded
          event stream equal the Python tree's;
      (b) bench.py run_fleet_prefix at this geometry: 3 sessions warm worker
          A, then go to worker B with the holder the kv router names; B
          pulls exactly the router's holder blocks, recomputes only past
          them, no pull falls back; pull TTFT against a cold recompute,
          bytes and GB/s pulled, the streams equal to A's (bf16); then again
          at 2 layers in f32, where every stream of B equals A's;
      (c) worker death (``worker_death``);
      (d) dyn:// across processes (``dyn_processes``).

    Returns {"routed serve": {K1, K2: launches over (a) and (b)}}."""
    import gc
    import tempfile

    from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, RouterEvent

    path = {n: kernels[n] for n in ("K1", "K2")}
    stray = {n: fn for n, fn in kernels.items() if n not in path}
    out = {}
    t0 = time.monotonic()

    async def run_abc():
        g = RoutedGraph()
        try:
            await g.start(routed_config(), "llama-3-8b-routed")
            for w in g.workers:
                if not w._inner_engine.warmup_s:
                    raise AssertionError("routed serve: a worker engine did not capture its graphs first")
            router = g.procs["kv"].router
            if router.indexer.backend != "native":
                raise AssertionError(f"routed serve: the kv router took the {router.indexer.backend} tree")
            events = []
            await g.client_rt.cplane.subscribe(f"{ROUTED_NS}|backend.kv_events", lambda msg: events.append(msg))
            log(f"routed serve: two workers up in {time.monotonic() - t0:.1f} s [{gpu_name}]; "
                + "; ".join(f"worker {wid:x}: {graphs_line(w._inner_engine)}" for wid, w in zip(g.ids, g.workers)))

            def tally():
                return [replay_tally(w._inner_engine, path) for w in g.workers]

            for fn in (*path.values(), *stray.values()):
                fn.launches = 0
            start = tally()
            captures = [w._inner_engine.runner.compile_monitor.compiles for w in g.workers]
            kv = await routing_arm(g, "kv", 3, gpu_name, tally)
            rand = await routing_arm(g, "random", 4, gpu_name, tally)
            log(f"routed serve (a) [{gpu_name}]: recomputed prefill tokens kv {kv['recompute']}, random "
                f"{rand['recompute']} (recompute_ratio {kv['recompute'] / rand['recompute']:.4f}); client TTFT p50 kv "
                f"{kv['ttft_p50'] * 1e3:.1f} ms, random {rand['ttft_p50'] * 1e3:.1f} ms")
            # the native tree against the Python tree on the recorded events
            await asyncio.sleep(0.2)
            py = KvIndexer(ROUTED_PAGE_SIZE, use_native=False)
            for msg in events:
                py.apply_event(RouterEvent.from_wire(msg["payload"]))
            differ = [i for i, p in enumerate(kv["prompts"] + rand["prompts"])
                      if router.indexer.find_matches_for_request(p).scores != py.find_matches_for_request(p).scores]
            if differ or not events:
                raise AssertionError(f"routed serve (a): native scores differ from the Python tree's on {differ} "
                                     f"({len(events)} events)")
            log(f"routed serve (a): the native tree's scores equal the Python tree's on the {len(events)} recorded "
                f"KV events, for all {len(kv['prompts']) + len(rand['prompts'])} prompts")
            await fleet_pull(g, gpu_name, "Llama-3-8B 32 layers bf16", cold=True)
            launches = {n: fn.launches for n, fn in path.items()}
            bad = {n: fn.launches for n, fn in stray.items() if fn.launches}
            end = tally()
            per = [{n: end[i][n] - start[i][n] for n in path} for i in range(2)]
            if bad or min(launches.values()) <= 0 or min(v for p in per for v in p.values()) <= 0:
                raise AssertionError(f"routed serve: launches {launches}, per worker {per}, off the path {bad}")
            if [w._inner_engine.runner.compile_monitor.compiles for w in g.workers] != captures:
                raise AssertionError("routed serve: a worker captured a graph while serving")
            log(f"routed serve launches over (a) and (b): {json.dumps(launches)}; per worker (replay tallies) "
                f"{json.dumps({f'{wid:x}': p for wid, p in zip(g.ids, per)})}; no other kernel; no capture")
            await worker_death(g, gpu_name, kv["prompts"] + rand["prompts"])
            return launches
        finally:
            await g.close()

    out["routed serve"] = asyncio.run(run_abc())
    gc.collect()
    torch.cuda.empty_cache()
    t0 = lap("routed serve (a) (b) (c)", t0)

    async def run_b_f32():
        g = RoutedGraph()
        try:
            await g.start(dataclasses.replace(routed_config(num_layers=2, dtype="f32"), warmup=False),
                          "llama-3-8b-2l-f32", routings=("kv",), frontend=False)
            res = await fleet_pull(g, gpu_name, "Llama-3-8B width 2 layers f32", cold=False)
            if res["equal"] != PULL_SESSIONS:
                raise AssertionError(f"routed serve (b) f32: {res['equal']}/{PULL_SESSIONS} of B's streams equal A's")
        finally:
            await g.close()

    asyncio.run(run_b_f32())
    gc.collect()
    torch.cuda.empty_cache()
    t0 = lap("routed serve (b) f32", t0)
    with tempfile.TemporaryDirectory() as tmp:
        asyncio.run(dyn_processes(gpu_name, Path(tmp)))
    torch.cuda.empty_cache()
    lap("routed serve (d)", t0)
    return out


# ---------------------------------------------------------------- KV tiers and live migration

TIER_PAGES = 1100  # (a): four 3072-token sessions (772 pages) and five 4096-token fillers do not fit
TIER_HOST_BLOCKS = 1024
TIER_SESSIONS, TIER_PLEN, TIER_OUT = 4, 3072, 16
TIER_FILLER_LENS = (4096, 4096, 4096, 4096, 2048)  # 1152 blocks: the device keeps none of the sessions'
DISK_PAGES, DISK_HOST_BLOCKS, DISK_SESSIONS, DISK_FILLERS = 500, 64, 3, 2
DISK_FILLER_LEN = 4096
DISK_BUDGET = 2 << 30  # everything demoted in (b): about 1.15 GB of int8 blocks
DISK_CORRUPT_BLOCK = 100  # the last session's block whose file (b) corrupts
MIG_STREAMS, MIG_OUT, MIG_AT = 8, 64, 16  # (c): 8 streams, 64 out, migrated after 16
MIG_PLEN = (1024, 2048)  # (c) and (d): prompt lengths drawn in this range
DRAIN_STREAMS, DRAIN_OUT = 4, 384  # (d): long enough that every stream is still decoding at its turn
LADDER_PLEN, LADDER_OUT, LADDER_AT = 1024, 64, 4  # f32 identity over 64 tokens, as preempt serve (b) holds it


def ladder_model_id() -> str:
    """The ladder's model: Llama-3-8B width, 2 layers, f32 (a depth cut:
    identity, not speed)."""
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    return "tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=2, dtype="f32"))


def tier_config(**over):
    """An engine of the tiers and migrate serve phases: Llama-3-8B geometry,
    32 layers, bf16, page size 16, 8 slots, one prefill lane (one graph a
    shape to capture), prefill chunks padded to one bucket of 512 rows (a
    row's arithmetic then does not depend on the chunk it rides), every step
    graph captured first."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    return EngineConfig(**{**dict(model_id="tiny:" + json.dumps(LLAMA3_8B), device="cuda", page_size=16,
                                  num_pages=TIER_PAGES, max_seqs=8, max_model_len=4352, prefill_lanes=1,
                                  prefill_buckets=(512,), migration_timeout_s=60.0, warmup=True), **over})


def greedy(rid: str, prompt: list, n: int, **kw):
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import EngineRequest

    return EngineRequest(rid, list(prompt), SamplingParams(temperature=0.0, max_tokens=n, ignore_eos=True), **kw)


async def one_stream(engine, req) -> dict:
    """{tokens, reason, ttft (s), cached (first output's cached tokens)}."""
    t0 = time.monotonic()
    got = dict(tokens=[], reason=None, ttft=None, cached=None)
    async for out in engine.generate(req):
        if got["cached"] is None:
            got["cached"] = out.cached_tokens
        if out.token is not None:
            if got["ttft"] is None:
                got["ttft"] = time.monotonic() - t0
            got["tokens"].append(out.token)
        got["reason"] = out.finish_reason
    return got


def set_tiers(engine, on: bool) -> None:
    """Attach (or detach: a no-tier arm on the same engine and graphs) the
    engine's host tier under its allocator; on the engine thread."""
    engine.allocator.offload = engine.offload if on else None


def ms(v: float) -> str:
    return f"{v * 1e3:.1f} ms"


def phase_tiers_serve(torch, gpu_name: str, model, kernels: dict) -> tuple[dict, object]:
    """The KV tier ladder at full width (``kernels``: {name: launcher} of
    every serving kernel; ``model``: a Llama-3-8B geometry model, 32 layers,
    bf16, shared by the engines of this phase and the next). Returns ({K1,
    K2: launches over (a) and (b)}, the tiers engine, kept for migrate
    serve).

      (a) host tier: an engine of ``TIER_PAGES`` pages (too few for four
          3072-token sessions and the fillers) over a host tier of 1024
          blocks, ``offload_watermark`` 0.90. Four sessions (16 tokens out),
          fillers (1152 blocks) that push the sessions' blocks to the host
          tier, each session again: every resume takes at least 191 blocks
          from the host tier, the restored pages equal the saved ones bit for
          bit (session 0, gathered both times), each session once more from
          the device (a device hit): tokens equal the resume's; then the same
          engine with its tier detached and its prefix cache dropped serves
          the sessions as a no-tier arm (recompute). Prints the TTFTs, saves,
          loads, transfer_s, the pinned slab, the copies' device GB/s; the
          watermark drained blocks and nothing was preempted;
      (b) disk tier (the reference's run_kv_tiers): int8 KV cache (a disk
          round trip is bit-exact), 500 pages, a host tier of 64 blocks, a 2
          GiB disk budget. Three sessions park while two fillers push their
          blocks to disk; the resumes restore from disk; the last session's
          block 100 file is corrupted first: its restore stops there and the
          tail recomputes. The no-tier arm (tiers detached, prefix cache
          dropped) recomputes: every resume's tokens equal the no-tier arm's
          and the sessions' first tokens; disk_restore_hits >= 1, the disk's
          resident bytes within the budget. Prints the TTFTs and the
          restore's seconds."""
    import gc

    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.models.llama import LlamaModel

    path = {n: kernels[n] for n in ("K1", "K2")}
    stray = {n: fn for n, fn in kernels.items() if n not in path}
    vocab = model.config.vocab_size
    rng = np.random.default_rng(19)
    t0 = time.monotonic()

    def fresh_prompts(n, length):
        return [rng.integers(1, vocab, length).tolist() for _ in range(n)]

    async def serve_list(engine, reqs) -> list:
        return [await one_stream(engine, r) for r in reqs]

    # (a) the host tier
    sessions = fresh_prompts(TIER_SESSIONS, TIER_PLEN)
    fillers = [rng.integers(1, vocab, n).tolist() for n in TIER_FILLER_LENS]
    engine = AsyncTorchEngine(tier_config(host_cache_blocks=TIER_HOST_BLOCKS), model=model)

    async def run_a():
        await engine.start()
        pool, sched = engine.offload, engine.scheduler
        pool.timing = True
        log(f"tiers serve (a): engine up [{gpu_name}]: {graphs_line(engine)}; host tier {pool.capacity_blocks} blocks, "
            f"pinned slab {pool.pinned_bytes / 2**30:.3f} GiB")
        tally0 = replay_tally(engine, path)
        captures = engine.runner.compile_monitor.compiles
        for fn in (*path.values(), *stray.values()):
            fn.launches = 0
        first = await serve_list(engine, [greedy(f"s{i}", p, TIER_OUT) for i, p in enumerate(sessions)])
        ps = engine.config.page_size
        full = TIER_PLEN // ps - 1  # the last block always prefills

        def gather_session0():
            from dynamo_tpu_torch.llm.tokens import TokenSequence

            hashes = [b.sequence_hash for b in TokenSequence(sessions[0], ps).blocks[:full]]
            pages = [engine.allocator.cached_page(h) for h in hashes]
            if None in pages:
                raise AssertionError("tiers serve (a): session 0's blocks are not all cached on the device")
            return engine.runner.extract_pages_device(np.asarray(pages, np.int32)).data.clone()

        saved = await engine.run_on_engine(gather_session0)
        await serve_list(engine, [greedy(f"f{i}", p, 1) for i, p in enumerate(fillers)])
        loads = []
        resumed = []
        for i, p in enumerate(sessions):
            before = pool.loads
            resumed.append(await one_stream(engine, greedy(f"r{i}", p, TIER_OUT)))
            loads.append(pool.loads - before)
        restored = await engine.run_on_engine(gather_session0)
        same_pages = bool(torch.equal(saved, restored))
        del saved, restored
        device = await serve_list(engine, [greedy(f"d{i}", p, TIER_OUT) for i, p in enumerate(sessions)])
        d2h_h2d = pool.device_seconds()
        snap = engine.resource_snapshot()
        await engine.run_on_engine(lambda: (set_tiers(engine, False), engine.allocator.reset_prefix_cache()))
        notier = await serve_list(engine, [greedy(f"n{i}", p, TIER_OUT) for i, p in enumerate(sessions)])
        await engine.run_on_engine(lambda: (engine.allocator.reset_prefix_cache(), set_tiers(engine, True)))
        launches = {n: fn.launches for n, fn in path.items()}
        bad = {n: fn.launches for n, fn in stray.items() if fn.launches}
        tally = {n: v - tally0[n] for n, v in replay_tally(engine, path).items()}
        if engine.runner.compile_monitor.compiles != captures:
            raise AssertionError("tiers serve (a): a graph was captured while serving")
        if bad or min(launches.values()) <= 0 or min(tally.values()) <= 0:
            raise AssertionError(f"tiers serve (a): launches {launches}, replay tallies {tally}, off the path {bad}")
        for what, streams in (("first", first), ("resume", resumed), ("device hit", device), ("no tier", notier)):
            short = [i for i, s in enumerate(streams) if len(s["tokens"]) != TIER_OUT or s["reason"] != "length"]
            if short:
                raise AssertionError(f"tiers serve (a): {what} streams {short} did not end with {TIER_OUT} tokens")
        cached = [s["cached"] for s in resumed]
        if min(loads) < full or min(cached) < full * ps:
            raise AssertionError(f"tiers serve (a): resumes took {loads} host blocks, cached {cached} tokens; "
                                 f"each needs {full} blocks")
        if not same_pages:
            raise AssertionError("tiers serve (a): session 0's restored pages differ from its saved pages")
        differ = [i for i in range(TIER_SESSIONS) if resumed[i]["tokens"] != device[i]["tokens"]]
        if differ:
            raise AssertionError(f"tiers serve (a): resumes {differ} differ from the device hit's tokens")
        if sched.offload_pressure_blocks <= 0 or sched.preempt_count:
            raise AssertionError(f"tiers serve (a): watermark drained {sched.offload_pressure_blocks} blocks, "
                                 f"{sched.preempt_count} preemptions")
        (d2h_s, d2h_b), (h2d_s, h2d_b) = d2h_h2d["d2h"], d2h_h2d["h2d"]
        med = lambda streams: float(np.median([s["ttft"] for s in streams]))  # noqa: E731
        log(f"tiers serve (a) host tier, Llama-3-8B 32 layers bf16 [{gpu_name}]: resume TTFT p50 {ms(med(resumed))} "
            f"(each {[round(s['ttft'] * 1e3, 1) for s in resumed]} ms) against the no-tier arm's recompute "
            f"{ms(med(notier))}, the first serve's {ms(med(first))} and a device hit's {ms(med(device))}; resumes "
            f"took {loads} blocks from the host tier (cached tokens {cached}); session 0's restored pages equal "
            f"its saved pages bit for bit; resume tokens equal the device hit's ({TIER_SESSIONS}/{TIER_SESSIONS}), "
            f"the no-tier arm's {sum(resumed[i]['tokens'] == notier[i]['tokens'] for i in range(TIER_SESSIONS))}"
            f"/{TIER_SESSIONS} (bf16)")
        log(f"tiers serve (a) transfers [{gpu_name}]: saves {snap['offload_saves']}, loads {snap['offload_loads']}, "
            f"drops {snap['offload_drops']}, transfer_s {pool.transfer_s:.4f} engine-thread s "
            f"({pool.transfer_s / max(1, snap['offload_saves'] + snap['offload_loads']) * 1e3:.3f} ms a block); "
            f"device copies: D2H {d2h_b / 1e9:.3f} GB in {d2h_s * 1e3:.1f} ms ({d2h_b / max(d2h_s, 1e-9) / 1e9:.2f} "
            f"GB/s), H2D {h2d_b / 1e9:.3f} GB in {h2d_s * 1e3:.1f} ms ({h2d_b / max(h2d_s, 1e-9) / 1e9:.2f} GB/s); "
            f"pinned {pool.pinned_bytes / 2**30:.3f} GiB; watermark 0.90 drained "
            f"{sched.offload_pressure_blocks} blocks, {sched.preempt_count} preemptions; K1 {tally['K1']}, "
            f"K2 {tally['K2']} replayed")
        return launches

    out_a = asyncio.run(run_a())
    t0 = lap("tiers serve (a)", t0)

    # (b) the disk tier, over the int8 cache
    int8 = LlamaModel(dataclasses.replace(model.config, kv_cache_dtype="int8"), device="meta")
    int8.load_state_dict(model.state_dict(), assign=True)
    disk_engine = AsyncTorchEngine(tier_config(num_pages=DISK_PAGES, kv_cache_dtype="int8", max_seqs=4,
                                               host_cache_blocks=DISK_HOST_BLOCKS, disk_cache_bytes=DISK_BUDGET),
                                   model=int8)
    dsessions = fresh_prompts(DISK_SESSIONS, TIER_PLEN)
    dfillers = fresh_prompts(DISK_FILLERS, DISK_FILLER_LEN)

    async def run_b():
        await disk_engine.start()
        disk, sched = disk_engine.offload.disk, disk_engine.scheduler
        tally0 = replay_tally(disk_engine, path)
        captures = disk_engine.runner.compile_monitor.compiles
        for fn in (*path.values(), *stray.values()):
            fn.launches = 0
        first = await serve_list(disk_engine, [greedy(f"s{i}", p, TIER_OUT) for i, p in enumerate(dsessions)])
        await serve_list(disk_engine, [greedy(f"f{i}", p, 1) for i, p in enumerate(dfillers)])
        await asyncio.get_running_loop().run_in_executor(None, disk.flush)
        ps = disk_engine.config.page_size
        from dynamo_tpu_torch.llm.tokens import TokenSequence

        blocks = [TokenSequence(p, ps).blocks for p in dsessions]
        on_disk = [sum(b.sequence_hash in disk for b in bl[: TIER_PLEN // ps - 1]) for bl in blocks]
        corrupt = blocks[-1][DISK_CORRUPT_BLOCK].sequence_hash
        with open(disk._path(corrupt), "r+b") as f:
            f.seek(4096)
            f.write(b"\x00\x01\x02\x03")
        resumed, hits, restored = [], [], []
        for i, p in enumerate(dsessions):
            h0, b0 = sched.disk_restore_hits, sched.disk_restore_blocks
            resumed.append(await one_stream(disk_engine, greedy(f"r{i}", p, TIER_OUT)))
            hits.append(sched.disk_restore_hits - h0)
            restored.append(sched.disk_restore_blocks - b0)
        snap = disk_engine.resource_snapshot()
        await disk_engine.run_on_engine(lambda: (set_tiers(disk_engine, False),
                                                  disk_engine.allocator.reset_prefix_cache()))
        notier = await serve_list(disk_engine, [greedy(f"n{i}", p, TIER_OUT) for i, p in enumerate(dsessions)])
        launches = {n: fn.launches for n, fn in path.items()}
        bad = {n: fn.launches for n, fn in stray.items() if fn.launches}
        tally = {n: v - tally0[n] for n, v in replay_tally(disk_engine, path).items()}
        if disk_engine.runner.compile_monitor.compiles != captures:
            raise AssertionError("tiers serve (b): a graph was captured while serving")
        if bad or min(launches.values()) <= 0 or min(tally.values()) <= 0:
            raise AssertionError(f"tiers serve (b): launches {launches}, replay tallies {tally}, off the path {bad}")
        for what, streams in (("first", first), ("resume", resumed), ("no tier", notier)):
            short = [i for i, s in enumerate(streams) if len(s["tokens"]) != TIER_OUT or s["reason"] != "length"]
            if short:
                raise AssertionError(f"tiers serve (b): {what} streams {short} did not end with {TIER_OUT} tokens")
        differ = [i for i in range(DISK_SESSIONS)
                  if not (resumed[i]["tokens"] == notier[i]["tokens"] == first[i]["tokens"])]
        if differ:
            raise AssertionError(f"tiers serve (b): resumes {differ} differ from the no-tier arm's tokens")
        if snap["disk_restore_hits"] < 1 or snap["disk_bytes_resident"] > snap["disk_budget_bytes"]:
            raise AssertionError(f"tiers serve (b): restore hits {snap['disk_restore_hits']}, resident "
                                 f"{snap['disk_bytes_resident']} of a {snap['disk_budget_bytes']}-byte budget")
        if restored[-1] != DISK_CORRUPT_BLOCK or snap["disk_io_errors"] < 1 or min(restored[:-1]) < TIER_PLEN // ps - 1:
            raise AssertionError(f"tiers serve (b): restores took {restored} blocks (the last must stop at its "
                                 f"corrupt block 100), {snap['disk_io_errors']} I/O errors")
        med = lambda streams: float(np.median([s["ttft"] for s in streams]))  # noqa: E731
        log(f"tiers serve (b) disk tier, Llama-3-8B 32 layers, int8 KV [{gpu_name}]: {on_disk} of each session's "
            f"blocks on disk after the fillers; resume TTFT {[round(s['ttft'] * 1e3, 1) for s in resumed]} ms "
            f"(p50 {ms(med(resumed[:-1]))} over the intact sessions) against the no-tier arm's recompute "
            f"{ms(med(notier))}; restores took {restored} blocks (the last stops at its corrupt file and recomputes "
            f"the tail), {snap['disk_restore_s']:.4f} s on the disk thread for {snap['disk_restores']} blocks "
            f"({snap['disk_restore_s'] / max(1, snap['disk_restores']) * 1e3:.3f} ms a block, "
            f"{(snap['disk_restores'] * disk.block_bytes) / max(snap['disk_restore_s'], 1e-9) / 1e9:.2f} GB/s "
            f"of int8 blocks); the disk holds {snap['disk_bytes_resident'] / 1e6:.1f} MB of its "
            f"{snap['disk_budget_bytes'] / 1e6:.1f} MB budget; spills {snap['disk_spills']}, I/O thread write "
            f"{disk.write_s:.2f} s; every resume's tokens equal the no-tier arm's and the first serve's; K1 "
            f"{tally['K1']}, K2 {tally['K2']} replayed")
        return launches

    try:
        out_b = asyncio.run(run_b())
    finally:
        asyncio.run(disk_engine.shutdown())
    del disk_engine, int8
    gc.collect()
    torch.cuda.empty_cache()
    lap("tiers serve (b)", t0)
    return {n: out_a[n] + out_b[n] for n in path}, engine


class StoppedDestination(Exception):
    """The destination engine stopped after relaying tokens (the ladder)."""


def phase_migrate_serve(torch, gpu_name: str, model, source, kernels: dict) -> dict:
    """Live migration between two engines on the card (``source``: the tiers
    engine, started, its tier detached for this phase; a destination engine
    on the same ``model``), each with a KvPullServer and a
    PrefixFetchClient on localhost. Returns {K1, K2: launches over (c)}.

      (c) 8 greedy streams (prompts of 1024-2048 tokens, 64 out) served
          uninterrupted on the source (the baseline), then again, each
          migrated to the destination after 16 tokens (all at once): every
          stream ends at full length, all 8 adoptions pulled their KV, the
          tokens salvaged counted, the streams equal to the baseline counted
          (bf16: the destination prefills the last history token where the
          source would have decoded it); pause p50 / p99 from freeze to the
          first continuation token. Then the ladder at Llama-3-8B width, 2
          layers, f32 (a depth cut: identity), each case ending with the
          uninterrupted run's tokens: a dropped seq_handoff part and a
          corrupt checksum fall back to recompute; a destination stopped
          after relaying tokens makes the source resume locally;
      (d) two WorkerServices (the source and the destination) on one broker
          with a kv processor: POST /admin/drain to the source while 4
          client streams decode on it: every stream ends at full length, the
          drain reports migrated > 0, the source leaves the router's
          index."""
    import gc

    from dynamo_tpu_torch.disagg.prefix_fetch import KvPullServer, PrefixFetchClient
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine

    path = {n: kernels[n] for n in ("K1", "K2")}
    stray = {n: fn for n, fn in kernels.items() if n not in path}
    vocab = model.config.vocab_size
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, vocab, int(n)).tolist() for n in rng.integers(MIG_PLEN[0], MIG_PLEN[1] + 1, MIG_STREAMS)]
    dest = AsyncTorchEngine(tier_config(), model=model)
    t0 = time.monotonic()

    async def wire(src, dst):
        srv = await KvPullServer(src, host="127.0.0.1").start()
        src.kv_pull_server = srv
        dst.attach_prefix_fetch(PrefixFetchClient(asyncio.get_running_loop(), timeout_s=30.0))
        return srv

    async def wait_tokens(engine, rids, n, timeout=120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            seqs = [s for s in engine.scheduler.slots if s is not None and s.req.request_id in rids]
            if len(seqs) == len(rids) and all(len(s.generated) >= n for s in seqs):
                return
            await asyncio.sleep(0.002)
        raise AssertionError(f"migrate serve: streams {rids} did not reach {n} tokens")

    async def run_c():
        await dest.start()
        await source.run_on_engine(lambda: (set_tiers(source, False), source.allocator.reset_prefix_cache()))
        srv = await wire(source, dest)
        try:
            log(f"migrate serve: destination up [{gpu_name}]: {graphs_line(dest)}")
            base = dict(zip(range(MIG_STREAMS), await asyncio.gather(
                *(one_stream(source, greedy(f"b{i}", p, MIG_OUT)) for i, p in enumerate(prompts)))))
            await source.run_on_engine(source.allocator.reset_prefix_cache)
            tallies = [replay_tally(e, path) for e in (source, dest)]
            captures = [e.runner.compile_monitor.compiles for e in (source, dest)]
            for fn in (*path.values(), *stray.values()):
                fn.launches = 0
            rids = [f"m{i}" for i in range(MIG_STREAMS)]
            tasks = [asyncio.ensure_future(one_stream(source, greedy(r, p, MIG_OUT))) for r, p in zip(rids, prompts)]
            await wait_tokens(source, rids, MIG_AT)
            results = await asyncio.gather(*(source.migrate_out(r, dest.adopt_migrated) for r in rids))
            streams = await asyncio.gather(*tasks)
            launches = {n: fn.launches for n, fn in path.items()}
            bad = {n: fn.launches for n, fn in stray.items() if fn.launches}
            per = [{n: v - t[n] for n, v in replay_tally(e, path).items()} for e, t in zip((source, dest), tallies)]
            if [e.runner.compile_monitor.compiles for e in (source, dest)] != captures:
                raise AssertionError("migrate serve (c): an engine captured a graph while serving")
            if bad or min(launches.values()) <= 0 or min(v for p in per for v in p.values()) <= 0:
                raise AssertionError(f"migrate serve (c): launches {launches}, per engine {per}, off the path {bad}")
            statuses = [r["status"] for r in results]
            short = [i for i, s in enumerate(streams) if len(s["tokens"]) != MIG_OUT or s["reason"] != "length"]
            d, s = dest.scheduler, source.scheduler
            if short or statuses.count("ok") != MIG_STREAMS or d.migration_in_pulled != MIG_STREAMS:
                raise AssertionError(f"migrate serve (c): statuses {statuses}, short streams {short}, pulled "
                                     f"{d.migration_in_pulled}")
            pauses = sorted(r["pause_s"] for r in results)
            equal = sum(streams[i]["tokens"] == base[i]["tokens"] for i in range(MIG_STREAMS))
            prefix = sum(streams[i]["tokens"][:MIG_AT] == base[i]["tokens"][:MIG_AT] for i in range(MIG_STREAMS))
            blocks = sum(r["kv_blocks"] for r in results)
            log(f"migrate serve (c), Llama-3-8B 32 layers bf16 [{gpu_name}]: {MIG_STREAMS} streams migrated after "
                f"{MIG_AT} tokens, all at once: statuses {statuses}; pause p50 {ms(pauses[len(pauses) // 2])}, p99 "
                f"{ms(pauses[min(len(pauses) - 1, int(0.99 * len(pauses)))])} (each "
                f"{[round(p * 1e3, 1) for p in pauses]} ms, freeze to the first continuation token); "
                f"migration_in_pulled {d.migration_in_pulled}, recomputed {d.migration_in_recomputed}, tokens "
                f"salvaged {d.migration_tokens_salvaged} ({blocks} blocks, "
                f"{blocks * source.model.kv_page_bytes(16) / 1e9:.3f} GB pulled); migration_out {s.migration_out}; "
                f"{equal}/{MIG_STREAMS} streams equal the uninterrupted baseline (bf16), {prefix}/{MIG_STREAMS} up "
                f"to the migration point; K1 / K2 replayed: source {per[0]}, destination {per[1]}")
            return launches
        finally:
            await srv.stop()

    try:
        launches = asyncio.run(run_c())
    except BaseException:
        asyncio.run(dest.shutdown())
        asyncio.run(source.shutdown())
        raise
    t0 = lap("migrate serve (c)", t0)

    # the ladder, at 2 layers f32 (identity)
    async def run_ladder():
        from dynamo_tpu_torch.engine.config import EngineConfig

        cfg = EngineConfig(model_id=ladder_model_id(), device=source.config.device, page_size=16, num_pages=512,
                           max_seqs=4, max_model_len=2304, prefill_lanes=1, prefill_buckets=(512,))
        src = AsyncTorchEngine(cfg)
        await src.start()
        dst = AsyncTorchEngine(dataclasses.replace(cfg, migration_timeout_s=3.0), model=src.model)
        await dst.start()
        srv = await wire(src, dst)
        lrng = np.random.default_rng(29)
        cases = ("seq_handoff=drop-part", "seq_handoff=corrupt-checksum", "stopped")
        lvocab = src.model.config.vocab_size
        lprompts = [lrng.integers(1, lvocab, LADDER_PLEN + 16 * i + 5).tolist() for i in range(len(cases))]
        try:
            base = [await one_stream(src, greedy(f"lb{i}", p, LADDER_OUT)) for i, p in enumerate(lprompts)]
            await src.run_on_engine(src.allocator.reset_prefix_cache)
            lines, bad = [], False
            for i, (case, p) in enumerate(zip(cases, lprompts)):
                rid = f"l{i}"
                task = asyncio.ensure_future(one_stream(src, greedy(rid, p, LADDER_OUT)))
                await wait_tokens(src, [rid], LADDER_AT)
                adopter = dst.adopt_migrated
                if case == "stopped":
                    async def adopter(manifest):
                        n = 0
                        async for out in dst.adopt_migrated(manifest):
                            yield out
                            n += out.token is not None
                            if n >= 4:
                                raise StoppedDestination("the destination stopped after relaying 4 tokens")
                else:
                    os.environ["DYNTPU_FAULT_DATAPLANE"] = case
                at = len(next(x for x in src.scheduler.slots if x is not None and x.req.request_id == rid).generated)
                try:
                    res = dict(await src.migrate_out(rid, adopter), at=at)
                    got = await task
                finally:
                    os.environ.pop("DYNTPU_FAULT_DATAPLANE", None)
                want, toks = ("resumed" if case == "stopped" else "ok"), base[i]["tokens"]
                differ = next((j for j, (a, b) in enumerate(zip(got["tokens"], toks)) if a != b), None)
                ok = res["status"] == want and got["reason"] == "length" and len(got["tokens"]) == LADDER_OUT
                bad |= not ok or differ is not None
                lines.append(f"{case}: {res['status']} after {res.get('tokens_relayed', '-')} relayed tokens, "
                             + ("the uninterrupted tokens" if differ is None else
                                f"first differs at token {differ} of {len(toks)} (migrated at {res['at']})"))
            d = dst.scheduler
            log(f"migrate serve ladder, Llama-3-8B width 2 layers f32 [{gpu_name}]: " + "; ".join(lines)
                + f"; destination fell back to recompute {d.migration_in_recomputed} times "
                f"(client {dict(dst.prefix_fetcher.results)}), the source's failed handoffs "
                f"{src.scheduler.migration_out_failed}")
            if bad or d.migration_in_recomputed != 2 or src.scheduler.migration_out_failed != 1:
                raise AssertionError("migrate serve ladder: a case missed (see above)")
        finally:
            await srv.stop()
            await dst.shutdown()
            await src.shutdown()

    try:
        asyncio.run(run_ladder())
    except BaseException:
        asyncio.run(dest.shutdown())
        asyncio.run(source.shutdown())
        raise
    gc.collect()
    torch.cuda.empty_cache()
    t0 = lap("migrate serve ladder", t0)
    asyncio.run(drain_workers(gpu_name, source, dest, vocab))
    gc.collect()
    torch.cuda.empty_cache()
    lap("migrate serve (d)", t0)
    return launches


async def drain_workers(gpu_name: str, source, dest, vocab: int) -> None:
    """(d): the two engines behind WorkerServices on one broker and a kv
    processor; POST /admin/drain to the source while its streams decode.
    Stops both workers, and with them both engines."""
    import http.client

    from dynamo_tpu_torch.components.processor import ProcessorService
    from dynamo_tpu_torch.components.worker import WorkerService
    from dynamo_tpu_torch.cplane.broker import Broker
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.frontends.pipeline import card_for_model
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    stops = []
    broker = Broker()
    addr = f"127.0.0.1:{await broker.start()}"
    stops.append(broker.stop)

    async def runtime():
        rt = DistributedRuntime(cplane_address=addr)
        await rt.connect()
        stops.append(rt._shutdown_hook)
        return rt

    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, vocab, int(n)).tolist() for n in rng.integers(MIG_PLEN[0], MIG_PLEN[1] + 1, DRAIN_STREAMS)]
    cfg = source.config
    card = card_for_model(cfg.model_id, cfg.max_model_len)
    card.display_name, card.kv_block_size = "llama-3-8b-drain", cfg.page_size
    try:
        workers = []
        for engine, admin in ((source, 0), (dest, None)):
            svc = WorkerService(await runtime(), "drain", "backend", card, engine.config,
                                engine_factory=lambda sink, e=engine: e, admin_port=admin)
            await svc.start()
            stops.append(svc.stop)
            workers.append((svc, svc.drt.primary_lease.lease_id))
        (a, a_id), (b, b_id) = workers
        proc = ProcessorService(await runtime(), "drain", component="processor", worker_component="backend",
                                kv_block_size=cfg.page_size, routing="kv")
        await proc.start()
        proc.router.aggregator.interval = ROUTER_INTERVAL_S
        stops.append(proc.stop)
        client = await (await runtime()).client("drain", "backend", "generate")
        while len(client.instance_ids()) < 2:
            await asyncio.sleep(0.05)
        await wait_for(lambda: a_id in {v.instance_id for v in proc.router.aggregator.worker_views()},
                       "the router scraped the source", 30)

        async def stream(i, p):
            pre = PreprocessedRequest(f"w{i}", p, SamplingParams(temperature=0.0, max_tokens=DRAIN_OUT,
                                                                 ignore_eos=True))
            toks, finish = [], None
            async for item in await client.direct(pre.to_wire(), a_id):
                toks += item.get("token_ids") or []
                finish = item.get("finish_reason") or finish
            return toks, finish

        tasks = [asyncio.ensure_future(stream(i, p)) for i, p in enumerate(prompts)]
        rids = {f"w{i}" for i in range(DRAIN_STREAMS)}

        def decoding():
            seqs = [s for s in source.scheduler.slots if s is not None and s.req.request_id in rids]
            return len(seqs) == DRAIN_STREAMS and all(len(s.generated) >= MIG_AT for s in seqs)

        await wait_for(decoding, "the drain's streams decoding", 120)

        def post_drain():
            conn = http.client.HTTPConnection("127.0.0.1", a.admin_port, timeout=300)
            try:
                conn.request("POST", "/admin/drain", body=json.dumps({"target": f"{b_id:x}"}).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        t0 = time.monotonic()
        status, report = await asyncio.get_running_loop().run_in_executor(None, post_drain)
        drain_s = time.monotonic() - t0
        got = await asyncio.gather(*tasks)
        short = [i for i, (t, f) in enumerate(got) if len(t) != DRAIN_OUT or f != "length"]
        if status != 200 or report.get("migrated", 0) <= 0 or short:
            raise AssertionError(f"migrate serve (d): drain answered {status} {report}; short streams {short}")
        left = await wait_for(lambda: a_id in proc.router._pruned_unservable, "the drained worker left the index", 10)
        log(f"migrate serve (d) worker drain, Llama-3-8B 32 layers bf16 [{gpu_name}]: POST /admin/drain answered "
            f"{status} in {drain_s:.2f} s: {json.dumps(report)}; all {DRAIN_STREAMS} client streams ended with "
            f"{DRAIN_OUT} tokens; the source is {source.health.state} and left the router's index {left * 1e3:.1f} ms "
            f"after the drain answered")
    finally:
        for stop in reversed(stops):
            try:
                await asyncio.wait_for(stop(), 120)
            except Exception as e:
                log(f"migrate serve (d): cleanup {getattr(stop, '__qualname__', stop)}: {type(e).__name__}: {e}")
        await source.shutdown()
        await dest.shutdown()



# ---------------- lora serve: multi-LoRA serving ----------------

# the decode-kernel switch's serve phases run the Llama workload at this
# depth (chunked serve, grouped serve)
SWITCH_LAYERS = 8

LORA_RANK, LORA_SLOTS = 8, 4
LORA_SPECS = tuple(f"l{i}=random:{100 + i}" for i in range(1, 7))  # six synthetic adapters
LORA_MAX_LEN = 1152  # prompts to 512 tokens and 64 out; the cost timings at context 1024 (72 pages, one width)
LORA_CTX = 1024


def lora_config(model_id: str, adapters=LORA_SPECS[:4], **over):
    """An engine of the lora serve phase: page size 16, 16 slots, one
    512-row prefill bucket at up to two lanes and one table width (few graph
    shapes to capture), the adapters at rank 8 over 4 device slots."""
    from dynamo_tpu_torch.engine.config import EngineConfig

    return EngineConfig(**{**dict(model_id=model_id, device="cuda", page_size=16, num_pages=2048, max_seqs=16,
                                  max_model_len=LORA_MAX_LEN, prefill_lanes=2, prefill_buckets=(512,),
                                  lora_adapters=adapters, max_loras=LORA_SLOTS, lora_rank=LORA_RANK), **over})


def lora_requests(rng, vocab: int, loras: list, lens: tuple, n: int, tag: str) -> list:
    return [greedy(f"{tag}{i}", rng.integers(1, vocab, int(k)).tolist(), n, lora_name=lora)
            for i, (k, lora) in enumerate(zip(rng.integers(lens[0], lens[1] + 1, len(loras)), loras))]


def held_equal(what: str, got: dict, want: dict, rids) -> None:
    """Raise unless every ``rid`` has the same tokens (and "length") in both."""
    bad = [rid for rid in rids if got[rid][:2] != want[rid][:2] or got[rid][1] != "length"]
    if bad:
        raise AssertionError(f"{what}: streams differ: " + "; ".join(
            f"{rid} {got[rid][0]} != {want[rid][0]}" for rid in bad[:3]))


def lora_identity(torch, gpu_name: str, launchers: dict, quantize: str | None = None) -> dict:
    """(a) f32, or (c) int8_wo weights over f32 activations: Llama-3-8B
    width at 2 layers (a depth cut: identity), adapters l1-l4 at rank 8 and
    the base, 8 greedy streams of 32 tokens in one mixed batch. Each stream
    must equal the same request served alone on the engine (prefix cache
    emptied), and, full precision, an adapter's streams the merged weights'
    (W + scale A B on a LoRA-less engine, f32) and the base streams the
    LoRA-less engine's, exactly. Returns the LoRA engine's replay tallies."""
    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.lora import load_adapter, merge_adapter_into_params
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    what = f"lora serve ({'c' if quantize else 'a'})"
    geometry = dict(LLAMA3_8B, num_layers=2, dtype="f32", **({"quantize": quantize} if quantize else {}))
    model_id = "tiny:" + json.dumps(geometry)
    cfg = lora_config(model_id, num_pages=512, max_seqs=8, quantize=quantize)
    model = load_model(model_id, device="cuda")
    merged = None if quantize else load_model(model_id, device="cuda")  # the same seed: the base weights
    reqs = lora_requests(np.random.default_rng(31), LLAMA3_8B["vocab_size"], ["", "l1", "l2", "l3", "l4", "", "l1", "l3"],
                         (64, 400), 32, "a")

    async def body():
        engine = AsyncTorchEngine(cfg, model=model)
        plain = None if merged is None else AsyncTorchEngine(dataclasses.replace(cfg, lora_adapters=()), model=merged)
        for e in (engine, plain):
            if e is not None:
                await e.start()
        try:
            mixed, _ = await serve_on(engine, reqs)
            await engine.run_on_engine(engine.allocator.reset_prefix_cache)
            alone = {}
            for r in reqs:
                alone |= (await serve_on(engine, [fresh(r)]))[0]
            held_equal(f"{what} mixed against alone", mixed, alone, [r.request_id for r in reqs])
            tally = replay_tally(engine, launchers)
            if plain is None:
                return mixed, tally
            base = (await serve_on(plain, [fresh(r) for r in reqs if not r.lora_name]))[0]
            held_equal(f"{what} base streams against the LoRA-less engine", mixed, base, list(base))
            for name, source in engine.runner.lora_store.sources.items():
                tree, scale = load_adapter(source, model.config, LORA_RANK)
                sd = merge_adapter_into_params(model, tree, scale)
                await plain.run_on_engine(lambda sd=sd: (merged.load_state_dict(sd, strict=False),
                                                         plain.allocator.reset_prefix_cache()))
                got = (await serve_on(plain, [fresh(r, lora_name="") for r in reqs if r.lora_name == name]))[0]
                held_equal(f"{what} {name} against its merged weights", mixed, got, list(got))
            return mixed, tally
        finally:
            for e in (engine, plain):
                if e is not None:
                    await e.shutdown()

    mixed, tally = asyncio.run(body())
    distinct = len({tuple(mixed[r.request_id][0]) for r in reqs if r.request_id in ("a0", "a1", "a2", "a3", "a4")})
    log(f"{what} [{gpu_name}]: Llama-3-8B width, 2 layers, {quantize or 'f32'} weights, f32: 8 greedy streams of 32 "
        f"tokens (adapters l1-l4 at rank {LORA_RANK} and the base) in one mixed batch equal each served alone"
        + ("" if quantize else ", the adapter streams equal their merged weights (W + s A B) on a LoRA-less engine "
           "and the base streams that engine's")
        + f", exactly; {distinct} distinct streams of the base and four adapters; replay tallies "
        + " ".join(f"{k} {v}" for k, v in tally.items()))
    del model, merged
    torch.cuda.empty_cache()
    return tally


def lora_window_step_ms(torch, runner, cfg, pairs: int = 5, steps=(8, 32)) -> list[float]:
    """Device ms a decode step of the runner's window (every slot active at
    LORA_CTX, greedy, the feedback on the device): CUDA events around one
    window's dispatch and replay, (t(long) - t(short)) / span, per pair."""
    B, ps = cfg.max_seqs, cfg.page_size
    npp = -(-(LORA_CTX + steps[1] + 8) // ps)
    tables = np.zeros((B, cfg.max_pages_per_seq), np.int32)
    for i in range(B):
        tables[i, :npp] = 1 + i * npp + np.arange(npp)
    zeros = np.zeros(B, np.float32)

    def timed(n) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = runner.dispatch_decode_window(np.full(B, LORA_CTX, np.int32), tables, np.ones(B, bool),
                                            np.full(B, npp * ps - 1, np.int32), zeros, np.zeros(B, np.int32),
                                            np.ones(B, np.float32), n)
        end.record()
        end.synchronize()
        res.numpy()
        return start.elapsed_time(end)

    for n in steps:
        timed(n)  # the capture, where the graph is new
    span = steps[1] - steps[0]
    return [(timed(steps[1]) - timed(steps[0])) / span for _ in range(pairs)]


def lora_prefill_ms(torch, runner, lora_slot: int, vocab: int, reps: int = 5) -> list[float]:
    """Device ms of one 512-row prefill call (one lane at position 0, its
    token dropped) on the runner's captured graph: CUDA events around the
    dispatch and replay."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    table = np.zeros(runner.config.max_pages_per_seq, np.int32)
    table[:32] = np.arange(1, 33)
    lane = (np.random.default_rng(7).integers(1, vocab, 512).astype(np.int32), 0, table, -1,
            SamplingParams(temperature=0.0), (), False, lora_slot)

    def timed() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = runner.prefill_chunk_batch([lane], N=1)
        end.record()
        end.synchronize()
        res.numpy()
        return start.elapsed_time(end)

    timed()
    return sorted(timed() for _ in range(reps))


def phase_lora_serve(torch, gpu_name: str, kernels: dict) -> dict:
    """Multi-LoRA serving (``dynamo_tpu_torch/lora/``; ``kernels``: {name:
    launcher} of every serving kernel). Returns {K1, K2, K8: the LoRA
    engines' replay tallies over the phase}.

      (a) ``lora_identity`` in f32: mixed against alone, merged weights
          and the LoRA-less base, exactly;
      (b) bf16, Llama-3-8B at full depth (32 layers), adapters l1-l6 over 4
          slots at rank 8: 16 greedy streams of 64 tokens (prompts of
          200-500) over the adapters and the base in one batch: every stream
          ends at 64, every adapter stream differs from the same prompt on
          the base model, 2 or more evictions and 6 host loads; the streams
          equal to their alone runs counted (bf16); the same 512-token
          prompt under two adapters: 0 cached tokens on each first request,
          a hit on each repeat;
      (c) ``lora_identity`` with int8_wo weights: mixed against alone;
      (e) the port's HTTP service (``frontends/http.build_service``) on
          (b)'s engine: /v1/models lists the base and its six adapters, a
          ``<model>:l1`` completion stream ends at 64 tokens and [DONE] and
          its engine-side tokens equal the same request served in process,
          and an unknown adapter is a 404 model_not_found before any SSE
          byte, stream and unary;
      (d) cost, after (b)'s engines stopped: a decode step's device ms
          (CUDA events, 32- less 8-step windows, 16 slots at context 1024)
          and a 512-row prefill call's on (b)'s engine and on a LoRA-less
          engine of the same geometry on the same weights, in turns; each
          engine's graph pool bytes beside the adapter pool's; a slot
          load's host ms and its stream span from a pinned host copy."""
    import threading
    from argparse import Namespace

    from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
    from dynamo_tpu_torch.frontends.http import build_service
    from dynamo_tpu_torch.lora import load_adapter
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.profile_http import http_call, http_stream
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B

    on_path = {n: kernels[n] for n in ("K1", "K2", "K8")}
    stray = {n: fn for n, fn in kernels.items() if n not in on_path}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    tallies = [lora_identity(torch, gpu_name, {n: kernels[n] for n in ("K1", "K2")})]
    t0 = lap("lora serve (a)", t0)
    tallies.append(lora_identity(torch, gpu_name, on_path, quantize="int8_wo"))
    if tallies[-1]["K8"] <= 0:
        raise AssertionError(f"lora serve (c): K8 never replayed: {tallies[-1]}")
    t0 = lap("lora serve (c)", t0)

    vocab = LLAMA3_8B["vocab_size"]
    model_id = "tiny:" + json.dumps(LLAMA3_8B)
    model = load_model(model_id, device="cuda")
    # no warmup: each engine captures the shapes it serves on first use,
    # the same set on both (an 8-step window, prefill calls of one and two
    # lanes, (d)'s 32-step window), so their graph pools compare
    engine = AsyncTorchEngine(lora_config(model_id, adapters=LORA_SPECS), model=model)
    plain = AsyncTorchEngine(lora_config(model_id, adapters=()), model=model)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="lora-serve", daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(600)

    names = [f"l{i}" for i in range(1, 7)]
    rng = np.random.default_rng(33)
    reqs = lora_requests(rng, vocab, (names + [""]) * 2 + ["l1", ""], (200, 500), 64, "b")
    service = None
    try:
        on_loop(engine.start())
        on_loop(plain.start())
        mixed, wall = on_loop(serve_on(engine, reqs))
        store = engine.runner.lora_store
        bad = {rid: (len(t), f) for rid, (t, f, _) in mixed.items() if len(t) != 64 or f != "length"}
        if bad:
            raise AssertionError(f"lora serve (b): streams not ending with 64 tokens: {bad}")
        if store.evictions < 2 or store.loads != 6:
            raise AssertionError(f"lora serve (b): evictions {store.evictions}, loads {store.loads} (want >= 2, 6)")
        adapter_reqs = [r for r in reqs if r.lora_name]
        base = on_loop(serve_on(plain, [fresh(r, lora_name="") for r in adapter_reqs]))[0]
        same_as_base = [r.request_id for r in adapter_reqs if base[r.request_id][0] == mixed[r.request_id][0]]
        if same_as_base:
            raise AssertionError(f"lora serve (b): adapter streams equal the base model's: {same_as_base}")
        on_loop(engine.run_on_engine(engine.allocator.reset_prefix_cache))
        alone = {}
        for r in reqs:
            alone |= on_loop(serve_on(engine, [fresh(r)]))[0]
        equal_alone = sum(alone[rid][0] == mixed[rid][0] for rid in mixed)
        prompt = rng.integers(1, vocab, 512).tolist()
        cached = {}
        for rid, lora in (("p1", "l1"), ("p2", "l2"), ("p3", "l1"), ("p4", "l2")):
            cached[rid] = on_loop(one_stream(engine, greedy(rid, prompt, 4, lora_name=lora)))["cached"]
        if cached["p1"] or cached["p2"] or not (cached["p3"] > 0 and cached["p4"] > 0):
            raise AssertionError(f"lora serve (b): cached tokens under two adapters {cached}")
        snap = engine.resource_snapshot()
        log(f"lora serve (b) [{gpu_name}]: Llama-3-8B, 32 layers, bf16, adapters l1-l6 at rank {LORA_RANK} over "
            f"{LORA_SLOTS} slots: 16 greedy streams of 64 tokens ({len(adapter_reqs)} on adapters, prompts "
            f"{min(len(r.token_ids) for r in reqs)}-{max(len(r.token_ids) for r in reqs)}) ended at 64, every adapter "
            f"stream differs from its prompt on the base model (wall {wall:.2f} s, graph captures on first use "
            f"included); evictions {store.evictions}, host loads {store.loads} ({store.load_seconds:.3f} s on the "
            f"load thread, {store.load_seconds / store.loads * 1e3:.1f} ms an adapter, its pinned staging "
            f"included), slot loads {store.slot_loads} ({store.slot_load_seconds / store.slot_loads * 1e3:.2f} "
            f"host ms each: enqueueing the copies); {equal_alone}/16 bf16 streams equal their alone run; one 512-token prompt under l1 then l2: "
            f"cached {cached['p1']} and {cached['p2']}, repeated {cached['p3']} and {cached['p4']}; "
            f"lora_requests {json.dumps(snap['lora_requests'])}")
        log(f"lora serve (b) graphs: LoRA engine {graphs_line(engine)}; LoRA-less engine {graphs_line(plain)}")
        t0 = lap("lora serve (b)", t0)

        # (e) the HTTP edge on (b)'s engine
        seen: dict = {}
        inner = engine.generate_batched

        async def tee(request):
            async for batch in inner(request):
                seen.setdefault(request.request_id, []).extend(o.token for o in batch if o.token is not None)
                yield batch

        engine.generate_batched = tee
        service = build_service(engine, Namespace(model=model_id, http_port=0, max_model_len=LORA_MAX_LEN),
                                host="127.0.0.1")
        port = on_loop(service.start())
        status, body = http_call(port, "GET", "/v1/models")
        ids = {m["id"] for m in json.loads(body)["data"]}
        if status != 200 or ids != {model_id} | {f"{model_id}:{n}" for n in names}:
            raise AssertionError(f"lora serve (e): /v1/models answered {status} {sorted(ids)}")
        r1 = next(r for r in reqs if r.lora_name == "l1")
        on_loop(engine.run_on_engine(engine.allocator.reset_prefix_cache))
        msgs, waited = http_stream(port, {"model": f"{model_id}:l1", "prompt": r1.token_ids, "stream": True,
                                          "temperature": 0, "max_tokens": 64, "ext": {"ignore_eos": True}})
        finish = msgs[-2].json() if len(msgs) >= 2 else {}
        if not msgs[-1].is_done or finish.get("usage", {}).get("completion_tokens") != 64:
            raise AssertionError(f"lora serve (e): the l1 stream ended {[m.data for m in msgs[-2:]]}")
        http_toks = [t for rid, toks in seen.items() for t in toks]
        if len(seen) != 1 or http_toks != alone[r1.request_id][0]:
            raise AssertionError(f"lora serve (e): HTTP l1 stream {http_toks} != in process {alone[r1.request_id][0]}")
        for path, body in (("/v1/completions", {"model": f"{model_id}:nope", "prompt": [1, 2, 3], "max_tokens": 4,
                                                "stream": True}),
                           ("/v1/chat/completions", {"model": f"{model_id}:nope", "max_tokens": 4,
                                                     "messages": [{"role": "user", "content": "hi"}]})):
            status, raw = http_call(port, "POST", path, body)
            if status != 404 or raw.startswith(b"data:") or json.loads(raw)["error"].get("code") != "model_not_found":
                raise AssertionError(f"lora serve (e): unknown adapter on {path} answered {status} {raw[:200]!r}")
        log(f"lora serve (e) [{gpu_name}]: the HTTP service on (b)'s engine lists the base and l1-l6; a "
            f"<model>:l1 completion stream ended at 64 tokens and [DONE] in {waited:.2f} s, its engine-side tokens "
            f"equal the request served in process; an unknown adapter is a 404 model_not_found before any SSE byte "
            f"(stream and unary)")
        on_loop(service.stop())
        service = None
        engine.generate_batched = inner
        t0 = lap("lora serve (e)", t0)
    finally:
        if service is not None:
            on_loop(service.stop())
        on_loop(engine.shutdown())
        on_loop(plain.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    tallies.append(replay_tally(engine, on_path))

    # (d) the delta's cost: the two runners in turns, their engines stopped
    lr, pr = engine.runner, plain.runner
    for i in range(engine.config.max_seqs):
        lr.set_slot_lora(i, 1 + i % LORA_SLOTS)  # a mixed batch; the delta's work does not depend on the ids
    with torch.no_grad():
        steps = {"LoRA-less": [], "LoRA": []}
        prefill = {"LoRA-less": [], "LoRA": []}
        for name, runner in (("LoRA-less", pr), ("LoRA", lr), ("LoRA", lr), ("LoRA-less", pr)):
            steps[name] += lora_window_step_ms(torch, runner, runner.config)
            prefill[name] += lora_prefill_ms(torch, runner, 1 if runner is lr else 0, vocab)
        tree, scale = load_adapter(lr.lora_store.sources["l1"], model.config, LORA_RANK)
        nbytes = sum(e["a"].nbytes + e["b"].nbytes for e in tree.values())
        staged = lr.stage_lora_tree(tree)  # pinned, as the store's load thread stages a host copy
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t_host = time.monotonic()
        lr.load_lora_slot(1, staged, scale)
        t_host = time.monotonic() - t_host
        end.record()
        end.synchronize()
        load_span = start.elapsed_time(end)

    def med(v):
        v = sorted(v)
        return v[len(v) // 2]

    pool = lr.lora.nbytes()
    log(f"lora serve (d) [{gpu_name}] (16 slots at context {LORA_CTX}, in turns LoRA-less, LoRA, LoRA, LoRA-less): "
        f"decode step device ms LoRA {med(steps['LoRA']):.4f} (range {min(steps['LoRA']):.4f}-{max(steps['LoRA']):.4f})"
        f" against LoRA-less {med(steps['LoRA-less']):.4f} ({min(steps['LoRA-less']):.4f}-"
        f"{max(steps['LoRA-less']):.4f}): +{med(steps['LoRA']) - med(steps['LoRA-less']):.4f} ms a step; 512-row "
        f"prefill call device ms LoRA {med(prefill['LoRA']):.3f} against {med(prefill['LoRA-less']):.3f}; adapter "
        f"pool {pool / 1e6:.1f} MB ({LORA_SLOTS + 1} slots, rank {LORA_RANK}; read once a step: "
        f"{pool / HBM_BYTES_S * 1e3:.3f} ms at 3.35 TB/s); graph pool LoRA "
        f"{(lr.graphs.pool_bytes() or 0) / 2**20:.1f} MiB, LoRA-less {(pr.graphs.pool_bytes() or 0) / 2**20:.1f} MiB "
        f"({lr.compile_monitor.compiles} and {pr.compile_monitor.compiles} captures); a slot load (l1, "
        f"{nbytes / 1e6:.1f} MB from its pinned host copy): {t_host * 1e3:.2f} host ms, {load_span:.2f} ms stream "
        f"span ({nbytes / load_span / 1e6:.1f} GB/s)")
    del engine, plain, lr, pr, model
    torch.cuda.empty_cache()
    stray_counts = {n: fn.launches for n, fn in stray.items() if fn.launches}
    if stray_counts:
        raise AssertionError(f"lora serve: kernels off this path launched: {stray_counts}")
    total = {n: sum(t.get(n, 0) for t in tallies) for n in on_path}
    if min(total.values()) <= 0:
        raise AssertionError(f"lora serve: a kernel of the path never replayed: {total}")
    log(f"lora serve: LoRA engines' replay tallies " + " ".join(f"{k} {v}" for k, v in total.items())
        + " (none of " + ", ".join(stray) + ")")
    lap("lora serve (d)", t0)
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "dynamo_tpu_torch").is_dir():
        print(f"chip_smoke: no dynamo_tpu_torch package next to {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    t_start = time.monotonic()

    from dynamo_tpu_torch.tools.timing import card

    smi = card()
    print(smi, flush=True)
    gpu_name = torch.cuda.get_device_name(0)

    from dynamo_tpu_torch.ops.kernels import _build
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_expert_kernel as k8e
    from dynamo_tpu_torch.ops.kernels.int8_linear import int8_linear_kernel as k8
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_decode_attention_kernel as k5
    from dynamo_tpu_torch.ops.kernels.mla_attention import paged_mla_prefill_attention_kernel as k6
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_chunked_kernel as k4a
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_folded_kernel as k3a
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_grouped_kernel as k4b
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_attention_kernel as k1
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_dmaonly_kernel as k7b
    from dynamo_tpu_torch.ops.kernels.paged_attention import paged_decode_perseq_variant_kernel as k7c
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_folded_kernel as k3b
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_attention_kernel as k2
    from dynamo_tpu_torch.ops.kernels.prefill_attention import paged_prefill_dmaonly_kernel as k7a
    from dynamo_tpu_torch.tools.workload import (
        DEEPSEEK_V2_LITE,
        LLAMA3_8B,
        TINYLLAMA_1_1B,
        folded_serve_config,
        folded_serve_requests,
        mla_serve_config,
        serve_config,
        serve_requests,
    )

    t0 = time.monotonic()
    _build.build(["paged_attention", "prefill_attention", "mla_attention", "decode_variants", "int8_linear"])
    log(f"build: five kernel sources in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    check_sass()
    t0 = lap("SASS checks", t0)

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    checks = {name: check_decode(torch, dev, rng, name) for name in ("K1", "K3a")}
    checks |= {name: check_prefill(torch, dev, rng, name) for name in ("K2", "K3b")}
    checks["K5"] = check_mla_decode(torch, dev, rng)
    checks["K6"] = check_mla_prefill(torch, dev, rng)
    checks |= check_decode_variants(torch, dev, rng, "K1")
    checks["K7a"] = check_prefill_twin(torch, dev, rng, "K2")
    # the variants again at the profilers' shapes (G 2, page size 128)
    bench = check_decode_variants(torch, dev, rng, "bench")
    bench["K7a"] = check_prefill_twin(torch, dev, rng, "bench")
    t0 = lap("kernel checks", t0)
    int8_checks = check_int8_linear(torch, dev)  # its own inputs (torch's generator): rng's draws stay as they were
    t0 = lap("K8 checks", t0)
    widened = check_widened(torch, dev, rng)  # last: the seeded inputs of the checks above do not depend on it
    t0 = lap("widened checks", t0)
    # K1 and K2 at the HTTP path's page size and shapes, bf16: K1 at 16
    # slots over contexts to 2112, K2 over four 32-row lanes (the tiny card's
    # largest prefill bucket, packed four to a call) at prefixes to 2080
    ps4 = {
        "K1": check_decode(torch, dev, rng, "K1", ps=HTTP_PAGE_SIZE, B=16, rows=HTTP_MAX_MODEL_LEN, mixes=MIXES[1:2]),
        "K2": check_prefill(torch, dev, rng, "K2", ps=HTTP_PAGE_SIZE, T=32, starts=(0, 704, 1408, 2080),
                            max_pages=HTTP_MAX_MODEL_LEN // HTTP_PAGE_SIZE, mixes=MIXES[1:2]),
    }
    t0 = lap("page size 4 checks", t0)
    # K2 and K5 at the verify pass's shapes (lanes of k + 1 rows)
    verify_checks = check_verify_shapes(torch, dev, rng)
    t0 = lap("verify shape checks", t0)
    # each serve path runs with the counts set to 0 just before it and read
    # just after it: {path: {kernel: launches}}
    paged, folded = {"K1": k1, "K2": k2}, {"K3a": k3a, "K3b": k3b}
    int8w, mla = {"K8": k8, "K8 experts": k8e}, {"K5": k5, "K6": k6}
    mla_requests = serve_requests(DEEPSEEK_V2_LITE["vocab_size"])
    served = {}  # the serve phase's streams, which the spec phase's must equal
    runs = {
        "serve": phase_serve(torch, smi, "serve", serve_config(), serve_requests(), paged, folded | int8w,
                             after=decode_step(torch, smi, "serve"), record=served),
        "int8_wo serve": phase_serve(torch, smi, "int8_wo serve", serve_config(quantize="int8_wo"),
                                     serve_requests(), {"K8": k8, **paged}, folded | mla | {"K8 experts": k8e},
                                     after=decode_step(torch, smi, "int8_wo serve")),
        "int8 serve": phase_serve(torch, smi, "int8 serve", serve_config("int8"), serve_requests(), paged,
                                  folded | int8w),
        "MLA serve": phase_serve(torch, smi, "MLA serve", mla_serve_config(), mla_requests, mla, int8w),
        "MLA int8_wo serve": phase_serve(torch, smi, "MLA int8_wo serve", mla_serve_config("int8_wo"),
                                         mla_requests, int8w | mla, paged | folded),
        "folded serve": phase_serve(torch, smi, "folded serve", folded_serve_config(), folded_serve_requests(),
                                    folded, paged | int8w),
        "folded int8 serve": phase_serve(torch, smi, "folded int8 serve", folded_serve_config("int8"),
                                         folded_serve_requests(), folded, paged | int8w),
    }
    # the decode-kernel switch: K4a / K4b take every decode step of the
    # Llama workload, K2 its prefill, at SWITCH_LAYERS of the 32 layers (a
    # depth cut for the script's time limit: K1's launches in serve scaled
    # by the layers)
    switch_config = dataclasses.replace(
        serve_config(), model_id="tiny:" + json.dumps(dict(LLAMA3_8B, num_layers=SWITCH_LAYERS)))
    for what, choice, k4, other in (("chunked serve", "chunked", k4a, k4b), ("grouped serve", "grouped", k4b, k4a)):
        name = "K4a" if k4 is k4a else "K4b"
        with decode_kernel_env(choice):
            runs[what] = phase_serve(torch, smi, what, switch_config, serve_requests(), {name: k4, "K2": k2},
                                     {"K1": k1, "K3a": k3a, "K3b": k3b, "K4a" if name == "K4b" else "K4b": other})
        if runs[what][name] * LLAMA3_8B["num_layers"] != runs["serve"]["K1"] * SWITCH_LAYERS:
            raise AssertionError(f"{what}: {name} launched {runs[what][name]} times at {SWITCH_LAYERS} layers, K1 "
                                 f"{runs['serve']['K1']} in serve at {LLAMA3_8B['num_layers']}")
    t0 = lap("serve paths", t0)
    # speculative decoding: n-gram and draft-model verify rounds on K2 / K5
    runs |= phase_spec_serve(torch, smi, served, {**paged, **folded, **mla, **int8w})
    t0 = lap("spec serve", t0)
    # the HTTP edge: `run --in http --out torch` at Llama-3-8B width and depth
    runs["http serve"] = phase_http_serve(torch, smi, paged, {
        "K3a": k3a, "K3b": k3b, "K4a": k4a, "K4b": k4b, "K5": k5, "K6": k6, "K7a": k7a, "K7b": k7b, "K7c": k7c})
    t0 = lap("http serve", t0)
    # the prefix cache and the request features at Llama-3-8B width and depth
    runs["prefix serve"] = phase_prefix_serve(torch, smi, paged, {
        "K3a": k3a, "K3b": k3b, "K4a": k4a, "K4b": k4b, "K5": k5, "K6": k6, "K7a": k7a, "K7b": k7b, "K7c": k7c})
    t0 = lap("prefix serve", t0)
    # page pressure: preemption at full size and in f32, the QoS shed, spec
    # rounds under pressure, and the depth-aware chunk planner
    runs |= phase_preempt_serve(torch, smi, served, {**paged, **folded, **mla, **int8w})
    t0 = lap("preempt serve", t0)
    # disaggregated prefill and decode: two engines on the card, in process
    # (ici) and over the KV data plane, and the prefill worker as a process
    runs |= phase_disagg_serve(torch, smi, served, {**paged, **folded, **mla, **int8w})
    t0 = lap("disagg serve", t0)
    # KV-aware routing across two worker replicas: the worker service, the
    # kv router and indexer, the processors, the discovery frontend, the
    # fleet prefix pull, worker death and dyn:// across processes
    runs |= phase_routed_serve(torch, smi, {**paged, **folded, **mla, **int8w})
    t0 = lap("routed serve", t0)
    # the KV tier ladder (host, disk) and live migration between two engines,
    # with the worker drain, on one Llama-3-8B model the engines share
    from dynamo_tpu_torch.models.registry import load_model

    tier_model = load_model(tier_config().model_id, device="cuda")
    runs["tiers serve"], tier_engine = phase_tiers_serve(torch, smi, tier_model, {**paged, **folded, **mla, **int8w})
    t0 = lap("tiers serve", t0)
    runs["migrate serve"] = phase_migrate_serve(torch, smi, tier_model, tier_engine,
                                                {**paged, **folded, **mla, **int8w})
    del tier_model, tier_engine
    torch.cuda.empty_cache()
    t0 = lap("migrate serve", t0)
    # multi-LoRA: the adapter pool through prefill, decode and verify's
    # bodies, identities in f32, full depth bf16 with eviction, the HTTP edge
    runs["lora serve"] = phase_lora_serve(torch, smi, {**paged, **folded, **mla, **int8w})
    t0 = lap("lora serve", t0)
    # HF checkpoint directories through the port's writer, loader and `run`
    runs |= phase_checkpoint_serve(torch, smi, folded, {
        "K1": k1, "K2": k2, "K4a": k4a, "K4b": k4b, "K5": k5, "K6": k6, "K7a": k7a, "K7b": k7b, "K7c": k7c,
        "K8 experts": k8e}, k8)
    t0 = lap("checkpoint serve", t0)
    phase_refusals(torch, dev)
    phase_engine_vs_naive(torch, rng, "Llama-3-8B geometry", LLAMA3_8B)
    phase_engine_vs_naive(torch, rng, "TinyLlama geometry", TINYLLAMA_1_1B)
    phase_engine_vs_naive(torch, rng, "TinyLlama geometry", TINYLLAMA_1_1B, kv_cache_dtype="int8")
    phase_mla_vs_naive(torch, rng)
    phase_graph_vs_eager(torch, rng, smi)
    phase_engine_vs_naive(torch, rng, "Llama-3-8B geometry", LLAMA3_8B, decode_kernel="chunked", launcher=k4a)
    phase_engine_vs_naive(torch, rng, "Llama-3-8B geometry", LLAMA3_8B, decode_kernel="grouped", launcher=k4b)
    # its own seed: the inputs of the phases above and below stay as they were
    phase_features_vs_naive(torch, np.random.default_rng(12))
    # int8_wo weights (K8's f32 activations) against the dense forwards over
    # the dequantized weights, each on its own seed
    phase_engine_vs_naive(torch, np.random.default_rng(14), "Llama-3-8B geometry", LLAMA3_8B, launcher=k8,
                          quantize="int8_wo")
    phase_mla_vs_naive(torch, np.random.default_rng(15), "int8_wo", int8w | mla)
    t0 = lap("refusals, greedy parity, features and graph vs eager", t0)
    phase_cli(torch, rng)
    t0 = lap("cli", t0)
    runs["instruments"] = phase_instruments(torch, {"K7a": k7a, "K7b": k7b, "K7c": k7c})["launches"]
    lap("instruments", t0)

    csrc = "dynamo_tpu_torch/ops/kernels/csrc/"
    pallas = "dynamo_tpu/ops/pallas/"
    # name, check, source, the TPU kernel, the path of its launches (bf16
    # numbers), the path of its int8 numbers (None: the kernel takes no int8)
    table = (
        ("paged_decode_attention", "K1", "paged_attention.cu", "paged_attention.py:536", "serve", "int8 serve"),
        ("paged_prefill_attention", "K2", "prefill_attention.cu", "prefill_attention.py:686", "serve",
         "int8 serve"),
        ("paged_decode_attention_folded", "K3a", "paged_attention.cu", "paged_attention.py:741",
         "folded serve", "folded int8 serve"),
        ("paged_prefill_attention_folded", "K3b", "prefill_attention.cu", "prefill_attention.py:615",
         "folded serve", "folded int8 serve"),
        ("paged_mla_decode_attention", "K5", "mla_attention.cu", "mla_attention.py:221", "MLA serve", None),
        ("paged_mla_prefill_attention", "K6", "mla_attention.cu", "mla_attention.py:396", "MLA serve", None),
        ("paged_decode_attention_chunked", "K4a", "decode_variants.cu", "paged_attention.py:911", "chunked serve",
         None),
        ("paged_decode_attention_grouped", "K4b", "decode_variants.cu", "paged_attention.py:322", "grouped serve",
         None),
        ("paged_prefill_dmaonly", "K7a", "prefill_attention.cu", "prefill_attention.py:797", "instruments", None),
        ("paged_decode_dmaonly", "K7b", "decode_variants.cu", "tools/profile_attn.py:112", "instruments", None),
        ("paged_decode_perseq_variant", "K7c", "decode_variants.cu", "tools/profile_attn.py:232", "instruments",
         None),
    )
    # K7a-c run on the instruments path at the profilers' shapes: their rows
    # take those numbers, their K1 / K2 check shapes go under "check_shapes";
    # K4a and K4b run on the serve path at K1's, their profiler-shape numbers
    # go under "bench_shapes"
    on_bench = ("K7a", "K7b", "K7c")
    kernels = []
    for name, key, src, tpu, path, int8_path in table:
        row, other = (bench, checks) if key in on_bench else (checks, bench)
        entry = dict(name=name, route="cuda", source=csrc + src,
                     replaces=tpu if tpu.startswith("tools/") else pallas + tpu,
                     launches=runs[path][key], **row[key]["bf16"])
        if int8_path:
            entry["int8"] = dict(launches=runs[int8_path][key], **checks[key]["int8"])
        if key in ps4:  # the HTTP path: page size 4, its launches from the http serve run
            entry["ps4"] = dict(launches=runs["http serve"][key], **ps4[key]["bf16"])
        if key in runs["prefix serve"]:  # the prefix serve's three rounds (prefill over cached prefixes)
            entry["prefix_serve_launches"] = runs["prefix serve"][key]
        if key in runs["preempt serve"]:  # the serve workload on a pool its outputs outgrow
            entry["preempt_serve_launches"] = runs["preempt serve"][key]
        for path in ("disagg serve", "disagg MLA"):  # disaggregated prefill and decode, both engines
            if key in runs[path]:
                entry["disagg_serve_launches"] = runs[path][key]
        if key in runs["routed serve"]:  # KV-aware routing across two worker replicas, both workers
            entry["routed_serve_launches"] = runs["routed serve"][key]
        for path in ("tiers serve", "migrate serve", "lora serve"):  # KV tiers; migration; LoRA engines' tallies
            if key in runs[path]:
                entry[path.replace(" ", "_") + "_launches"] = runs[path][key]
        if key in verify_checks:  # the verify pass's shape: lanes of k + 1 rows, its launches in spec serve
            path = "spec ngram" if key == "K2" else "spec MLA ngram"
            entry["verify"] = dict(launches=runs[path][key], **verify_checks[key]["bf16"])
        if key in widened:  # {shape: {tol_share: largest over the mixes, ms: {mix: device ms}}}
            entry["widened"] = widened[key]
        if key in bench:
            entry["check_shapes" if key in on_bench else "bench_shapes"] = other[key]
        # checked here, not on a path: K7a over the int8 cache (the profiler
        # runs bf16 pools) and K7c's cast_f32 toggle (K1's function) at the
        # profiler's shape and at K1's
        if key == "K5":  # phase_serve checked that the MLA serve pool takes this body
            entry["body"] = "mla_decode_tc"
        if key == "K7a":
            entry["int8"] = dict(bench["K7a"]["int8"])
        if key == "K7c":
            entry["cast_f32"] = dict(bench["K7c cast_f32"]["bf16"])
            entry["check_shapes_cast_f32"] = checks["K7c cast_f32"]
        kernels.append(entry)
    # K8 (no pallas_call: the function of the reference's qlinear /
    # qlinear_expert, which XLA compiles from a fused convert and dot): the
    # row's numbers at the decode step's shape, every checked shape under
    # "shapes", the launches of the path named and of the other paths
    for name, key, path, main, line in (("int8_linear", "K8", "int8_wo serve", K8_MAIN, 107),
                                        ("int8_linear_expert", "K8 experts", "MLA int8_wo serve", K8_EXPERT_MAIN, 128)):
        kernels.append(dict(name=name, route="cuda", source=csrc + "int8_linear.cu",
                            replaces=f"dynamo_tpu/quant/int8.py:{line}", launches=runs[path][key],
                            shape=main, **int8_checks[key][main], shapes=int8_checks[key],
                            other_launches={p: r[key] for p, r in runs.items() if key in r and p != path}))
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": gpu_name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
