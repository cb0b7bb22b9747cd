"""The serve workloads that ``chip_smoke.py`` drives and
``tools/profile_serve.py`` profiles: 16 concurrent greedy requests with
seeded random prompts of 64..2048 tokens and 64 output tokens each, on one
of three geometries at full width and depth with seeded random weights:

  - ``llama``: Llama-3-8B (``serve_config``), packed prefill, kernels K1/K2;
    with ``kv_cache_dtype="int8"`` the same over an int8 KV cache;
  - ``mla``: DeepSeek-V2-Lite (``mla_serve_config``): MLA + MoE, the
    per-request prefill path, kernels K5/K6;
  - ``folded``: TinyLlama-1.1B (``folded_serve_config``), head_dim 64, so
    kernels K3a/K3b; bf16 or int8 KV. Its positions stop at 2048, so its
    prompts are clipped to ``FOLDED_MAX_PROMPT`` = 2048 - 64 tokens.

All draw the same prompt lengths from ``SEED``; token ids fall below each
geometry's vocabulary.

The prefix workload (``prefix_serve_config``, ``prefix_serve_requests``)
serves 16 prompts that share one ``PREFIX_LEN``-token prefix, each with a
distinct tail of ``MIN_TAIL``..``MAX_TAIL`` tokens, on Llama-3-8B geometry,
with the request features mixed by ``i % 4``: greedy with logprobs 5,
greedy with penalties, greedy with ``min_tokens`` 32 and Llama-3's two EOS
ids, sampled and seeded with penalties and logprobs 3.

``BENCH_1_3B`` and ``bench_config`` copy the reference bench's headline
engine (``bench.py json_model_id`` and ``bench_config``), which the kernel
profilers (``tools/profile_attn.py``, ``tools/profile_prefill.py``) take
their geometry from.
"""

from __future__ import annotations

import json

import numpy as np

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import EngineRequest

# Llama-3-8B config.json values (meta-llama/Meta-Llama-3-8B), bf16
LLAMA3_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32, num_heads=32,
    num_kv_heads=8, head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    tie_word_embeddings=False, dtype="bf16",
)
# DeepSeek-V2-Lite config.json values (deepseek-ai/DeepSeek-V2-Lite), bf16.
# Its yarn rope_scaling is not modelled (the reference raises on it): plain
# RoPE at rope_theta. moe_capacity_factor is the reference's from_hf_config
# value (GShard capacity dispatch: every expert runs on every step).
DEEPSEEK_V2_LITE = dict(
    vocab_size=102400, hidden_size=2048, intermediate_size=10944, num_layers=27, num_heads=16,
    q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2, moe_intermediate_size=1408,
    first_k_dense_replace=1, moe_capacity_factor=2.0, routed_scaling_factor=1.0,
    norm_topk_prob=False, rope_theta=10000.0, rms_norm_eps=1e-6, dtype="bf16",
)
# TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T config.json values
# (the geometry of the reference's tools/make_hf_checkpoint.py), bf16;
# max_position_embeddings 2048
TINYLLAMA_1_1B = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=22, num_heads=32,
    num_kv_heads=4, head_dim=64, rope_theta=10000.0, rms_norm_eps=1e-5,
    tie_word_embeddings=False, dtype="bf16",
)
TINYLLAMA_MAX_POSITIONS = 2048
# bench.py json_model_id(): the reference bench's ~1.3B Llama-shaped model
# (GQA 2:1), bf16; HEADLINE its (batch, page size)
BENCH_1_3B = dict(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=24, num_heads=16,
    num_kv_heads=8, head_dim=128, dtype="bf16",
)
HEADLINE = (64, 128)
# bench.py PROMPT_LEN / DECODE_TOKENS: the headline workload's prompt and
# output lengths (tools/profile_decode.py decodes at the middle of the output)
BENCH_PROMPT_LEN, BENCH_DECODE_TOKENS = 128, 128
NUM_REQUESTS = 16
MIN_PROMPT, MAX_PROMPT = 64, 2048
MAX_TOKENS = 64
SEED = 0
FOLDED_MAX_PROMPT = TINYLLAMA_MAX_POSITIONS - MAX_TOKENS
PREFIX_LEN, MIN_TAIL, MAX_TAIL = 1024, 64, 960
PENALTIES = dict(repetition_penalty=1.3, frequency_penalty=0.5, presence_penalty=0.5)
LLAMA3_EOS_IDS = (128001, 128009)  # <|end_of_text|>, <|eot_id|>
PREFIX_MIN_TOKENS = 32


def serve_config(kv_cache_dtype: str | None = None) -> EngineConfig:
    """The engine the workload runs on: one card, page size 16, 4096 pages,
    a slot for every request; ``kv_cache_dtype="int8"`` for the int8 cache."""
    return EngineConfig(
        model_id="tiny:" + json.dumps(LLAMA3_8B), device="cuda", page_size=16, num_pages=4096,
        max_seqs=NUM_REQUESTS, max_model_len=MAX_PROMPT + MAX_TOKENS, kv_cache_dtype=kv_cache_dtype,
    )


def folded_serve_config(kv_cache_dtype: str | None = None) -> EngineConfig:
    """The TinyLlama workload's engine: as ``serve_config`` on TinyLlama-1.1B
    geometry, at its 2048 positions."""
    return EngineConfig(
        model_id="tiny:" + json.dumps(TINYLLAMA_1_1B), device="cuda", page_size=16, num_pages=4096,
        max_seqs=NUM_REQUESTS, max_model_len=TINYLLAMA_MAX_POSITIONS, kv_cache_dtype=kv_cache_dtype,
    )


def mla_serve_config() -> EngineConfig:
    """The MLA workload's engine: as ``serve_config`` on V2-Lite geometry
    (a latent pool of 27 x 4096 x 16 x 576 bf16, 2.0 GB)."""
    return EngineConfig(
        model_id="tiny-mla:" + json.dumps(DEEPSEEK_V2_LITE), device="cuda", page_size=16,
        num_pages=4096, max_seqs=NUM_REQUESTS, max_model_len=MAX_PROMPT + MAX_TOKENS,
    )


def serve_requests(vocab_size: int = LLAMA3_8B["vocab_size"], max_prompt: int = MAX_PROMPT) -> list[EngineRequest]:
    """The workload's greedy requests, prompts drawn from ``SEED`` and cut
    to their first ``max_prompt`` tokens."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(MIN_PROMPT, MAX_PROMPT + 1, NUM_REQUESTS)
    return [
        EngineRequest(
            f"serve-{i}", rng.integers(0, vocab_size, int(length)).tolist()[:max_prompt],
            SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS),
        )
        for i, length in enumerate(lens)
    ]


def folded_serve_requests() -> list[EngineRequest]:
    """The TinyLlama workload's requests: the same 16, clipped so prompt +
    output fits its 2048 positions (only the 1990-token prompt is cut)."""
    return serve_requests(TINYLLAMA_1_1B["vocab_size"], FOLDED_MAX_PROMPT)


def bench_config(batch: int = HEADLINE[0], page_size: int = HEADLINE[1]) -> EngineConfig:
    """bench.py bench_config(batch, page_size) on ``BENCH_1_3B``: enough
    pages for the batch at 28 pages of 16 rows a sequence, 1024 positions,
    prefill buckets 128 / 256 / 512, decode windows of 32 steps, 3 in
    flight."""
    return EngineConfig(
        model_id="tiny:" + json.dumps(BENCH_1_3B), device="cuda", page_size=page_size,
        num_pages=max(1024 * 16 // page_size, batch * 28 * 16 // page_size), max_seqs=batch,
        max_model_len=1024, prefill_buckets=(128, 256, 512), decode_steps=32, pipeline_depth=3,
    )


def prefix_serve_config() -> EngineConfig:
    """The prefix workload's engine: as ``serve_config``, with the context
    of the longest prompt and its output."""
    return EngineConfig(
        model_id="tiny:" + json.dumps(LLAMA3_8B), device="cuda", page_size=16, num_pages=4096,
        max_seqs=NUM_REQUESTS, max_model_len=PREFIX_LEN + MAX_TAIL + MAX_TOKENS,
    )


def prefix_serve_prompts(vocab_size: int = LLAMA3_8B["vocab_size"]) -> list[list[int]]:
    """The 16 prompts: one shared prefix and distinct tails, drawn from
    ``SEED``."""
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, vocab_size, PREFIX_LEN).tolist()
    tails = rng.integers(MIN_TAIL, MAX_TAIL + 1, NUM_REQUESTS)
    return [prefix + rng.integers(0, vocab_size, int(n)).tolist() for n in tails]


def prefix_serve_requests(tag: str, indices=range(NUM_REQUESTS)) -> list[EngineRequest]:
    """The prefix workload's requests ``indices`` (ids ``prefix-<tag>-<i>``),
    each of MAX_TOKENS output tokens, features by ``i % 4``."""
    prompts = prefix_serve_prompts()
    out = []
    for i in indices:
        kind, extra = i % 4, {}
        if kind == 0:
            sampling, extra = SamplingParams(max_tokens=MAX_TOKENS), dict(logprobs=5)
        elif kind == 1:
            sampling = SamplingParams(max_tokens=MAX_TOKENS, **PENALTIES)
        elif kind == 2:
            sampling = SamplingParams(max_tokens=MAX_TOKENS, min_tokens=PREFIX_MIN_TOKENS)
            extra = dict(eos_token_ids=LLAMA3_EOS_IDS)
        else:
            sampling = SamplingParams(max_tokens=MAX_TOKENS, temperature=0.8, seed=1000 + i, **PENALTIES)
            extra = dict(logprobs=3)
        out.append(EngineRequest(f"prefix-{tag}-{i}", prompts[i], sampling, **extra))
    return out
