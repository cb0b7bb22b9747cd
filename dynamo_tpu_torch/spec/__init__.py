"""Speculative decoding subsystem (a copy of ``dynamo_tpu/spec/__init__.py``).

Two proposer families for the paged engine, both verified through the same
batched multi-token verify pass (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding"; Chen et al., "Accelerating Large
Language Model Decoding with Speculative Sampling"):

  - ``ngram:k`` — draft-free prompt-lookup (Saxena et al.): a per-sequence
    suffix index guesses up to k continuation tokens from the sequence's own
    prompt+output history. Wins on repetition-heavy text only.
  - ``draft:<model>:<k>`` — a second, smaller model loaded through the
    registry drafts k tokens per round in ONE batched on-device dispatch
    (spec/draft.py DraftModelRunner: its own paged KV pool + per-sequence
    draft page tables on the width ladder; one captured graph on the card). Because the draft emits real
    probability rows, temperature>0 acceptance runs the exact
    rejection-sampling rule against q (not a one-hot), recovering speedups
    on arbitrary text where n-gram acceptance collapses.

Greedy requests advance token-identically to the non-speculative engine;
temperature>0 requests are distribution-exact
(engine/sampling.py:accept_speculative).

Config surface: ``EngineConfig.speculative`` / ``--speculative ngram:k`` /
``--speculative draft:<model>:<k>`` parses through :func:`parse_speculative`;
the scheduler builds the n-gram proposer via :func:`make_proposer` (draft
proposals ride ``ModelRunner.dispatch_draft`` instead — a draft model is
device state, not a host-side Proposer).
"""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.spec.proposer import NgramIndex, NgramProposer, Proposer

__all__ = [
    "NgramIndex",
    "NgramProposer",
    "Proposer",
    "SpecConfig",
    "make_proposer",
    "parse_speculative",
]

#: proposer kinds accepted by ``--speculative``
SPEC_KINDS = ("ngram", "draft")


@dataclass(frozen=True)
class SpecConfig:
    """Parsed speculative-decoding settings."""

    kind: str = "ngram"
    k: int = 4  # draft tokens proposed (and verified) per engine round
    max_ngram: int = 4  # longest history suffix the n-gram proposer matches
    min_ngram: int = 1  # shortest suffix worth matching
    # draft kind only: registry id of the draft model (a tiny:{...} override
    # JSON or a local checkpoint dir; loaded with the engine's quantize /
    # kv_cache_dtype so the draft composes with int8 weights and int8 KV)
    model: str | None = None


def parse_speculative(spec) -> SpecConfig | None:
    """``None``/"off" -> None; "ngram" / "ngram:4" / "draft:<model>:<k>" ->
    SpecConfig.

    One parser shared by EngineConfig validation, the CLIs, and the runner's
    warmup so a bad spec string fails at config time, not mid-serving. Draft
    model ids may themselves contain colons (tiny:{...} override JSON, or an
    absolute path): only a purely-numeric LAST segment is taken as k, the
    rest is the model id verbatim.
    """
    if spec is None or isinstance(spec, SpecConfig):
        return spec
    s = str(spec).strip()
    if s in ("", "none", "off"):
        return None
    parts = s.split(":")
    kind = parts[0]
    if kind not in SPEC_KINDS:
        raise ValueError(
            f"unknown speculative kind {kind!r} (supported: {SPEC_KINDS})"
        )
    k = 4
    model = None
    if kind == "draft":
        rest = parts[1:]
        if rest and rest[-1].isdigit():
            k = int(rest.pop())
        model = ":".join(rest)
        if not model:
            raise ValueError(
                "draft speculation needs a model id: --speculative "
                "draft:<model>[:<k>]"
            )
    elif len(parts) > 1 and parts[1]:
        k = int(parts[1])
    if not 1 <= k <= 16:
        raise ValueError(f"speculative k must be in [1, 16]; got {k}")
    return SpecConfig(kind=kind, k=k, model=model)


def make_proposer(cfg: SpecConfig) -> Proposer | None:
    """Host-side proposer for the config; None for the draft kind (drafting
    is a batched device dispatch owned by the ModelRunner, not a per-sequence
    host call)."""
    if cfg.kind == "ngram":
        return NgramProposer(max_ngram=cfg.max_ngram, min_ngram=cfg.min_ngram)
    if cfg.kind == "draft":
        return None
    raise ValueError(f"no proposer for speculative kind {cfg.kind!r}")
