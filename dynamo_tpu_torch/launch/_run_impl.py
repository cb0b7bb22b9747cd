"""Dispatch for ``dynamo-tpu-torch run``: wires input frontends to output
engines.

Engine matrix mirrors the reference launcher (reference: launch/dynamo-run/src/opt.rs):
inputs http/text/batch; outputs echo (test engine, reference:
launch/dynamo-run/src/output/echo_core.rs) and the port's engine
(``--out torch``, ``AsyncTorchEngine`` on ``--device``).

Port of ``dynamo_tpu/launch/_run_impl.py``. ``--in dyn://ns.comp.ep``
serves the local engine (torch or echo) as a worker endpoint over the
distributed runtime and ``--out dyn://ns.comp.ep`` drives a remote one
(``launch/_remote.py``; the control plane is ``$DYNTPU_CPLANE``). Not ported
yet, and refused with :class:`NotPorted`: ``--out pytok:`` and the engine
options whose features the port does not run (tp/pp, the long-context
offload tiers, SLO targets).
``--quantize int8_wo``, a checkpoint directory as the model, LoRA adapters
(``--lora-adapters`` / ``--max-loras`` / ``--lora-rank``, as the
reference passes them: each adapter serves as ``<base>:<name>``) and speculative
decoding (``--speculative ngram:k`` / ``draft:<model>:k``, or a
``"speculative"`` key in a tiny model's JSON, popped before the registry
reads the rest, as in the reference) run.
"""

from __future__ import annotations

import asyncio
import json

from dynamo_tpu_torch.utils import get_logger

log = get_logger("launch")


class NotPorted(ValueError):
    """A ``run`` option of the reference that the port does not run yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported to dynamo_tpu_torch yet")


def run_command(args) -> int:
    """Run until the input ends; an interrupt (SIGINT) is a clean exit."""
    try:
        asyncio.run(_run(args))
    except KeyboardInterrupt:
        log.info("interrupted; engine and service stopped")
    return 0


def _refuse_unported(args) -> None:
    for flag, attr, off in (
        ("--tp", "tp", (None, 1)), ("--pp", "pp", (None, 1)), ("--slo-ttft-ms", "slo_ttft_ms", (None,)),
        ("--slo-itl-ms", "slo_itl_ms", (None,)),
    ):
        if getattr(args, attr, None) not in off:
            raise NotPorted(flag)


def engine_config_for(args):
    """The port's EngineConfig from the card and the args, with the
    reference's defaults: a tiny model gets page size = the card's block
    size, 128 pages, 4 slots and prefill buckets (16, 32); a checkpoint
    directory (page size 16, its card's context length) 2048 pages and 16
    slots. ``--quantize``, ``--speculative`` and the LoRA flags reach both
    (a bad speculative or adapter spec raises the reference's ValueError;
    the adapters arrive as the CLI's comma string or a list, and the
    EngineConfig makes a tuple of either)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.frontends.pipeline import card_for_model

    _refuse_unported(args)
    card = card_for_model(args.model, getattr(args, "max_model_len", None))
    is_tiny = card.model_path.startswith("tiny")
    model_path = card.model_path
    speculative = getattr(args, "speculative", None)
    if is_tiny and ":" in model_path:
        # engine-level keys may ride the tiny-override JSON (one model
        # string configures a test engine end to end): pop them out before
        # the registry reads the rest as the model's config
        fam, js = model_path.split(":", 1)
        try:
            overrides = json.loads(js)
        except ValueError:
            overrides = None
        if isinstance(overrides, dict) and "speculative" in overrides:
            speculative = speculative or overrides.pop("speculative")
            model_path = fam + (":" + json.dumps(overrides) if overrides else "")
    common = dict(
        model_id=model_path,
        speculative=speculative,
        device=getattr(args, "device", None) or "cuda",
        page_size=card.kv_block_size,
        max_model_len=card.context_length,
        kv_cache_dtype=getattr(args, "kv_cache_dtype", None),
        quantize=getattr(args, "quantize", None),
        # serve once the core shapes are captured, the rest between serving
        # steps; the reference warms up so on its checkpoint path only, but
        # the port's tiny card serves full-width models on the card too
        warmup="background",
    )
    adapters = getattr(args, "lora_adapters", None)
    if adapters:
        common.update(
            lora_adapters=adapters,
            max_loras=getattr(args, "max_loras", None) or 4,
            lora_rank=getattr(args, "lora_rank", None) or 8,
        )
    if is_tiny:
        return EngineConfig(
            num_pages=getattr(args, "num_pages", None) or 128,
            max_seqs=getattr(args, "max_seqs", None) or 4,
            prefill_buckets=(16, 32),
            **common,
        )
    return EngineConfig(
        num_pages=getattr(args, "num_pages", None) or 2048,
        max_seqs=getattr(args, "max_seqs", None) or 16,
        **common,
    )


async def _build_engine(args):
    if args.output == "echo":
        from dynamo_tpu_torch.llm.echo import EchoEngine

        return EchoEngine()
    if args.output == "torch":
        from dynamo_tpu_torch.engine.engine import AsyncTorchEngine

        engine = AsyncTorchEngine(engine_config_for(args))
        await engine.start()
        return engine
    if args.output.startswith("pytok:"):
        raise NotPorted("--out pytok: (external Python engines)")
    if args.output.startswith("dyn://"):
        # remote engine: forward EngineRequests to a distributed endpoint that
        # speaks the worker wire protocol (reference: dynamo-run out=dyn://)
        from dynamo_tpu_torch.launch._remote import RemoteEngineProxy

        _refuse_unported(args)
        proxy = RemoteEngineProxy(args.output)
        await proxy.start()
        return proxy
    raise ValueError(f"unsupported out={args.output} (echo|torch|dyn://ns.comp.ep)")


async def _run(args) -> None:
    if args.input not in ("text", "http") and not args.input.startswith(("batch:", "dyn://")):
        raise ValueError(f"unsupported in={args.input}")
    engine = await _build_engine(args)
    try:
        if args.input == "text":
            from dynamo_tpu_torch.frontends.text import run_text

            await run_text(engine, args)
        elif args.input == "http":
            from dynamo_tpu_torch.frontends.http import run_http

            await run_http(engine, args)
        elif args.input.startswith("dyn://"):
            # expose this engine as a distributed endpoint (worker mode)
            from dynamo_tpu_torch.launch._remote import serve_engine_endpoint

            await serve_engine_endpoint(engine, args)
        else:
            from dynamo_tpu_torch.frontends.batch import run_batch

            await run_batch(engine, args, args.input.split(":", 1)[1])
    finally:
        await engine.shutdown()
