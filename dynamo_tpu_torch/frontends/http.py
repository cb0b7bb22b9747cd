"""in=http: serve the local pipeline over the OpenAI HTTP frontend.

Port of ``dynamo_tpu/frontends/http.py``: the model's pipeline and, for an
engine with LoRA adapters, one pipeline per adapter named
``<base>:<adapter>`` (``frontends/pipeline.py lora_pipelines``). Not ported
yet: the engine's metric families and health on ``/metrics`` and
``/ready``, SLO targets, the step-anatomy and cost debug sources.
"""

from __future__ import annotations

from dynamo_tpu_torch.frontends.pipeline import build_pipeline, card_for_model, lora_pipelines
from dynamo_tpu_torch.llm.http.service import HttpService


def build_service(engine, args, host: str = "0.0.0.0") -> HttpService:
    """The service ``run_http`` serves: the model's pipeline, and one per
    LoRA adapter of the engine, on ``args.http_port`` (0: a free port, which
    ``start()`` returns)."""
    card = card_for_model(args.model, getattr(args, "max_model_len", None))
    service = HttpService(host=host, port=args.http_port)
    pipeline = build_pipeline(engine, card)
    service.manager.add(pipeline)
    for lp in lora_pipelines(pipeline, getattr(getattr(engine, "config", None), "lora_adapters", ())):
        service.manager.add(lp)
    return service


async def run_http(engine, args) -> None:
    await build_service(engine, args).run_forever()
