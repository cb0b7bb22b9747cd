"""Build the local serving pipeline (preprocessor -> backend -> engine) from a
model deployment card, mirroring the reference's pipeline link chain for core
engines (reference: launch/dynamo-run/src/input/http.rs:95-101).

Port of ``dynamo_tpu/frontends/pipeline.py``: a remote engine
(``launch/_remote.RemoteEngineProxy``, ``--out dyn://``) gets the text
backend that passes its worker's detokenized text through. Multi-LoRA:
``lora_pipelines`` serves each configured adapter as its own model name
``<base>:<adapter>`` through ``LoraPreprocessor``, which stamps the
adapter's name on every request; the backend and engine are shared.
"""

from __future__ import annotations

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http.service import ModelPipeline
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import get_tokenizer


def build_pipeline(engine, card: ModelDeploymentCard) -> ModelPipeline:
    from dynamo_tpu_torch.launch._remote import RemoteEngineProxy, RemoteTextBackend

    tokenizer = get_tokenizer(card.tokenizer)
    preprocessor = OpenAIPreprocessor(tokenizer, model_name=card.display_name, max_model_len=card.context_length)
    if isinstance(engine, RemoteEngineProxy):
        backend = RemoteTextBackend(engine)  # the remote worker already detokenizes
    else:
        backend = Backend(engine, tokenizer)
    return ModelPipeline(card.display_name, preprocessor, backend)


class LoraPreprocessor:
    """A preprocessor that pins one adapter name onto every request it
    produces: the colocated half of ``base:adapter`` model names (a worker
    behind the runtime resolves the suffix itself, ``components/worker.py``)."""

    def __init__(self, inner, adapter: str):
        self._inner = inner
        self.adapter = adapter

    @property
    def tokenizer(self):
        return self._inner.tokenizer

    def preprocess_chat(self, req):
        pre, annotations = self._inner.preprocess_chat(req)
        pre.lora_name = self.adapter
        return pre, annotations

    def preprocess_completion(self, req):
        pre, annotations = self._inner.preprocess_completion(req)
        pre.lora_name = self.adapter
        return pre, annotations


def lora_pipelines(base: ModelPipeline, adapter_specs) -> list[ModelPipeline]:
    """One pipeline per configured adapter, named ``<base>:<adapter>``,
    sharing the base pipeline's backend; an adapter name not configured is
    then an unknown model (404 ``model_not_found`` at the HTTP edge)."""
    from dynamo_tpu_torch.lora.adapter import parse_adapter_specs

    return [
        ModelPipeline(f"{base.name}:{name}", LoraPreprocessor(base.preprocessor, name), base.backend)
        for name in parse_adapter_specs(adapter_specs)
    ]


def card_for_model(model_id: str | None, max_model_len: int | None = None) -> ModelDeploymentCard:
    from dynamo_tpu_torch.models.registry import is_tiny_family

    if is_tiny_family(model_id):
        card = ModelDeploymentCard.for_tiny(model_id or "tiny")
        card.model_path = model_id or "tiny"
    else:
        card = ModelDeploymentCard.from_local_path(model_id)
    if max_model_len:
        card.context_length = max_model_len
    return card
