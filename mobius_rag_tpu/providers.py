"""Provider registries: embeddings, LLM configs, prompts.

Reference parity (§2.2):
- embedding provider ABC + env-selected registry
  (app/services/embedding_provider.py:24-149). The default provider is
  the ON-CHIP encoder (models/encoder.py) — the reference's two API
  providers (OpenAI batch-100, Vertex batch-1) become one generic
  HTTP adapter that deployments can point anywhere; the on-device path removes
  the per-request embedding bottleneck entirely (SURVEY §2.9).
- LLM config registry: named configs from YAML + runtime CRUD with
  secret redaction (app/services/llm_config.py).
- prompt registry: versioned prompt files with sha addressing
  (app/services/prompt_registry.py:15-160).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Callable, Protocol

import numpy as np
import yaml

from mobius_rag_tpu.config import get_config

# ---------------------------------------------------------------------------
# Embedding providers
# ---------------------------------------------------------------------------


class EmbeddingProvider(Protocol):
    name: str
    dim: int

    def embed(self, texts: list[str]) -> np.ndarray: ...


class OnChipProvider:
    """Batched on-device encoder — the default."""

    def __init__(self, model=None):
        from mobius_rag_tpu.models.encoder import EncoderModel

        self.model = model or EncoderModel()
        self.name = "onchip"
        self.dim = self.model.cfg.out_dim

    def embed(self, texts: list[str]) -> np.ndarray:
        return self.model(texts)

    __call__ = embed


class HashProvider:
    """Deterministic bag-of-words provider for tests/air-gapped runs."""

    def __init__(self, dim: int | None = None):
        self.name = "hash"
        self.dim = dim or get_config().embed_dim

    def embed(self, texts: list[str]) -> np.ndarray:
        from mobius_rag_tpu.testing import hash_embed

        return hash_embed(texts, self.dim)

    __call__ = embed


class ExternalHTTPProvider:
    """Generic JSON-over-HTTP embedding adapter (the deployment hook for
    OpenAI/Vertex-style services). Gated: constructing it without a URL
    raises, and zero-egress pods simply never select it."""

    def __init__(self, url: str, *, dim: int | None = None, batch_size: int = 100,
                 headers: dict[str, str] | None = None, timeout_s: float = 30.0):
        if not url:
            raise ValueError("ExternalHTTPProvider requires MRAG_EMBED_URL")
        self.name = "external"
        self.url = url
        self.dim = dim or get_config().embed_dim
        self.batch_size = batch_size
        self.headers = headers or {}
        self.timeout_s = timeout_s

    def embed(self, texts: list[str]) -> np.ndarray:
        import json
        import urllib.request

        out = np.zeros((len(texts), self.dim), np.float32)
        for off in range(0, len(texts), self.batch_size):
            batch = texts[off:off + self.batch_size]
            req = urllib.request.Request(
                self.url, method="POST",
                data=json.dumps({"inputs": batch}).encode(),
                headers={"Content-Type": "application/json", **self.headers},
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                vecs = json.loads(resp.read())["embeddings"]
            out[off:off + len(batch)] = np.asarray(vecs, np.float32)
        return out

    __call__ = embed


def _openai_factory() -> EmbeddingProvider:
    from mobius_rag_tpu.providers_external import OpenAIEmbeddingProvider

    return OpenAIEmbeddingProvider()


def _vertex_factory() -> EmbeddingProvider:
    from mobius_rag_tpu.providers_external import VertexEmbeddingProvider

    return VertexEmbeddingProvider()


_PROVIDER_FACTORIES: dict[str, Callable[[], EmbeddingProvider]] = {
    "onchip": OnChipProvider,
    "hash": HashProvider,
    "external": lambda: ExternalHTTPProvider(os.getenv("MRAG_EMBED_URL", "")),
    # concrete wire-format adapters (providers_external.py) — the
    # reference's two SDK providers (embedding_provider.py:24-149)
    "openai": _openai_factory,
    "vertex": _vertex_factory,
}


def register_embedding_provider(name: str, factory: Callable[[], EmbeddingProvider]) -> None:
    _PROVIDER_FACTORIES[name] = factory


def get_embedding_provider(name: str | None = None) -> EmbeddingProvider:
    """Env-selected factory (MRAG_EMBED_PROVIDER, default onchip)."""
    key = name or os.getenv("MRAG_EMBED_PROVIDER", "onchip")
    if key not in _PROVIDER_FACTORIES:
        raise ValueError(f"unknown embedding provider {key!r}; "
                         f"registered: {sorted(_PROVIDER_FACTORIES)}")
    return _PROVIDER_FACTORIES[key]()


# ---------------------------------------------------------------------------
# LLM config registry
# ---------------------------------------------------------------------------

_SECRET_KEYS = ("api_key", "token", "secret", "password", "credential")


@dataclasses.dataclass
class LLMConfig:
    name: str
    provider: str = "offline"  # offline | http | vertex | openai | ...
    model: str = ""
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    secrets: dict[str, str] = dataclasses.field(default_factory=dict)

    def redacted(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["secrets"] = {k: "***" for k in self.secrets}
        d["params"] = {
            k: ("***" if any(s in k.lower() for s in _SECRET_KEYS) else v)
            for k, v in self.params.items()
        }
        return d


class LLMConfigRegistry:
    def __init__(self, yaml_dir: str | None = None):
        self.configs: dict[str, LLMConfig] = {}
        if yaml_dir and os.path.isdir(yaml_dir):
            for fn in sorted(os.listdir(yaml_dir)):
                if fn.endswith((".yaml", ".yml")):
                    with open(os.path.join(yaml_dir, fn)) as f:
                        raw = yaml.safe_load(f) or {}
                    name = raw.get("name") or fn.rsplit(".", 1)[0]
                    self.configs[name] = LLMConfig(
                        name=name, provider=raw.get("provider", "offline"),
                        model=raw.get("model", ""),
                        params=raw.get("params", {}) or {},
                        secrets=raw.get("secrets", {}) or {},
                    )

    def upsert(self, cfg: LLMConfig) -> None:
        self.configs[cfg.name] = cfg

    def get(self, name: str) -> LLMConfig | None:
        return self.configs.get(name)

    def delete(self, name: str) -> bool:
        return self.configs.pop(name, None) is not None

    def list_redacted(self) -> list[dict[str, Any]]:
        return [c.redacted() for c in self.configs.values()]


# ---------------------------------------------------------------------------
# Prompt registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PromptVersion:
    stage: str  # extraction | critique | extraction_retry | synthesis | judge ...
    version: str  # "v3"
    text: str
    sha: str = ""

    def __post_init__(self):
        if not self.sha:
            self.sha = hashlib.sha256(self.text.encode()).hexdigest()[:16]


class PromptRegistry:
    """Versioned prompts: stage → {version → PromptVersion}; newest
    version wins by default; any version addressable by sha."""

    def __init__(self, yaml_dir: str | None = None):
        self.prompts: dict[str, dict[str, PromptVersion]] = {}
        self._by_sha: dict[str, PromptVersion] = {}
        if yaml_dir and os.path.isdir(yaml_dir):
            for stage in sorted(os.listdir(yaml_dir)):
                stage_dir = os.path.join(yaml_dir, stage)
                if not os.path.isdir(stage_dir):
                    continue
                for fn in sorted(os.listdir(stage_dir)):
                    if fn.endswith((".yaml", ".yml")):
                        with open(os.path.join(stage_dir, fn)) as f:
                            raw = yaml.safe_load(f) or {}
                        self.put(stage, fn.rsplit(".", 1)[0],
                                 raw.get("text") or raw.get("prompt") or "")

    def put(self, stage: str, version: str, text: str) -> PromptVersion:
        pv = PromptVersion(stage, version, text)
        self.prompts.setdefault(stage, {})[version] = pv
        self._by_sha[pv.sha] = pv
        return pv

    def get(self, stage: str, version: str | None = None) -> PromptVersion | None:
        versions = self.prompts.get(stage) or {}
        if not versions:
            return None
        if version:
            return versions.get(version)
        return versions[max(versions)]  # lexicographically newest ("v9" < "v10" caveat: zero-pad in names)

    def by_sha(self, sha: str) -> PromptVersion | None:
        return self._by_sha.get(sha)

    def list_all(self) -> list[dict[str, str]]:
        return [
            {"stage": s, "version": v, "sha": pv.sha}
            for s, versions in sorted(self.prompts.items())
            for v, pv in sorted(versions.items())
        ]

    def delete(self, stage: str, version: str) -> bool:
        pv = (self.prompts.get(stage) or {}).pop(version, None)
        if pv is None:
            return False
        self._by_sha.pop(pv.sha, None)
        if not self.prompts.get(stage):
            self.prompts.pop(stage, None)
        return True
