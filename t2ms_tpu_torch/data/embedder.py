"""Pluggable text-embedding providers (counterpart of
t2ms_tpu/data/embedder.py).

  * PrecomputedEmbedder — default: embeddings come from the dataset (CSV
    columns), no network.
  * FakeEmbedder — deterministic hash-seeded unit vectors for tests and
    benches: ``pipeline.llm.FakeEmbed``'s, as in the JAX package.
  * OpenAIEmbedder — the reference's live path (myinfer.py:24-46), gated
    on the ``openai`` package and OPENAI_API_KEY.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np

__all__ = ["TextEmbedder", "PrecomputedEmbedder", "FakeEmbedder",
           "OpenAIEmbedder", "build_benchpress_prefix", "get_embedder"]


def build_benchpress_prefix(text: str) -> str:
    """The caption prefix prepended before live embedding
    (myinfer.py:36-37)."""
    return ("The following presents the smooth feature description for the "
            "bench press as follows: \n" + text)


class TextEmbedder(Protocol):
    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray: ...


class PrecomputedEmbedder:
    """Pass-through: batches already carry their embeddings."""
    def __init__(self, dim: int = 128):
        self.dim = dim

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        raise RuntimeError(
            "PrecomputedEmbedder expects embeddings in the batch; "
            "no live embedding is performed.")


class FakeEmbedder:
    """Deterministic unit-norm embedding seeded by the first 8 bytes of
    the text's SHA-256: an offline stand-in for the OpenAI call. Delegates
    to ``pipeline.llm.FakeEmbed``, so the dataset-construction and
    inference paths give the same vectors."""
    def __init__(self, dim: int = 128):
        self.dim = dim

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        from t2ms_tpu_torch.pipeline.llm import FakeEmbed
        fe = FakeEmbed(self.dim)
        return np.asarray([fe.embed(t) for t in texts], np.float32)


class OpenAIEmbedder:
    """Live parity path (myinfer.py:40-46). Requires the ``openai`` package
    and OPENAI_API_KEY; raises a clear error otherwise."""
    def __init__(self, dim: int = 128,
                 model: str = "text-embedding-3-large",
                 prefix_builder=build_benchpress_prefix):
        self.dim = dim
        self.model = model
        self.prefix_builder = prefix_builder
        try:
            import openai  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "openai package not installed; use FakeEmbedder or "
                "PrecomputedEmbedder") from e
        self._client = openai.OpenAI()

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        inputs = [self.prefix_builder(t).replace("\n", " ") for t in texts]
        r = self._client.embeddings.create(input=inputs, model=self.model,
                                           dimensions=self.dim)
        return np.asarray([d.embedding for d in r.data], np.float32)


def get_embedder(name: str, dim: int = 128) -> "TextEmbedder":
    if name == "precomputed":
        return PrecomputedEmbedder(dim)
    if name == "fake":
        return FakeEmbedder(dim)
    if name == "openai":
        return OpenAIEmbedder(dim)
    raise ValueError(f"unknown embedder {name}")
