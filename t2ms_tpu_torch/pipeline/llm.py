"""LLM client abstraction for the offline dataset-construction pipeline.

The reference calls OpenAI directly (Caption_Generation.py:16-27 chat,
Embedding_Generation.py:13-19 embeddings). Here both are behind minimal
protocols with an OpenAI implementation (gated on the package + API key)
and deterministic fakes, so the entire pipeline runs and is testable with
zero egress.
"""

from __future__ import annotations

import hashlib
import time
from typing import Protocol

import numpy as np

__all__ = ["ChatClient", "EmbedClient", "OpenAIChat", "OpenAIEmbed",
           "FakeChat", "FakeEmbed", "with_retries"]


class ChatClient(Protocol):
    def complete(self, system: str, user: str) -> str: ...


class EmbedClient(Protocol):
    dim: int

    def embed(self, text: str) -> list: ...


class OpenAIChat:
    """gpt-4o-mini, temperature 0 (Caption_Generation.py:16-27)."""

    def __init__(self, model: str = "gpt-4o-mini"):
        import openai  # raises if unavailable — caller gates
        self._client = openai.OpenAI()
        self.model = model

    def complete(self, system: str, user: str) -> str:
        c = self._client.chat.completions.create(
            model=self.model,
            messages=[{"role": "system", "content": system},
                      {"role": "user", "content": user}],
            temperature=0)
        return str(c.choices[0].message.content).strip()


class OpenAIEmbed:
    """text-embedding-3-large, dimensions=128
    (Embedding_Generation.py:13-19)."""

    def __init__(self, model: str = "text-embedding-3-large", dim: int = 128):
        import openai
        self._client = openai.OpenAI()
        self.model = model
        self.dim = dim

    def embed(self, text: str) -> list:
        text = text.replace("\n", " ")
        r = self._client.embeddings.create(input=[text], model=self.model,
                                           dimensions=self.dim)
        return r.data[0].embedding


class FakeChat:
    """Deterministic caption generator for offline runs/tests."""

    def complete(self, system: str, user: str) -> str:
        h = hashlib.sha256(user.encode()).hexdigest()[:8]
        # answer with the schema THE PROMPT asks for — a trend prompt
        # answered with a Summary payload made corpus.trend_caption
        # silently write empty Text for every sample
        if "Trend Analysis" in user:
            return '{"Trend Analysis": "synthetic trend %s"}' % h
        if "JSON format" in user or "Summary" in user:
            return '{"Summary": "synthetic summary %s"}' % h
        return f"synthetic pairwise description {h}"


class FakeEmbed:
    def __init__(self, dim: int = 128):
        self.dim = dim

    def embed(self, text: str) -> list:
        seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                              "little")
        v = np.random.default_rng(seed).standard_normal(self.dim)
        return (v / np.linalg.norm(v)).tolist()


def with_retries(fn, max_retries: int = 3, error_log: str = None,
                 label: str = ""):
    """Retry wrapper with error-log append (reference retry loop,
    Caption_Generation.py:166-194)."""
    for attempt in range(max_retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — pipeline resilience
            print(f"Error occurred: {e}. Retrying "
                  f"{attempt + 1}/{max_retries}...")
            time.sleep(0.1 * (attempt + 1))
    msg = f"Failed to process sample {label} after {max_retries} retries."
    if error_log:
        with open(error_log, "a") as f:
            f.write(msg + "\n")
    print(msg)
    return None
