"""The offline dataset-construction pipeline (the port's own copy of
t2ms_tpu/pipeline/, which uses no JAX): LLM clients, captions, caption
embeddings, the T2S corpus tools and the motion feature mergers."""

from t2ms_tpu_torch.pipeline.llm import (FakeChat, FakeEmbed, OpenAIChat,
                                         OpenAIEmbed, with_retries)

__all__ = ["FakeChat", "FakeEmbed", "OpenAIChat", "OpenAIEmbed",
           "with_retries"]
