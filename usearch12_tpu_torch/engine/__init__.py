"""Window-batched search engine with the hole DP on the card."""

from .batch import TorchBatchEngine

__all__ = ["TorchBatchEngine"]
