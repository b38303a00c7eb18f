"""Batched LM serving on the port's models."""

from .engine import GenerationResult, ServeEngine

__all__ = ["GenerationResult", "ServeEngine"]
