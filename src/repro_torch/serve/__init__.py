"""Serving: prefill, decode and greedy generation on the port's models."""

from .engine import decode_step, generate, prefill

__all__ = ["decode_step", "generate", "prefill"]
