"""Serving: a paged K/V pool and the continuous-batching engine."""

from .engine import PageAllocator, Request, ServingEngine

__all__ = ["PageAllocator", "Request", "ServingEngine"]
