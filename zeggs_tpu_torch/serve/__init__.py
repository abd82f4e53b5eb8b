"""Serving: the HTTP daemon with dynamic micro-batching and streaming
sessions (counterpart of `zeggs_tpu/serve`)."""

from .server import GestureServer

__all__ = ["GestureServer"]
