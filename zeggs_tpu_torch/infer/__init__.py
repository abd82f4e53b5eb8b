"""Offline inference: GesturePipeline and generate_gesture."""

from .generate import GesturePipeline, generate_gesture  # noqa: F401
