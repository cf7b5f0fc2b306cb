"""Padding and truncation configuration (``enable_padding``,
``enable_truncation``)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PaddingConfig", "TruncationConfig"]


@dataclass
class PaddingConfig:
    enabled: bool = False
    strategy: str = ""  # "longest" | "max_length"
    pad_to_multiple_of: int | None = None
    direction: str = ""  # "right" | "left"


@dataclass
class TruncationConfig:
    enabled: bool = False
    max_length: int = 0
    strategy: str = ""  # "longest_first" | "only_first" | "only_second"
    stride: int = 0
    direction: str = ""  # "right" | "left"
