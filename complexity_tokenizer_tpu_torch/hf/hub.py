"""The HuggingFace Hub's local side: the cache layout
``<cache>/<org--name>/<file>`` and local-path resolution.

The port downloads nothing: a repository that is neither a local path
nor in the cache raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "HubConfig",
    "is_cached",
    "get_cache_path",
    "clear_cache",
    "clear_all_cache",
    "resolve_model_path",
]


def _default_cache_dir() -> Path:
    base = os.environ.get("XDG_CACHE_HOME")
    root = Path(base) if base else Path.home() / ".cache"
    return root / "huggingface" / "hub"


@dataclass
class HubConfig:
    cache_dir: Path = field(default_factory=_default_cache_dir)


def is_cached(repo_id: str, filename: str, config: HubConfig | None = None) -> bool:
    return (get_cache_path(repo_id, config) / filename).exists()


def get_cache_path(repo_id: str, config: HubConfig | None = None) -> Path:
    config = config or HubConfig()
    return Path(config.cache_dir) / repo_id.replace("/", "--")


def clear_cache(repo_id: str, config: HubConfig | None = None) -> None:
    path = get_cache_path(repo_id, config)
    if path.exists():
        shutil.rmtree(path)


def clear_all_cache(config: HubConfig | None = None) -> None:
    config = config or HubConfig()
    if Path(config.cache_dir).exists():
        shutil.rmtree(config.cache_dir)


def resolve_model_path(model_id: str, config: HubConfig | None = None) -> Path:
    """A local file, or a local directory's ``tokenizer.json``."""
    local = Path(model_id)
    if local.exists():
        if local.is_dir():
            tj = local / "tokenizer.json"
            if tj.exists():
                return tj
        return local
    raise NotImplementedError(
        f"{model_id!r} is not a local path, and the port has no network download"
    )
