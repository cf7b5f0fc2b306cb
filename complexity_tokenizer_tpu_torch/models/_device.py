"""The device tier a model builds once per device."""

from __future__ import annotations

import threading

from ..utils.device import resolve_device

__all__ = ["DeviceTiers"]


class DeviceTiers:
    """``get(device)`` resolves ``device`` (``cuda`` unless the caller asks
    for the CPU; raises without a card) and returns the tier ``build(dev)``
    made for it, built once per device: None when the model's tables are
    not eligible.  A failed build or launch raises."""

    def __init__(self, build):
        self._build = build
        self._tiers: dict = {}
        self._lock = threading.Lock()

    def get(self, device=None):
        dev = resolve_device(device)
        with self._lock:
            if dev not in self._tiers:
                self._tiers[dev] = self._build(dev)
            return self._tiers[dev]
