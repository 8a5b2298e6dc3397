"""Versioned parameter store (DESIGN.md §Weight-publication path),
mirroring ``repro/core/weights.py::ParameterStore``.

The trainer publishes (version, weights); rollout workers pull the
latest, and ``get`` reaches the last ``keep`` versions.  Subscribers
(``subscribe``) hear of every publication, outside the store's lock, on
the publishing thread, in registration order.

The reference publishes an immutable parameter tree, so a stored version
can never change.  The port's trainer updates its ``LM`` in place, so
``publish`` stores a detached copy of every tensor of the model's state
dict: a published version stays as it was however the trainer goes on.
Each retained version holds one copy of the weights on their device.

Not in this part of the port: the background checkpoint spill
(``ckpt_dir``) and the streaming codecs (``full``/``delta``/``delta-q``
over state dicts) come with the runtimes.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

Weights = Dict[str, torch.Tensor]


class VersionEvicted(KeyError):
    """``ParameterStore.get`` of a version that WAS published but has
    been evicted from the history window — distinct from a version that
    was never published (which returns None).  Raised loudly so a
    proximal-recompute path that lost the race between ``latest()`` and
    ``get()`` fails instead of silently training on None."""


class ParameterStore:
    """Versioned trainer→rollout publication of detached weight copies."""

    def __init__(self, keep: int = 2, ckpt_dir: Optional[str] = None):
        if ckpt_dir:
            raise NotImplementedError(
                "ParameterStore(ckpt_dir=...): the checkpoint spill is part of "
                "slice 5 of the PyTorch port (runtimes and weight publication)")
        self._lock = threading.Lock()
        self._latest: Optional[Tuple[int, Weights]] = None
        self._history: Dict[int, Weights] = {}
        self._published: set = set()       # every version ever published
        self._subscribers: List[Callable[[int, Weights], None]] = []
        self.keep = keep
        self.publishes = 0

    def subscribe(self, fn: Callable[[int, Weights], None]) -> None:
        """Register a publication callback.  Safe to call while
        publishing."""
        with self._lock:
            self._subscribers.append(fn)

    def publish(self, version: int, model: torch.nn.Module) -> None:
        """Make a copy of ``model``'s weights the latest publication,
        under ``version``, and notify subscribers.  The versions that fall
        out of the window go before the copy is made, so the store never
        holds more than ``keep`` copies."""
        with self._lock:
            # the reference's eviction order: oldest first, never `version`
            others = sorted(v for v in self._history if v != version)
            for v in others[:max(0, len(others) - (self.keep - 1))]:
                del self._history[v]
        with torch.no_grad():
            snap = {name: t.detach().clone() for name, t in model.state_dict().items()}
        with self._lock:
            self._latest = (version, snap)
            self._history[version] = snap
            self._published.add(version)
            self.publishes += 1
            subscribers = list(self._subscribers)
        for fn in subscribers:             # outside the lock: callbacks
            fn(version, snap)              # may do slow transport sends

    def latest(self) -> Optional[Tuple[int, Weights]]:
        with self._lock:
            return self._latest

    def get(self, version: int) -> Optional[Weights]:
        """Weights of ``version`` from the history window.  A version that
        was published but already evicted raises ``VersionEvicted`` (the
        latest()/get() race must fail loudly); a version that was never
        published returns None."""
        with self._lock:
            weights = self._history.get(version)
            if weights is not None:
                return weights
            if version in self._published:
                raise VersionEvicted(
                    f"version {version} was published but evicted from the "
                    f"history window (keep={self.keep}); retained: "
                    f"{sorted(self._history)}")
            return None
