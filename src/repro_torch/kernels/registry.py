"""Registry of distance-tile backends — the single home of Eq. (3).

A backend is a callable

    fn(qwin, qmu, qsig, qid, cwin, cmu, csig, cid, *, s, n_valid) -> d2

taking f32 window blocks (Bq, s)/(Bc, s), their per-window stats, and
their *global* window ids (i32; negative or >= n_valid means padding),
and returning the masked (Bq, Bc) f32 d2 tile.

  * ``torch`` — the plain PyTorch tile (``kernels/tile_d2.py``).
  * ``cuda``  — the hand-written kernel ``csrc/tile_d2.cu``.

Resolution order (``resolve_backend``): explicit argument >
``REPRO_TORCH_TILE_BACKEND`` > ``cuda``.  It never looks at whether a
GPU exists: where the tensors lie decides that, and the ``cuda``
wrapper computes the plain version only for CPU tensors.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from .tile_d2 import tile_d2_cuda, tile_d2_torch

__all__ = ["ENV_VAR", "DEFAULT_BACKEND", "register_backend",
           "get_backend", "available_backends", "resolve_backend"]

ENV_VAR = "REPRO_TORCH_TILE_BACKEND"
DEFAULT_BACKEND = "cuda"

_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator: add a tile backend under ``name``."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn
    return deco


register_backend("torch")(tile_d2_torch)
register_backend("cuda")(tile_d2_cuda)


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown tile backend {name!r}; available: "
            f"{available_backends()}") from None


def resolve_backend(name: Optional[str] = None) -> str:
    """explicit arg > REPRO_TORCH_TILE_BACKEND env > ``cuda``."""
    if name is None:
        name = os.environ.get(ENV_VAR) or DEFAULT_BACKEND
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown tile backend {name!r}; available: "
            f"{available_backends()}")
    return name
