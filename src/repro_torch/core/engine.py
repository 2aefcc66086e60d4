"""Discord-search sessions: ``DiscordEngine`` with a bucketed plan cache.

``DiscordEngine`` owns a plan cache keyed on ``(kind, s,
length_bucket)`` behind the spec prefix ``(backend, znorm, block,
precision)``.  Series lengths are rounded up to power-of-two buckets
and the padding windows are *masked* inside the tile backends (their
ids remap to -1), so a second search over any series in the same
bucket reuses the plan: ``stats.plans`` and ``stats.traces`` do not
move.  A plan is a shape-keyed Python callable run eagerly on the
session's device; building one counts as the one trace a compiled plan
would take.

This module holds the exact-profile session (``method="matrix_profile"``
at ``precision="f32"`` on one device).  Every other search raises
``NotImplementedError`` naming the ROADMAP.md queue item that brings
it.

Device rule: ``DiscordEngine(spec)`` runs on ``cuda``.  Without a CUDA
device that raises; only a caller who passes ``device="cpu"`` runs on
the CPU.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels.common import ceil_div
from ..kernels.registry import resolve_backend
from .result import DiscordResult
from .spec import SearchSpec, length_bucket
from .tiles import TileEngine, resolve_device, topk_nonoverlapping

__all__ = ["DiscordEngine", "EngineStats", "PlanCache", "PAD_FILL",
           "plan_pad_geom"]

#: host-side fill of the length-bucket padding.  Results never depend
#: on it — every padded lane's id is masked to -1 downstream.
PAD_FILL = 0.0

_QUEUE = "ROADMAP.md queue 1"


def plan_pad_geom(s: int, Lb: int, block: int) -> int:
    """Padded window count of a bucket-``Lb`` sweep at window ``s`` —
    the tile-grid geometry every plan builder keys on."""
    return ceil_div(Lb - s + 1, block) * block


def _bucket_pad(x, Lb: int) -> np.ndarray:
    """Bucket-pad a series to ``Lb`` samples of f32, filling the pad
    with PAD_FILL."""
    x = np.asarray(x)
    xp = np.full(Lb, PAD_FILL, np.float32)
    xp[:x.shape[0]] = x
    return xp


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; it comes with "
        f"{_QUEUE}, '{item}'")


class PlanCache:
    """The session's plans, keyed by full ``_plan_key`` tuples;
    ``hits`` / ``misses`` count lookups."""

    def __init__(self):
        self._plans: dict = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, key, thunk) -> Tuple[Callable, bool]:
        """The cached plan under ``key``, building via ``thunk()`` on
        a miss.  Returns ``(fn, fresh)`` — ``fresh`` tells the calling
        engine to count a new plan."""
        fn = self._plans.get(key)
        if fn is not None:
            self.hits += 1
            return fn, False
        self.misses += 1
        fn = self._plans[key] = thunk()
        return fn, True


@dataclass
class EngineStats:
    """Session counters (host-side accounting).

    ``traces`` counts plan builds — the contract is ``traces ==
    plans`` for the session.  ``tile_lanes`` counts distance lanes
    swept through the tile engine.
    """
    traces: int = 0
    plans: int = 0
    searches: int = 0
    appends: int = 0
    tile_lanes: int = 0

    def as_dict(self) -> dict:
        return {"traces": self.traces, "plans": self.plans,
                "searches": self.searches, "appends": self.appends,
                "tile_lanes": self.tile_lanes}


class DiscordEngine:
    """A discord-search session for one :class:`SearchSpec`.

        eng = DiscordEngine(SearchSpec(s=128, k=3,
                                       method="matrix_profile"))
        r1 = eng.search(x)            # builds the bucket's plan
        r2 = eng.search(y)            # same bucket: no new plan

    ``device`` is ``"cuda"`` by default; pass ``device="cpu"`` to run
    on the CPU (the tile backends then compute the plain version).
    """

    def __init__(self, spec: Optional[SearchSpec] = None, *,
                 device=None, mesh=None, **spec_kwargs):
        if spec is None:
            spec = SearchSpec(**spec_kwargs)
        elif spec_kwargs:
            raise TypeError("pass either a SearchSpec or spec kwargs, "
                            "not both")
        if not isinstance(spec, SearchSpec):
            raise TypeError(f"spec must be a SearchSpec, got "
                            f"{type(spec).__name__}")
        if mesh is not None or spec.ndev is not None:
            raise _not_ported("mesh placement (mesh= / SearchSpec.ndev)",
                              "Multi-device")
        self.spec = spec
        self.device = resolve_device(device)
        # resolve once at session start so env-var flips mid-session
        # can't split the plan cache across backends
        self.backend = resolve_backend(spec.backend)
        self.stats = EngineStats()
        self.plan_cache = PlanCache()

    def __repr__(self) -> str:
        return (f"DiscordEngine({self.spec}, backend={self.backend}, "
                f"device={self.device}, plans={self.stats.plans}, "
                f"traces={self.stats.traces})")

    # -- plan cache ----------------------------------------------------
    def _n_pad(self, s: int, Lb: int) -> int:
        """Padded window count of bucket ``Lb`` (tile geometry)."""
        return plan_pad_geom(s, Lb, self.spec.block)

    def _plan_key(self, key):
        """Full cache key of a plan: the session-invariant spec prefix
        (``backend``/``znorm``/``block``/``precision``) + the kind's
        own key."""
        return (self.backend, self.spec.znorm, self.spec.block,
                self.spec.precision) + tuple(key)

    def _get_plan(self, key, build):
        fn, fresh = self.plan_cache.get(self._plan_key(key), build)
        if fresh:
            self.stats.plans += 1
        return fn

    def _profile_body(self, s: int):
        """Per-series bucketed profile body: (series_pad, n_valid) ->
        (d2 (n_pad,), neighbor)."""
        spec, be, dev = self.spec, self.backend, self.device

        def body(series_pad, n_valid):
            eng = TileEngine(series_pad, s, block=spec.block,
                             backend=be, znorm=spec.znorm,
                             n_valid=n_valid, device=dev)
            return eng.profile()
        return body

    def _profile_plan(self, s: int, Lb: int):
        """(series_pad (Lb,), n_valid) -> (d2 (n_pad,), neighbor)."""
        def build():
            self.stats.traces += 1
            return self._profile_body(s)
        return self._get_plan(("profile", s, Lb), build)

    # -- searches ------------------------------------------------------
    def search(self, series, **kw) -> DiscordResult:
        """Top-k discords of a 1-D series under this engine's spec."""
        spec = self.spec
        if spec.multi_window:
            raise _not_ported("multi-window search (tuple s)",
                              "Pan ladder")
        if spec.method != "matrix_profile":
            raise _not_ported(f"method={spec.method!r}", {
                "hst_jax": "Blocked HST", "ring": "Multi-device",
                "drag": "Multi-device"}.get(spec.method,
                                            "Serial counted plane"))
        if spec.precision != "f32":
            raise _not_ported(f"precision={spec.precision!r}",
                              "Quantized plane")
        if kw:
            raise TypeError("matrix_profile search is fully described "
                            "by the spec and takes no extra kwargs, got "
                            f"{sorted(kw)}")
        return self._search_profile(series, spec.s)

    def _search_profile(self, series, s: int) -> DiscordResult:
        """Bucketed, plan-cached exact-profile search."""
        t0 = time.perf_counter()
        x = np.asarray(series, np.float64).ravel()
        L = x.shape[0]
        if L < s + 1:
            raise ValueError(f"series of {L} points is too short for "
                             f"window spec.s={s} (need at least "
                             f"s + 1 points)")
        n_true = L - s + 1
        Lb = length_bucket(L)
        xp = torch.from_numpy(_bucket_pad(x, Lb)).to(self.device)
        d2, _arg = self._profile_plan(s, Lb)(xp, n_true)
        prof = np.sqrt(d2.cpu().numpy().astype(np.float64)[:n_true])
        pos, vals = topk_nonoverlapping(
            np.where(np.isfinite(prof), prof, -np.inf), self.spec.k, s)
        lanes = self._n_pad(s, Lb) ** 2
        self.stats.searches += 1
        self.stats.tile_lanes += lanes
        return DiscordResult(
            positions=pos, nnds=vals,
            calls=lanes,                  # swept tile lanes
            n=n_true, s=s, method=f"scamp[{self.backend}]",
            runtime_s=time.perf_counter() - t0, tile_lanes=lanes,
            extra={"backend": self.backend, "bucket": Lb,
                   "tile_lanes": lanes, "znorm": self.spec.znorm,
                   "device": str(self.device)})
