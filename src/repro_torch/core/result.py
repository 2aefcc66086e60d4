"""Result container of a discord search.

``calls`` is the number of Eq. (3) distance evaluations the search
performed; on the tiled planes it is the swept tile area.
``tile_lanes`` is the share of ``calls`` that went through the
distance-tile engine (``core/tiles``), equal to ``calls`` on the fully
tiled planes.  ``cps`` is the paper's cost-per-sequence indicator
(Sec 4.2), ``calls / (N * k)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class DiscordResult:
    """Outcome of a k-discord search."""
    positions: List[int]
    nnds: List[float]
    calls: int
    n: int                      # number of sequences N
    s: int                      # sequence length
    method: str = "?"
    runtime_s: float = 0.0
    tile_lanes: int = 0         # lanes swept through core/tiles
    extra: dict = field(default_factory=dict)

    @property
    def k(self) -> int:
        return len(self.positions)

    @property
    def cps(self) -> float:
        return self.calls / (self.n * max(self.k, 1))

    def __repr__(self) -> str:  # compact, bench-friendly
        pos = ",".join(map(str, self.positions))
        nnd = ",".join(f"{v:.4f}" for v in self.nnds)
        return (f"DiscordResult({self.method}: pos=[{pos}] nnd=[{nnd}] "
                f"calls={self.calls} cps={self.cps:.2f} "
                f"t={self.runtime_s:.3f}s)")
