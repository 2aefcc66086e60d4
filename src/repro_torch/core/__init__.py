"""repro_torch.core — the discord-search session API on PyTorch.

  * spec / engine  — typed SearchSpec and the plan-cached DiscordEngine
  * tiles          — the distance-tile engine (``torch`` | ``cuda``)
  * result         — DiscordResult
"""
from .engine import DiscordEngine, EngineStats, PlanCache
from .result import DiscordResult
from .spec import SearchSpec
from .tiles import TileEngine

__all__ = ["SearchSpec", "DiscordEngine", "EngineStats", "PlanCache",
           "DiscordResult", "TileEngine"]
