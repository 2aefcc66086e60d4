"""repro_torch — the HOT SAX Time discord search on PyTorch and CUDA.

The same ``SearchSpec`` -> ``DiscordEngine`` session API as the JAX
package, with its distance tiles computed by kernels written for the
NVIDIA H100 (``csrc/``).  Sessions run on CUDA unless the caller passes
``device="cpu"``.
"""
from .core import (DiscordEngine, DiscordResult, EngineStats, PlanCache,
                   SearchSpec, TileEngine)

__all__ = ["SearchSpec", "DiscordEngine", "DiscordResult", "EngineStats",
           "PlanCache", "TileEngine"]
