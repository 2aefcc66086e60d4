"""Typed, frozen search specification — the key of every plan.

A ``SearchSpec`` is one validated, *hashable* description of a discord
search: window length(s), k, method, z-normalization, tile backend,
SAX parameters, RNG seed, the DADD threshold, the tile block side, the
device count and the sweep precision.  It keys the
:class:`repro_torch.core.engine.DiscordEngine` plan cache, so two
searches that agree on the spec and the length bucket share one plan.

The fields and their validation are those of the JAX package's spec,
so one spec describes a search in either package.  Only the backend
names differ: ``torch`` is the plain PyTorch tile, ``cuda`` the
hand-written kernel.  :meth:`SearchSpec.from_fields` carries a JAX
spec (as ``dataclasses.asdict``) across, mapping its backend names.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple, Union

__all__ = ["SearchSpec", "canonical_method", "length_bucket",
           "SERIAL_METHODS", "JAX_METHODS", "METHOD_ALIASES",
           "RAW_CAPABLE", "PRECISIONS", "FOREIGN_BACKENDS"]

#: paper-faithful serial implementations (exact distance-call counting)
SERIAL_METHODS = ("brute", "hotsax", "hst", "dadd", "rra")
#: blocked accelerator implementations (canonical names; the name is
#: the JAX package's, kept so specs carry across unchanged)
JAX_METHODS = ("hst_jax", "matrix_profile", "ring", "drag")
#: accepted alternate spellings -> canonical name
METHOD_ALIASES = {
    "distributed": "ring",
    "ring_mp": "ring",
    "scamp": "matrix_profile",
    "mp": "matrix_profile",
}
#: methods that honor znorm=False (everything else is Eq. (3)-only and
#: would silently z-normalize — rejected at spec validation)
RAW_CAPABLE = ("brute", "hst", "matrix_profile")
#: tile sweep precisions: "f32" is the exact baseline; "bf16"/"int8"
#: run the quantized bound pass + exact f32 refinement
PRECISIONS = ("f32", "bf16", "int8")
#: the JAX package's tile backends -> this package's: its XLA and NumPy
#: tiles become the plain PyTorch tile, its Pallas kernel the CUDA one
FOREIGN_BACKENDS = {"xla": "torch", "numpy": "torch", "pallas": "cuda"}


def canonical_method(method: str) -> str:
    """Map any accepted spelling to the canonical method name."""
    m = METHOD_ALIASES.get(method, method)
    if m not in SERIAL_METHODS + JAX_METHODS:
        raise ValueError(
            f"unknown method {method!r}; pick one of "
            f"{SERIAL_METHODS + JAX_METHODS} "
            f"(aliases: {sorted(METHOD_ALIASES)})")
    return m


def length_bucket(n: int, lo: int = 256) -> int:
    """Smallest power of two >= max(n, lo): bounds the number of plans
    while the masked padding keeps results exact."""
    b = int(lo)
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class SearchSpec:
    """Frozen description of a discord search (hashable plan-cache key).

    Fields
    ------
    s       window length, or a tuple of lengths for multi-window
            (pan-ladder) search (requires ``method="matrix_profile"``)
    k       number of discords
    method  canonical algorithm name (aliases accepted, see
            :func:`canonical_method`)
    znorm   Eq. (3) z-normalized distance (True) or raw Euclidean
            (False; only ``brute | hst | matrix_profile`` honor it)
    backend distance-tile backend (``torch`` | ``cuda``) or None for
            the registry's resolution order (argument > env > cuda)
    P, alpha  SAX word length / alphabet size (hotsax, hst, rra)
    seed    RNG seed for the randomized orders / sampling recipes
    r       DADD/DRAG abandon threshold (None = paper sampling recipe)
    block   query tile side of the engine's profile sweep
    ndev    device count of the sharded plan family (ring | drag |
            matrix_profile); None = single device
    precision  ``"f32"`` (exact) or ``"bf16"`` / ``"int8"`` (quantized
            bound pass + f32 refinement; matrix_profile | ring only)
    """
    s: Union[int, Tuple[int, ...]]
    k: int = 1
    method: str = "hst"
    znorm: bool = True
    backend: Optional[str] = None
    P: int = 4
    alpha: int = 4
    seed: int = 0
    r: Optional[float] = None
    block: int = 256
    ndev: Optional[int] = None
    precision: str = "f32"

    def __post_init__(self):
        # normalize: list/tuple s -> tuple of ints, scalar -> int
        s = self.s
        if isinstance(s, (list, tuple)):
            s = tuple(int(v) for v in s)
            if len(s) == 1:
                s = s[0]
        else:
            s = int(s)
        object.__setattr__(self, "s", s)
        object.__setattr__(self, "method", canonical_method(self.method))
        if self.backend is not None:
            from ..kernels.registry import resolve_backend
            object.__setattr__(self, "backend",
                               resolve_backend(self.backend))
        for name in ("k", "P", "alpha", "seed", "block"):
            object.__setattr__(self, name, int(getattr(self, name)))
        object.__setattr__(self, "znorm", bool(self.znorm))
        if self.r is not None:
            object.__setattr__(self, "r", float(self.r))
        if self.ndev is not None:
            object.__setattr__(self, "ndev", int(self.ndev))
            if self.ndev < 1:
                raise ValueError(f"ndev must be >= 1, got {self.ndev}")
            if self.method not in ("ring", "drag", "matrix_profile"):
                raise ValueError(
                    "ndev applies to the mesh-sharded plan family "
                    "(ring | drag, and matrix_profile's batched/"
                    f"stream layouts); method={self.method!r} is "
                    "single-device")
        for name in ("k", "P", "alpha", "block"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        for sv in self.windows:
            if sv < 2:
                raise ValueError(f"window length must be >= 2, got {sv}")
        if len(set(self.windows)) != len(self.windows):
            raise ValueError(f"duplicate window lengths in s={self.s}")
        if self.multi_window and self.method != "matrix_profile":
            raise ValueError(
                "multi-window search (tuple s) requires "
                "method='matrix_profile'; got "
                f"method={self.method!r}")
        if not self.znorm and self.method not in RAW_CAPABLE:
            raise ValueError(
                f"znorm=False (raw Euclidean) is only supported by "
                f"{RAW_CAPABLE}; method={self.method!r} would "
                "silently z-normalize")
        if self.r is not None and not self.r > 0:
            raise ValueError(f"r must be positive, got {self.r}")
        object.__setattr__(self, "precision", str(self.precision))
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got "
                f"{self.precision!r}")
        if self.precision != "f32":
            if self.method not in ("matrix_profile", "ring"):
                raise ValueError(
                    "reduced precision (bf16/int8 bound pass + f32 "
                    "refinement) rides the exact-profile plan family "
                    "(matrix_profile | ring); method="
                    f"{self.method!r} has no quantized sweep")
            if self.multi_window:
                raise ValueError(
                    "reduced precision does not combine with the "
                    "pan-length ladder (tuple s) — the ladder has its "
                    "own LB-abandon prune schedule")

    @classmethod
    def from_fields(cls, d: dict) -> "SearchSpec":
        """Spec from a field dict, such as ``dataclasses.asdict`` of
        the JAX package's spec: its backend names map onto this
        package's (``xla``/``numpy`` -> ``torch``, ``pallas`` ->
        ``cuda``); unknown fields are refused."""
        d = dict(d)
        unknown = set(d) - {f.name for f in fields(cls)}
        if unknown:
            raise TypeError(f"unknown SearchSpec fields {sorted(unknown)}")
        be = d.get("backend")
        if be is not None:
            d["backend"] = FOREIGN_BACKENDS.get(be, be)
        return cls(**d)

    # ------------------------------------------------------------------
    @property
    def windows(self) -> Tuple[int, ...]:
        """Window lengths as a tuple (length 1 for a scalar spec)."""
        return self.s if isinstance(self.s, tuple) else (self.s,)

    @property
    def multi_window(self) -> bool:
        return isinstance(self.s, tuple)

    def replace(self, **changes) -> "SearchSpec":
        """Functional update (re-validated)."""
        return replace(self, **changes)

    def __str__(self) -> str:
        be = self.backend or "auto"
        return (f"SearchSpec(s={self.s}, k={self.k}, "
                f"method={self.method}, backend={be}, "
                f"znorm={self.znorm})")
