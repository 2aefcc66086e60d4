"""Distance-tile engine — the one tile plane every search shares.

The tile math lives behind the backend registry
(``repro_torch.kernels.registry``: ``torch`` | ``cuda``); this module
owns the data plane: window gathering, contiguous blocks, padding,
stats, min/argmin reductions and top-k extraction.

Data model: a ``TileBlock`` is a block of windows with per-window stats
and *global* window ids (ids outside [0, n_valid) are padding and come
back masked to +inf).  A ``TileEngine`` wraps one series, held as a
tensor on one device, and hands out blocks whose padding invariants
match what the backends expect.  Everything runs eagerly on that
device.

Device rule: an engine runs on ``cuda`` unless the caller names
another device; without a CUDA device that raises, and only a caller
who passes ``device="cpu"`` runs on the CPU.  Nothing falls back from
one to the other.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.common import (ceil_div, series_csums, sliding_stats,
                              stats_from_csums)
from ..kernels.registry import (available_backends, get_backend,
                                register_backend, resolve_backend)

__all__ = [
    "TileBlock", "TileMins", "TileEngine", "tile_d2", "tile_mins",
    "pair_d2", "topk_nonoverlapping", "resolve_device",
    "resolve_backend", "available_backends", "register_backend",
]


class TileBlock(NamedTuple):
    """A block of windows + stats + global ids (padding ids < 0)."""
    win: torch.Tensor    # (B, s) f32, contiguous
    mu: torch.Tensor     # (B,)   f32
    sig: torch.Tensor    # (B,)   f32
    ids: torch.Tensor    # (B,)   i32; <0 or >= n_valid -> masked


class TileMins(NamedTuple):
    row_min: torch.Tensor   # (Bq,) min d2 per query row
    row_arg: torch.Tensor   # (Bq,) candidate id realizing it
    col_min: torch.Tensor   # (Bc,) min d2 per candidate column
    col_arg: torch.Tensor   # (Bc,) query id realizing it


def tile_d2(q: TileBlock, c: TileBlock, *, s: int, n_valid: int,
            backend: Optional[str] = None) -> torch.Tensor:
    """Masked (Bq, Bc) squared-distance tile via the selected backend."""
    fn = get_backend(resolve_backend(backend))
    return fn(q.win, q.mu, q.sig, q.ids, c.win, c.mu, c.sig, c.ids,
              s=s, n_valid=n_valid)


def _min_first(d2: torch.Tensor, dim: int):
    """(min, argmin) along ``dim``; ties go to the first index, as
    ``jnp.argmin`` breaks them (``torch.min(dim)`` promises no order)."""
    arg = torch.argmin(d2, dim=dim)
    return torch.gather(d2, dim, arg.unsqueeze(dim)).squeeze(dim), arg


def tile_mins(d2: torch.Tensor, qids, cids) -> TileMins:
    """Row/col (min, argmin) of a d2 tile, in global-id space."""
    rmin, rarg = _min_first(d2, 1)
    cmin, carg = _min_first(d2, 0)
    return TileMins(row_min=rmin, row_arg=cids[rarg],
                    col_min=cmin, col_arg=qids[carg])


def pair_d2(wa, wb, mu_a, sig_a, mu_b, sig_b, s: int, valid=None):
    """Row-wise Eq. (3): d2 between paired windows (B, s) x (B, s)."""
    dots = torch.sum(wa * wb, dim=1)
    corr = (dots - s * mu_a * mu_b) / (s * sig_a * sig_b)
    d2 = torch.clamp_min(2.0 * s * (1.0 - corr), 0.0)
    if valid is not None:
        d2 = d2.masked_fill(~valid, float("inf"))
    return d2


def topk_nonoverlapping(profile: np.ndarray, k: int, s: int
                        ) -> Tuple[list, list]:
    """Host-side top-k maxima of a profile under the non-overlap rule."""
    p = np.asarray(profile, np.float64).copy()
    n = p.shape[0]
    pos, vals = [], []
    for _ in range(k):
        i = int(np.argmax(p))
        if not np.isfinite(p[i]):
            break
        pos.append(i)
        vals.append(float(p[i]))
        p[max(0, i - s + 1):min(n, i + s)] = -np.inf
    return pos, vals


def resolve_device(device=None) -> torch.device:
    """An engine's device: ``cuda`` unless the caller names another; a
    CUDA request without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the engines run on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------
class TileEngine:
    """Tile data plane for one series on one device.

    Owns the padded series / per-window stats and hands out
    ``TileBlock``s; every distance evaluation dispatches through the
    backend registry.  ``block`` is the query tile side; the series is
    padded so that every contiguous block stays in bounds
    (nb * block + s - 1 samples).
    """

    def __init__(self, series, s: int, *, block: int = 256,
                 backend: Optional[str] = None,
                 n_valid: Optional[int] = None, znorm: bool = True,
                 device=None):
        """``n_valid`` (optional) marks how many leading windows hold
        real data; the rest are plan-cache padding whose ids are
        remapped to -1 so every backend masks them to +inf.  Left as
        None, the series' own length decides.

        ``znorm=False`` switches the engine to raw Euclidean
        distances.  The backends only speak Eq. (3); raw tiles are
        recovered from them exactly by a rank-1 norm correction — see
        ``_raw_d2``.

        ``device`` is ``"cuda"`` by default (see the module's device
        rule); the series is moved there whatever device it came on.
        """
        self.s = int(s)
        self.block = int(block)
        self.backend = resolve_backend(backend)
        self.znorm = bool(znorm)
        self.device = resolve_device(device)
        x = torch.as_tensor(series).to(device=self.device,
                                       dtype=torch.float32)
        self.n = x.shape[0] - self.s + 1
        self.nb = ceil_div(self.n, self.block)
        n_pad = self.nb * self.block
        L_need = n_pad + self.s - 1
        self.series_pad = F.pad(x, (0, max(0, L_need - x.shape[0])))
        self._dyn = n_valid is not None
        self.n_valid = self.n if n_valid is None else int(n_valid)
        if self.znorm:
            mu, sig = sliding_stats(x, self.s)
            self.mu_pad = F.pad(mu, (0, n_pad - self.n))
            self.sig_pad = F.pad(sig, (0, n_pad - self.n), value=1.0)
        else:
            # Raw mode: neutral stats (mu=0, sig=1) turn the backends'
            # Eq. (3) tile into 2s - 2<q,c>; the true raw d2 is then
            # ||q||^2 + ||c||^2 - 2<q,c>, recovered in _raw_d2 from the
            # per-window squared norms.  The series is pre-scaled so
            # every window norm is <= sqrt(s): by Cauchy-Schwarz no dot
            # product can exceed s, keeping the backends' max(., 0)
            # clamp inactive (the 1e-3 headroom absorbs f32 rounding).
            _, _, self.nrm_pad = stats_from_csums(
                *series_csums(self.series_pad), self.s, n_pad)
            # the scale only sees live windows: pad windows overlap the
            # bucket's pad samples, whose fill must never matter
            live = torch.arange(n_pad, device=self.device) < self.n_valid
            mx = torch.max(torch.where(live, self.nrm_pad,
                                       self.nrm_pad.new_zeros(())))
            g = torch.sqrt(torch.tensor(float(self.s), dtype=torch.float32,
                                        device=self.device)) / (
                torch.sqrt(torch.clamp_min(mx, 1e-30)) * 1.001)
            self._g = torch.where(mx > 0, g, torch.ones_like(g))
            self.series_pad = self.series_pad * self._g
            self.mu_pad = torch.zeros(n_pad, dtype=torch.float32,
                                      device=self.device)
            self.sig_pad = torch.ones(n_pad, dtype=torch.float32,
                                      device=self.device)

    def _mask_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Remap plan-cache padding windows (id >= n_valid) to -1 so
        the backends' id mask retires them; identity when the engine
        was built without a dynamic n_valid."""
        if not self._dyn:
            return ids
        return torch.where(ids < self.n_valid, ids,
                           torch.full_like(ids, -1))

    def _raw_d2(self, t, qids, cids):
        """Invert the neutral-stats Eq. (3) tile to raw Euclidean d2.

        t = 2s - 2*g^2*<q,c> (masked lanes +inf) ->
        d2 = ||q||^2 + ||c||^2 - (2s - t)/g^2, clamped at 0.

        Norm gathers stay inside the live range: masked lanes carry
        id -1 (-> index 0, real data) and t=+inf already forces them
        to +inf, so clipping to n_valid-1 never changes a value.
        """
        top = max(self.n_valid - 1, 0)
        nq = self.nrm_pad[torch.clamp(qids, 0, top).long()]
        nc = self.nrm_pad[torch.clamp(cids, 0, top).long()]
        dots2 = (2.0 * self.s - t) / (self._g * self._g)
        return torch.clamp_min(nq[:, None] + nc[None, :] - dots2, 0.0)

    def _windows(self, start: int, count: int) -> torch.Tensor:
        """(count, s) contiguous copy of the windows starting at
        ``start`` .. ``start + count - 1``."""
        chunk = self.series_pad[start:start + count + self.s - 1]
        return chunk.unfold(0, self.s, 1).contiguous()

    # -- block constructors -------------------------------------------
    def query_block(self, ids) -> TileBlock:
        """Gathered windows at arbitrary ids (clipped for the gather;
        the *raw* ids are kept so out-of-range lanes mask to +inf)."""
        ids = self._mask_ids(torch.as_tensor(ids, dtype=torch.int32,
                                             device=self.device))
        safe = torch.clamp(ids, 0, self.n - 1).long()
        win = self.series_pad[safe[:, None] + torch.arange(
            self.s, device=self.device)[None, :]]
        return TileBlock(win, self.mu_pad[safe], self.sig_pad[safe], ids)

    def contiguous_block(self, c0: int) -> TileBlock:
        """One (block,) contiguous window block at offset c0."""
        c0 = int(c0)
        b = self.block
        return TileBlock(
            self._windows(c0, b),
            self.mu_pad[c0:c0 + b], self.sig_pad[c0:c0 + b],
            self._mask_ids(torch.arange(c0, c0 + b, dtype=torch.int32,
                                        device=self.device)))

    def all_windows(self) -> TileBlock:
        """Every (padded) window, materialized as one contiguous
        (n_pad, s) tensor — candidate side of the full-profile sweep."""
        n_pad = self.mu_pad.shape[0]
        return TileBlock(
            self._windows(0, n_pad), self.mu_pad, self.sig_pad,
            self._mask_ids(torch.arange(n_pad, dtype=torch.int32,
                                        device=self.device)))

    # -- tile ops ------------------------------------------------------
    def d2(self, q: TileBlock, c: TileBlock,
           backend: Optional[str] = None) -> torch.Tensor:
        # the backends get the static window count; bucket padding
        # already arrives as id -1 from _mask_ids
        t = tile_d2(q, c, s=self.s, n_valid=self.n,
                    backend=backend or self.backend)
        if self.znorm:
            return t
        return self._raw_d2(t, q.ids, c.ids)

    # -- full self-join profile ---------------------------------------
    def profile(self, *, backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact matrix profile (d2, neighbor) of the whole series: a
        blocked row sweep, one tile per query block against every
        window, reduced to its row (min, first argmin)."""
        backend = resolve_backend(backend or self.backend)
        cand = self.all_windows()
        mins, args = [], []
        for b0 in range(0, self.nb * self.block, self.block):
            d2 = self.d2(self.contiguous_block(b0), cand, backend)
            m, a = _min_first(d2, 1)
            mins.append(m)
            args.append(a)
        d2 = torch.cat(mins)[:self.n]
        arg = torch.cat(args)[:self.n].to(torch.int32)
        return d2, arg
