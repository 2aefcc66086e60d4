"""Shared tile arithmetic: grid math, sliding stats, Eq. (3), masks.

The formulas and their evaluation order are those of the JAX package
(the same association of every product), so the plain tiles agree with
it up to the order of the f32 dot sums.  One deliberate difference: the
prefix sums behind the sliding stats accumulate in f64 and only the
per-window results are rounded to f32.  With f32 prefix sums, as the
JAX package keeps them, the sums of x² reach O(N) and their rounding
(an ulp of 2^16 is 0.008) swamps the window sums they are differenced
into: at N = 2^17, s = 256 that moved the nnds of a clean sine by about
2e-3 relative to an exact f64 computation.
"""
from __future__ import annotations

import torch

#: sigma floor of constant windows (z-normalization is undefined there)
SIGMA_FLOOR = 1e-10


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def series_csums(series: torch.Tensor):
    """Zero-prefixed cumulative sums of x and x², accumulated in f64 —
    the one pass every sliding-stats consumer derives from."""
    x = series.to(torch.float64)
    zero = x.new_zeros(1)
    return (torch.cat([zero, torch.cumsum(x, 0)]),
            torch.cat([zero, torch.cumsum(x * x, 0)]))


def stats_from_csums(csum, csum2, s: int, n: int):
    """f32 (mu, clamped sigma, raw ||window||²) of the ``n`` windows of
    length ``s`` from the f64 cumulative sums of :func:`series_csums`."""
    winsum = csum[s:s + n] - csum[:n]
    winsum2 = csum2[s:s + n] - csum2[:n]
    mu = winsum / s
    var = torch.clamp_min(winsum2 / s - mu * mu, 0.0)
    sig = torch.clamp_min(torch.sqrt(var), SIGMA_FLOOR)
    return (mu.to(torch.float32), sig.to(torch.float32),
            winsum2.to(torch.float32))


def sliding_stats(series: torch.Tensor, s: int):
    """f32 (mu, clamped sigma) of every window of length ``s``."""
    n = series.shape[0] - s + 1
    mu, sigma, _ = stats_from_csums(*series_csums(series), s, n)
    return mu, sigma


def znorm_d2_formula(dots, s, mu_q, sig_q, mu_c, sig_c):
    """Eq. (3) squared distance from raw dot products (broadcasting)."""
    corr = (dots - s * mu_q[:, None] * mu_c[None, :]) / (
        s * sig_q[:, None] * sig_c[None, :])
    return torch.clamp_min(2.0 * s * (1.0 - corr), 0.0)


def exclusion_mask(qid, cid, s: int, n_valid: int):
    """Self-match band + padding lanes (ids outside [0, n_valid))."""
    qi = qid[:, None].to(torch.int64)
    cj = cid[None, :].to(torch.int64)
    return ((torch.abs(qi - cj) < s) | (qi < 0) | (qi >= n_valid)
            | (cj < 0) | (cj >= n_valid))
