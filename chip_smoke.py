#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Prints the Python, torch and CUDA versions and the card, turns TF32
   off, and builds the CUDA kernels from ``src/repro_torch/csrc``.
2. Drives the exact-profile search, ``DiscordEngine(SearchSpec(s=256,
   k=3, method="matrix_profile")).search``, on a 131072-point series
   made from ``--seed`` (a sine plus noise with two implanted
   anomalies): cold, then warm, then once with ``znorm=False``.  Each
   search must launch ``tile_d2`` once per 256-row query block and the
   warm one must build no plan.  The discords' nnds are checked against
   an exact f64 computation on the card, and positions and nnds against
   the same search on the plain ``torch`` backend.
3. Holds the kernel against its plain PyTorch version at the main
   path's shape and at two ragged ones (identical +inf masks, finite
   values within 1e-3), and times the kernel, the plain version and the
   bare fp32 ``torch.matmul`` of the same operands.
4. Prints one JSON line of kernel numbers, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Any failed check ends the run with a non-zero exit code and no ok line,
as does a missing CUDA device or a missing ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data sheet: fp32 on the CUDA cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_POINTS = 131072
S = 256
K = 3
ATOL_TILE = 1e-3     # f32 sums of up to 256 products in another order
RTOL_NND = 1e-4


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_series(seed: int):
    """Sine plus noise with two implanted half-sine anomalies."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(N_POINTS)
    x = np.sin(2 * np.pi * t / 500.0) + 0.05 * rng.normal(size=N_POINTS)
    where = sorted(int(p) for p in rng.choice(
        np.arange(S, N_POINTS - 2 * S, 4 * S), size=2, replace=False))
    for p in where:
        x[p:p + S] += 0.8 * np.sin(np.linspace(0, np.pi, S))
    return x, where


def exact_nnds(x, positions, s: int, znorm: bool):
    """Exact nnd of each window in ``positions``, in f64 on the card."""
    import torch
    w = torch.as_tensor(x, dtype=torch.float64, device="cuda").unfold(0, s, 1)
    if znorm:
        mu = w.mean(dim=1, keepdim=True)
        sig = w.std(dim=1, unbiased=False, keepdim=True).clamp_min(1e-10)
        w = (w - mu) / sig
    ids = torch.arange(w.shape[0], device="cuda")
    out = []
    for p in positions:
        d2 = ((w - w[p]) ** 2).sum(dim=1)
        d2 = d2.masked_fill((ids - p).abs() < s, float("inf"))
        out.append(float(d2.min().sqrt()))
    return out


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_tiles(got, want, label: str) -> float:
    """Identical +inf masks and finite values within ATOL_TILE; returns
    the largest finite difference."""
    import torch
    fin = torch.isfinite(want)
    check(bool(torch.equal(torch.isfinite(got), fin)),
          f"{label}: +inf masks differ")
    check(bool(fin.any()) and bool((~fin).any()),
          f"{label}: the tile must hold both masked and finite lanes")
    err = float((got[fin] - want[fin]).abs().max())
    check(err <= ATOL_TILE, f"{label}: max |kernel - plain| = {err}")
    return err


def ragged_case(bq: int, bc: int, s: int, n_valid: int, seed: int):
    """Window blocks with ids that cross the self-match band, reach
    padding (-1) and run past ``n_valid``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n_win = max(bq, bc) + 50
    x = rng.normal(size=n_win + s - 1).astype(np.float32)
    win = np.lib.stride_tricks.sliding_window_view(x, s)
    mu = win.mean(axis=1)
    sig = np.maximum(win.std(axis=1), 1e-10)
    qid = rng.integers(-5, n_win, size=bq).astype(np.int32)
    qid[qid < 0] = -1
    cid = np.arange(bc, dtype=np.int32)
    cid[rng.random(bc) < 0.05] = -1

    def block(ids):
        safe = np.clip(ids, 0, n_win - 1)
        return [torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                for a in (win[safe], mu[safe].astype(np.float32),
                          sig[safe].astype(np.float32), ids)]
    return block(qid), block(cid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on a GPU")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; "
                         "run this script from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch import DiscordEngine, SearchSpec, TileEngine
    from repro_torch.core.engine import plan_pad_geom
    from repro_torch.core.spec import length_bucket
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.tile_d2 import tile_d2_cuda, tile_d2_torch

    # -- 1. environment and build -------------------------------------
    t_all = time.perf_counter()
    print(f"python {platform.python_version()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    load_library("tile_d2")
    print(f"[1 build] csrc/tile_d2.cu built in "
          f"{time.perf_counter() - t0:.2f}s")

    # -- 2. the main path ---------------------------------------------
    t0 = time.perf_counter()
    x, implanted = make_series(args.seed)
    spec = SearchSpec(s=S, k=K, method="matrix_profile")
    Lb = length_bucket(N_POINTS)
    n_pad = plan_pad_geom(S, Lb, spec.block)
    per_search = n_pad // spec.block
    print(f"series: {N_POINTS} points, s={S}, k={K}, anomalies at "
          f"{implanted}; {per_search} tile_d2 launches per search")

    def drive(eng, label):
        before = tile_d2_cuda.launches
        t = time.perf_counter()
        r = eng.search(x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = tile_d2_cuda.launches - before
        print(f"  {label}: {r}  {dt:.3f}s, {got} launches")
        check(got == per_search,
              f"{label}: {got} tile_d2 launches, expected {per_search}")
        check(len(r.positions) == K and all(np.isfinite(r.nnds)),
              f"{label}: expected {K} finite discords, got {r}")
        check(r.calls == r.tile_lanes == n_pad ** 2,
              f"{label}: calls {r.calls} != n_pad^2 {n_pad ** 2}")
        return r

    eng = DiscordEngine(spec)
    raw = DiscordEngine(spec.replace(znorm=False))
    tile_d2_cuda.launches = 0
    res = {True: drive(eng, "search cold")}
    plans = eng.stats.plans
    res[True] = drive(eng, "search warm")
    check(eng.stats.plans == plans == 1 and eng.stats.traces == 1,
          f"warm search built a plan: {eng.stats}")
    res[False] = drive(raw, "search znorm=False")
    launches = tile_d2_cuda.launches
    print(f"main-path launches: tile_d2={launches}")

    for znorm, r in res.items():
        ref = exact_nnds(x, r.positions, S, znorm)
        rel = [abs(a - b) / b for a, b in zip(r.nnds, ref)]
        print(f"  znorm={znorm}: f64 nnds {ref}, rel err {rel}")
        check(max(rel) <= RTOL_NND, f"znorm={znorm}: nnd rel err {rel}")
        plain = DiscordEngine(spec.replace(znorm=znorm,
                                           backend="torch")).search(x)
        check(plain.positions == r.positions,
              f"znorm={znorm}: positions {r.positions} vs plain "
              f"{plain.positions}")
        check(np.allclose(r.nnds, plain.nnds, rtol=RTOL_NND, atol=0),
              f"znorm={znorm}: nnds {r.nnds} vs plain {plain.nnds}")
    print(f"[2 main path] ok in {time.perf_counter() - t0:.2f}s")

    # -- 3. kernel against its plain version --------------------------
    t0 = time.perf_counter()
    xp = np.zeros(Lb, np.float32)
    xp[:N_POINTS] = x
    te = TileEngine(torch.as_tensor(xp, device="cuda"), S,
                    block=spec.block, n_valid=N_POINTS - S + 1)
    q, c = te.contiguous_block(0), te.all_windows()
    main_args = (*q, *c)
    main_kw = dict(s=S, n_valid=te.n)
    cases = [("main", main_args, main_kw)]
    for bq, bc, s, nv, seed in ((37, 1000, 100, 1000, 1),
                                (64, 700, 40, 500, 2)):
        (qa, ca) = ragged_case(bq, bc, s, nv, seed)
        cases.append((f"[{bq}, {bc}, {s}] n_valid={nv}", (*qa, *ca),
                      dict(s=s, n_valid=nv)))
    err = 0.0
    for label, a, kw in cases:
        got = tile_d2_cuda(*a, **kw)
        want = tile_d2_torch(*a, **kw)
        torch.cuda.synchronize()
        e = compare_tiles(got, want, label)
        print(f"  {label}: max |kernel - plain| = {e:.3g}")
        err = max(err, e)

    bq, bc = q.win.shape[0], c.win.shape[0]
    ms = time_ms(lambda: tile_d2_cuda(*main_args, **main_kw), 20)
    plain_ms = time_ms(lambda: tile_d2_torch(*main_args, **main_kw), 10)
    matmul_ms = time_ms(lambda: torch.matmul(q.win, c.win.T), 20)
    flops = 2.0 * bq * bc * S
    nbytes = 4.0 * (bq + bc) * S + 12.0 * (bq + bc) + 4.0 * bq * bc
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    print(f"[3 kernel vs plain] ok in {time.perf_counter() - t0:.2f}s")

    print(json.dumps({"kernels": [{
        "name": "tile_d2", "route": "cuda",
        "source": "src/repro_torch/csrc/tile_d2.cu",
        "replaces": "src/repro/kernels/registry.py:263",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_ops, t_mem),
        "bound_by": "operations" if t_ops >= t_mem else "bytes",
        "library_ms": None, "matmul_ms": matmul_ms,
        "shape": [bq, bc, S]}]}))
    print(f"total {time.perf_counter() - t_all:.1f}s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
