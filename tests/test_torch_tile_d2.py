"""The port's masked Eq. (3) tile against the JAX package's.

``tile_d2_torch`` (the plain version the CPU path runs) is held against
the reference Pallas kernel in interpret mode and its XLA tile on the
same numpy inputs: identical +inf masks, finite values within 1e-3
(f32 sums of up to s products taken in another order — the bound the
reference's own backend-parity tests use).  ``tile_d2_cuda`` computes
the plain version on CPU tensors and refuses, before any launch,
anything its kernel does not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.windows import sliding_stats as sliding_stats_f64
from repro.kernels import common as ref_common
from repro.kernels.registry import tile_d2_pallas, tile_d2_xla
from repro_torch.kernels import build
from repro_torch.kernels import common
from repro_torch.kernels.tile_d2 import tile_d2_cuda, tile_d2_torch

torch.set_num_threads(2)

ATOL = 1e-3


def _case(bq, bc, s, n_valid, seed):
    """numpy window blocks with ids inside the self-match band, at -1,
    and at or past ``n_valid``."""
    rng = np.random.default_rng(seed)
    n_win = max(bq, bc) + 2 * s
    x = (np.sin(0.1 * np.arange(n_win + s - 1))
         + 0.3 * rng.normal(size=n_win + s - 1)).astype(np.float32)
    win = np.lib.stride_tricks.sliding_window_view(x, s)
    mu = win.mean(axis=1).astype(np.float32)
    sig = np.maximum(win.std(axis=1), 1e-10).astype(np.float32)
    c0 = int(rng.integers(0, n_win - bc + 1))
    cid = np.arange(c0, c0 + bc, dtype=np.int32)
    cid[rng.random(bc) < 0.05] = -1
    qid = rng.integers(-3, n_win + 3, size=bq).astype(np.int32)
    qid[qid < 0] = -1
    qid[:min(bq, 3)] = cid[:min(bq, 3)]          # self-match band
    if bq > 3:
        qid[3] = n_valid                          # first padding id

    def block(ids):
        safe = np.clip(ids, 0, n_win - 1)
        return [np.ascontiguousarray(a) for a in
                (win[safe], mu[safe], sig[safe], ids)]
    return block(qid) + block(cid)


CASES = [  # (Bq, Bc, s, n_valid)
    (16, 128, 32, 200),
    (37, 300, 40, 250),
    (5, 129, 33, 100),
    (130, 257, 64, 300),
    (3, 7, 2, 8),
]


def _torch_tile(arrs, s, n_valid):
    return tile_d2_torch(*map(torch.from_numpy, arrs), s=s,
                         n_valid=n_valid).numpy()


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("bq,bc,s,n_valid", CASES)
def test_tile_d2_matches_reference(ref, bq, bc, s, n_valid):
    arrs = _case(bq, bc, s, n_valid, seed=bq * 7 + bc + s)
    got = _torch_tile(arrs, s, n_valid)
    jarrs = [jnp.asarray(a) for a in arrs]
    if ref == "pallas":
        want = tile_d2_pallas(*jarrs, s=s, n_valid=n_valid,
                              interpret=True)
    else:
        want = tile_d2_xla(*jarrs, s=s, n_valid=n_valid)
    want = np.asarray(want)
    assert got.shape == want.shape == (bq, bc)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ATOL)


def test_tile_d2_cuda_takes_plain_version_on_cpu():
    arrs = [torch.from_numpy(a) for a in _case(37, 300, 40, 250, 1)]
    before = tile_d2_cuda.launches
    got = tile_d2_cuda(*arrs, s=40, n_valid=250)
    assert tile_d2_cuda.launches == before
    assert torch.equal(got, tile_d2_torch(*arrs, s=40, n_valid=250))


def _bad(kind):
    arrs = [torch.from_numpy(a) for a in _case(8, 40, 16, 40, 2)]
    if kind == "f64 windows":
        arrs[0] = arrs[0].double()
    elif kind == "i64 ids":
        arrs[7] = arrs[7].long()
    elif kind == "f16 stats":
        arrs[5] = arrs[5].half()
    elif kind == "non-contiguous":
        arrs[4] = arrs[4].T.contiguous().T
    elif kind == "stats shape":
        arrs[1] = arrs[1][:-1]
    elif kind == "window width":
        arrs[0] = arrs[0][:, :-1].contiguous()
    elif kind == "not a tensor":
        arrs[2] = arrs[2].numpy()
    elif kind == "meta device":
        arrs = [torch.empty_like(a, device="meta") for a in arrs]
    elif kind == "mixed devices":
        arrs[6] = torch.empty_like(arrs[6], device="meta")
    return arrs


@pytest.mark.parametrize("kind", [
    "f64 windows", "i64 ids", "f16 stats", "non-contiguous",
    "stats shape", "window width", "not a tensor", "meta device",
    "mixed devices"])
def test_tile_d2_cuda_rejects_before_launch(kind):
    arrs = _bad(kind)
    before = tile_d2_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        tile_d2_cuda(*arrs, s=16, n_valid=40)
    assert tile_d2_cuda.launches == before


@pytest.mark.parametrize("s", [2, 17, 64])
def test_sliding_stats_at_least_as_exact_as_reference(s):
    """The port accumulates its prefix sums in f64 (the reference in
    f32): against the f64 oracle its stats are f32-exact, and never
    further off than the reference's."""
    rng = np.random.default_rng(5)
    x = (np.cumsum(rng.normal(size=700)) * 0.1).astype(np.float32)
    mu64, sig64 = sliding_stats_f64(x, s)
    mu_r, sig_r = map(np.asarray, ref_common.sliding_stats_jnp(x, s))
    mu, sig = (t.numpy() for t in
               common.sliding_stats(torch.from_numpy(x), s))
    for got, ref, exact in ((mu, mu_r, mu64), (sig, sig_r, sig64)):
        err = np.abs(got - exact)
        assert np.all(err <= 1e-6 * np.maximum(np.abs(exact), 1.0))
        assert err.max() <= np.abs(ref - exact).max() + 1e-7


def test_common_matches_reference():
    rng = np.random.default_rng(5)
    qid = np.array([-1, 0, 5, 20, 99], np.int32)
    cid = np.arange(-2, 110, 3, dtype=np.int32)
    for s, nv in ((4, 100), (10, 21)):
        assert np.array_equal(
            common.exclusion_mask(torch.from_numpy(qid),
                                  torch.from_numpy(cid), s, nv).numpy(),
            np.asarray(ref_common.exclusion_mask(
                jnp.asarray(qid), jnp.asarray(cid), s, nv)))
    dots = rng.normal(size=(5, 7)).astype(np.float32) * 10
    st = [rng.uniform(0.5, 2, size=m).astype(np.float32)
          for m in (5, 5, 7, 7)]
    got = common.znorm_d2_formula(torch.from_numpy(dots), 16,
                                  *map(torch.from_numpy, st)).numpy()
    want = np.asarray(ref_common.znorm_d2_formula(
        jnp.asarray(dots), 16, *map(jnp.asarray, st)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert common.ceil_div(257, 256) == ref_common.ceil_div(257, 256) == 2


def test_build_command_and_content_hash(tmp_path, monkeypatch):
    cmd = build.nvcc_command("nvcc", "tile_d2", tmp_path / "x.so")
    flags = " ".join(cmd)
    for f in ("-gencode arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler -fPIC"):
        assert f in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert cmd[-1].endswith("csrc/tile_d2.cu")
    path = build.library_path("tile_d2")
    assert path.parent == build.BUILD_DIR
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "tile_d2.cu").write_bytes(
        (build.CSRC / "tile_d2.cu").read_bytes() + b"\n")
    monkeypatch.setattr(build, "CSRC", src)
    assert build.library_path("tile_d2") != path   # content changed
