"""The port's exact-profile session against the JAX package's.

Both engines get one spec (the port's via ``SearchSpec.from_fields``)
and the same numpy series.  The reference runs its Pallas tile in
interpret mode (``backend="pallas"``, the path that reaches
``tile_d2_pallas``) and its XLA tile.  Positions must be equal, nnds
within rtol 1e-4, profiles within atol 3e-3 on d², and ``calls``,
``tile_lanes`` and ``n`` equal integers — the bounds the reference's own
cross-backend tests use.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiscordEngine as RefEngine
from repro.core import SearchSpec as RefSpec
from repro.core.spec import canonical_method as ref_canonical_method
from repro.core.spec import length_bucket as ref_length_bucket
from repro.core.tiles import TileEngine as RefTileEngine
from repro_torch import DiscordEngine, SearchSpec, TileEngine
from repro_torch.core.engine import plan_pad_geom
from repro_torch.core.spec import (METHOD_ALIASES, canonical_method,
                                   length_bucket)
from repro_torch.core.tiles import (pair_d2, tile_mins,
                                    topk_nonoverlapping)
from repro_torch.kernels.registry import ENV_VAR, resolve_backend

torch.set_num_threads(2)


def _series(seed, n):
    rng = np.random.default_rng(seed)
    x = np.sin(0.07 * np.arange(n)) + 0.1 * rng.normal(size=n)
    p = int(rng.integers(60, n - 100))
    x[p:p + 30] += rng.uniform(0.7, 1.3) * np.sin(np.linspace(0, np.pi, 30))
    return x


# (L, s, block): bucket 512 with a ragged tail; exactly one bucket;
# one point past it; n_true exactly one query block; a smaller block;
# a 2048 bucket
LENGTHS = [(300, 24, 256), (512, 32, 256), (513, 32, 256),
           (287, 32, 256), (700, 40, 128), (1100, 48, 256)]

_REF_ENGINES = {}


def _ref_engine(spec):
    """One reference session per spec, so its compiled plans are
    reused across the parametrized cases."""
    if spec not in _REF_ENGINES:
        _REF_ENGINES[spec] = RefEngine(spec)
    return _REF_ENGINES[spec]


@pytest.mark.parametrize("ref", ["pallas", "xla"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("znorm", [True, False])
@pytest.mark.parametrize("L,s,block", LENGTHS)
def test_search_matches_reference(L, s, block, znorm, k, ref):
    x = _series(L + s, L)
    rspec = RefSpec(s=s, k=k, method="matrix_profile", znorm=znorm,
                    block=block, backend=ref)
    want = _ref_engine(rspec).search(x)
    eng = DiscordEngine(SearchSpec.from_fields(dataclasses.asdict(rspec)),
                        device="cpu")
    got = eng.search(x)
    assert eng.backend == ("cuda" if ref == "pallas" else "torch")
    assert got.positions == want.positions
    np.testing.assert_allclose(got.nnds, want.nnds, rtol=1e-4, atol=0)
    for f in ("calls", "tile_lanes", "n", "s"):
        a, b = getattr(got, f), getattr(want, f)
        assert type(a) is int and a == b, f
    n_pad = plan_pad_geom(s, length_bucket(L), block)
    assert got.calls == got.tile_lanes == n_pad ** 2
    assert got.extra["bucket"] == want.extra["bucket"]


def _exact_d2(x, s, znorm):
    w = np.lib.stride_tricks.sliding_window_view(np.asarray(x, np.float64), s)
    if znorm:
        w = (w - w.mean(1, keepdims=True)) / w.std(1, keepdims=True)
    d2 = ((w[:, None, :] - w[None, :, :]) ** 2).sum(-1)
    i = np.arange(w.shape[0])
    d2[np.abs(i[:, None] - i[None, :]) < s] = np.inf
    return d2


@pytest.mark.parametrize("znorm", [True, False])
def test_profile_matches_reference(znorm):
    s, n_pts = 16, 420
    x = np.random.default_rng(0).normal(size=n_pts)
    # the series is tie-free: every window's best neighbour beats its
    # second best by far more than the f32 error of either engine
    d2 = np.sort(_exact_d2(x, s, znorm), axis=1)
    assert np.min(d2[:, 1] - d2[:, 0]) > 1e-3
    n = n_pts - s + 1
    port = TileEngine(torch.from_numpy(x), s, block=128, znorm=znorm,
                      device="cpu")
    got_d2, got_ngh = (t.numpy() for t in port.profile(backend="torch"))
    refs = {
        "xla": RefTileEngine(x, s, block=128, znorm=znorm,
                             backend="xla").profile(),
        # with a dynamic n_valid the reference profile takes the generic
        # sweep through tile_d2_pallas, as its engine's plans do
        "pallas": RefTileEngine(x, s, block=128, znorm=znorm,
                                backend="pallas",
                                n_valid=jnp.int32(n)).profile(),
    }
    assert got_d2.shape == got_ngh.shape == (n,)
    assert got_ngh.dtype == np.int32
    for name, (want_d2, want_ngh) in refs.items():
        np.testing.assert_allclose(got_d2, np.asarray(want_d2), rtol=0,
                                   atol=3e-3, err_msg=name)
        assert np.array_equal(got_ngh, np.asarray(want_ngh)), name
    assert np.all(np.abs(got_ngh - np.arange(n)) >= s)


def test_profile_dynamic_n_valid_masks_padding():
    """Bucket padding (ids >= n_valid) never wins a row minimum, and
    padded rows come back +inf."""
    s, n_valid = 20, 300
    x = np.zeros(512)
    x[:n_valid + s - 1] = _series(4, n_valid + s - 1)
    eng = TileEngine(torch.from_numpy(x), s, n_valid=n_valid, znorm=True,
                     device="cpu")
    d2, ngh = eng.profile(backend="torch")
    assert torch.all(ngh[:n_valid] < n_valid)
    assert torch.all(torch.isinf(d2[n_valid:]))
    assert torch.all(torch.isfinite(d2[:n_valid]))


def test_argmin_takes_first_index_on_ties():
    d2 = torch.tensor([[3.0, 1.0, 1.0, 2.0], [float("inf")] * 4,
                       [3.0, 1.0, 0.5, 2.0]])
    m = tile_mins(d2, torch.tensor([10, 11, 12]),
                  torch.tensor([20, 21, 22, 23]))
    assert m.row_arg.tolist() == [21, 20, 22]
    assert m.row_min.tolist() == [1.0, float("inf"), 0.5]
    assert m.col_arg.tolist() == [10, 10, 12, 10]
    assert m.col_min.tolist() == [3.0, 1.0, 0.5, 2.0]
    jd2 = jnp.asarray(d2.numpy())
    assert (m.row_arg - 20).tolist() == jnp.argmin(jd2, axis=1).tolist()
    assert (m.col_arg - 10).tolist() == jnp.argmin(jd2, axis=0).tolist()


@pytest.mark.parametrize("znorm", [True, False])
def test_query_block_tiles_match_reference(znorm):
    """Gathered query blocks (ids past the series, at -1, and past a
    dynamic n_valid) against a contiguous block, through ``d2``."""
    s, n_valid = 24, 400
    x = np.zeros(512)
    x[:n_valid + s - 1] = _series(9, n_valid + s - 1)
    ids = np.array([0, 5, 130, 399, 400, 480, -1, 600], np.int32)
    port = TileEngine(torch.from_numpy(x), s, block=128, znorm=znorm,
                      n_valid=n_valid, device="cpu")
    ref = RefTileEngine(x, s, block=128, znorm=znorm, backend="xla",
                        n_valid=jnp.int32(n_valid))
    for c0 in (0, 256, 384):
        got = port.d2(port.query_block(ids), port.contiguous_block(c0),
                      "torch").numpy()
        want = np.asarray(ref.d2(ref.query_block(jnp.asarray(ids)),
                                 ref.contiguous_block(c0)))
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin), c0
        assert fin.any() and (~fin).any()
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-3)


def test_pair_d2_matches_reference():
    from repro.core.tiles import pair_d2 as ref_pair_d2
    rng = np.random.default_rng(4)
    wa, wb = (rng.normal(size=(9, 16)).astype(np.float32) for _ in "ab")
    st = [rng.uniform(0.5, 2, size=9).astype(np.float32) for _ in "abcd"]
    valid = rng.random(9) < 0.7
    got = pair_d2(*map(torch.from_numpy, (wa, wb, *st)), 16,
                  valid=torch.from_numpy(valid)).numpy()
    want = np.asarray(ref_pair_d2(*map(jnp.asarray, (wa, wb, *st)), 16,
                                  valid=jnp.asarray(valid)))
    assert np.array_equal(np.isinf(got), ~valid)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5,
                               atol=1e-4)


def test_topk_nonoverlapping_matches_reference():
    from repro.core.tiles import topk_nonoverlapping as ref_topk
    p = np.random.default_rng(2).random(300)
    p[[10, 150]] = -np.inf
    for k, s in ((1, 5), (4, 20), (50, 30)):
        assert topk_nonoverlapping(p, k, s) == ref_topk(p, k, s)


def test_plan_count_contract_matches_reference():
    """A second search in the same bucket adds zero plans; a new bucket
    adds exactly one — counted as the reference counts jit traces."""
    spec = RefSpec(s=32, k=1, method="matrix_profile", backend="xla")
    ref = RefEngine(spec)
    eng = DiscordEngine(SearchSpec.from_fields(dataclasses.asdict(spec)),
                        device="cpu")
    for n in (500, 450, 600, 520):
        ref.search(_series(n, n))
        eng.search(_series(n, n))
        assert eng.stats.plans == ref.stats.plans
        assert eng.stats.traces == ref.stats.traces
        assert eng.stats.tile_lanes == ref.stats.tile_lanes
    assert eng.stats.as_dict() == ref.stats.as_dict()
    assert (eng.stats.plans, eng.stats.searches) == (2, 4)


def test_plan_cache_counts_hits_and_misses():
    spec = SearchSpec(s=24, k=1, method="matrix_profile", backend="torch")
    eng = DiscordEngine(spec, device="cpu")
    for n in (400, 410, 600, 450):
        eng.search(_series(n, n))
    cache = eng.plan_cache
    assert (len(cache), cache.misses, cache.hits) == (2, 2, 2)
    assert cache.misses == eng.stats.plans == eng.stats.traces


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    spec = SearchSpec(s=16, method="matrix_profile")
    for kw in ({}, {"device": "cuda"}, {"device": None}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DiscordEngine(spec, **kw)
    eng = DiscordEngine(spec, device="cpu")
    assert eng.device == torch.device("cpu") and eng.backend == "cuda"


@pytest.mark.parametrize("kind", ["numpy", "list", "cpu tensor"])
def test_tile_engine_defaults_to_cuda_and_raises_without_it(kind):
    """A series the caller did not place on the card still runs there
    by default: without CUDA the engine raises instead of using the
    CPU, and only ``device="cpu"`` runs there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    x = _series(5, 200)
    series = {"numpy": x, "list": x.tolist(),
              "cpu tensor": torch.from_numpy(x)}[kind]
    for kw in ({}, {"device": "cuda"}, {"device": None}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TileEngine(series, 16, **kw)
    eng = TileEngine(series, 16, device="cpu")
    assert eng.device == torch.device("cpu") and eng.backend == "cuda"
    assert eng.series_pad.device == torch.device("cpu")


def test_backend_resolution_never_looks_at_hardware(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    assert resolve_backend() == "cuda"
    assert resolve_backend("torch") == "torch"
    monkeypatch.setenv(ENV_VAR, "torch")
    assert resolve_backend() == "torch"
    assert resolve_backend("cuda") == "cuda"
    eng = DiscordEngine(SearchSpec(s=16, method="matrix_profile"),
                        device="cpu")
    assert eng.backend == "torch"
    for bad in ("pallas", "xla", "triton"):
        with pytest.raises(ValueError):
            resolve_backend(bad)


@pytest.mark.parametrize("fields,mapped", [
    ({"backend": "xla"}, "torch"), ({"backend": "numpy"}, "torch"),
    ({"backend": "pallas"}, "cuda"), ({"backend": None}, None)])
def test_spec_from_fields(fields, mapped):
    rspec = RefSpec(s=(16, 24) if mapped is None else 16, k=2,
                    method="mp", znorm=False, block=64, **fields)
    spec = SearchSpec.from_fields(dataclasses.asdict(rspec))
    assert spec.backend == mapped
    for f in ("s", "k", "method", "znorm", "block", "precision", "ndev"):
        assert getattr(spec, f) == getattr(rspec, f)
    with pytest.raises(TypeError):
        SearchSpec.from_fields({"s": 16, "mesh": None})


@pytest.mark.parametrize("kw", [
    dict(s=1), dict(s=(16, 16), method="matrix_profile"),
    dict(s=(16, 24), method="hst"), dict(s=16, k=0),
    dict(s=16, method="nope"), dict(s=16, method="hotsax", znorm=False),
    dict(s=16, precision="f16"), dict(s=16, method="hst", precision="bf16"),
    dict(s=16, method="hst", ndev=2), dict(s=16, ndev=0),
    dict(s=16, r=-1.0), dict(s=16, block=0)])
def test_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        RefSpec(**kw)
    with pytest.raises(ValueError):
        SearchSpec(**kw)


def test_spec_helpers_match_reference():
    for m in list(METHOD_ALIASES) + ["hst", "brute", "matrix_profile"]:
        assert canonical_method(m) == ref_canonical_method(m)
    for n in (1, 255, 256, 257, 4096, 4097):
        assert length_bucket(n) == ref_length_bucket(n)
    spec = SearchSpec(s=[32], k=2, method="scamp")
    assert spec.s == 32 and spec.method == "matrix_profile"
    assert hash(spec) == hash(spec.replace(k=2))


@pytest.mark.parametrize("kw,item", [
    (dict(method="hst_jax"), "Blocked HST"),
    (dict(method="ring"), "Multi-device"),
    (dict(method="hotsax"), "Serial counted plane"),
    (dict(method="matrix_profile", precision="bf16"), "Quantized plane"),
    (dict(method="matrix_profile", s=(16, 24)), "Pan ladder")])
def test_unported_searches_name_their_roadmap_item(kw, item):
    spec = SearchSpec(**{"s": 16, **kw})
    eng = DiscordEngine(spec, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        eng.search(_series(0, 300))


def test_unported_placement_and_bad_calls_raise():
    spec = SearchSpec(s=16, method="matrix_profile")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        DiscordEngine(spec.replace(ndev=1), device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        DiscordEngine(spec, device="cpu", mesh=object())
    eng = DiscordEngine(spec, device="cpu")
    with pytest.raises(TypeError):
        eng.search(_series(0, 300), batch=4)
    with pytest.raises(ValueError, match="too short"):
        eng.search(np.zeros(16))
    with pytest.raises(TypeError):
        DiscordEngine(spec, device="cpu", k=3)
