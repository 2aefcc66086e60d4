"""The CUDA kernel on the card, held against its plain PyTorch version.

Every test here needs a CUDA device and ``nvcc``; without them each
skips.  This file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports the JAX package.)
"""
import numpy as np
import pytest
import torch

from repro_torch import DiscordEngine, SearchSpec
from repro_torch.core.engine import plan_pad_geom
from repro_torch.core.spec import length_bucket
from repro_torch.kernels.tile_d2 import tile_d2_cuda, tile_d2_torch

pytestmark = pytest.mark.gpu

ATOL = 1e-3   # f32 sums of up to s products, taken in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _blocks(bq, bc, s, n_valid, seed, device):
    """Window blocks whose ids cross the self-match band, include
    padding (-1) and run past ``n_valid``."""
    rng = np.random.default_rng(seed)
    n_win = max(bq, bc) + 2 * s
    x = rng.normal(size=n_win + s - 1).astype(np.float32)
    win = np.lib.stride_tricks.sliding_window_view(x, s)
    mu = win.mean(axis=1).astype(np.float32)
    sig = np.maximum(win.std(axis=1), 1e-10).astype(np.float32)
    qid = rng.integers(-3, n_win, size=bq).astype(np.int32)
    qid[qid < 0] = -1
    cid = np.arange(bc, dtype=np.int32)
    cid[rng.random(bc) < 0.05] = -1

    def block(ids):
        safe = np.clip(ids, 0, n_win - 1)
        return [torch.as_tensor(np.ascontiguousarray(a), device=device)
                for a in (win[safe], mu[safe], sig[safe], ids)]
    return (*block(qid), *block(cid))


@pytest.mark.parametrize("bq,bc,s,n_valid", [
    (1, 1, 2, 4), (37, 1000, 100, 1000), (64, 700, 40, 500),
    (129, 257, 17, 300), (256, 4099, 256, 3000), (5, 130, 33, 90)])
def test_kernel_matches_plain(cuda, bq, bc, s, n_valid):
    args = _blocks(bq, bc, s, n_valid, bq + bc + s, cuda)
    before = tile_d2_cuda.launches
    got = tile_d2_cuda(*args, s=s, n_valid=n_valid)
    want = tile_d2_torch(*args, s=s, n_valid=n_valid)
    torch.cuda.synchronize()
    assert tile_d2_cuda.launches == before + 1
    assert got.shape == (bq, bc) and got.is_contiguous()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    if fin.any():
        assert float((got[fin] - want[fin]).abs().max()) <= ATOL


@pytest.mark.parametrize("bad", ["dtype", "noncontig", "mixed"])
def test_kernel_rejects_before_launch(cuda, bad):
    args = list(_blocks(8, 40, 16, 40, 0, cuda))
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "noncontig":
        args[4] = args[4].T.contiguous().T
    else:
        args[5] = args[5].cpu()
    before = tile_d2_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        tile_d2_cuda(*args, s=16, n_valid=40)
    assert tile_d2_cuda.launches == before


@pytest.mark.parametrize("znorm", [True, False])
def test_engine_on_card_matches_plain_backend(cuda, znorm):
    rng = np.random.default_rng(3)
    n, s = 3000, 64
    x = np.sin(0.05 * np.arange(n)) + 0.1 * rng.normal(size=n)
    x[1700:1764] += np.sin(np.linspace(0, np.pi, 64))
    spec = SearchSpec(s=s, k=3, method="matrix_profile", znorm=znorm)
    before = tile_d2_cuda.launches
    got = DiscordEngine(spec).search(x)
    blocks = plan_pad_geom(s, length_bucket(n), spec.block) // spec.block
    assert tile_d2_cuda.launches == before + blocks
    want = DiscordEngine(spec.replace(backend="torch")).search(x)
    assert got.positions == want.positions
    assert np.allclose(got.nnds, want.nnds, rtol=1e-4, atol=0)
    assert got.calls == want.calls == got.tile_lanes
