"""The masked Eq. (3) distance tile: plain PyTorch version and kernel.

Both compute, for gathered window blocks ``q`` (Bq, s) and ``c``
(Bc, s) with per-window stats and *global* window ids,

    d2[i, j] = max(2s (1 - (q_i.c_j - s mu_i mu_j) / (s sig_i sig_j)), 0)

with +inf where ``|qid_i - cid_j| < s`` (self-match band) or where
either id lies outside ``[0, n_valid)`` (padding).

``tile_d2_torch`` is the plain version: the CPU path of the tests and
the yardstick the kernel is held against on the card.
``tile_d2_cuda`` launches ``csrc/tile_d2.cu`` on CUDA tensors; on
tensors that lie on the CPU it computes the plain version, and on any
other device it raises.  It never falls back from a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_library
from .common import exclusion_mask, znorm_d2_formula

__all__ = ["tile_d2_torch", "tile_d2_cuda"]


def tile_d2_torch(qwin, qmu, qsig, qid, cwin, cmu, csig, cid, *,
                  s: int, n_valid: int) -> torch.Tensor:
    """Plain version: f32 dot tile, Eq. (3), then the mask."""
    dots = torch.matmul(qwin, cwin.T)
    d2 = znorm_d2_formula(dots, s, qmu, qsig, cmu, csig)
    return d2.masked_fill(exclusion_mask(qid, cid, s, n_valid),
                          float("inf"))


def _check(qwin, qmu, qsig, qid, cwin, cmu, csig, cid, s, n_valid):
    """Raise on anything the kernel does not take."""
    named = dict(qwin=qwin, qmu=qmu, qsig=qsig, qid=qid,
                 cwin=cwin, cmu=cmu, csig=csig, cid=cid)
    for k, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{k} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        want = torch.int32 if k.endswith("id") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{k} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    if qwin.dim() != 2 or cwin.dim() != 2:
        raise ValueError("qwin and cwin must be 2-D (rows, s)")
    bq, bc = qwin.shape[0], cwin.shape[0]
    if qwin.shape[1] != s or cwin.shape[1] != s:
        raise ValueError(f"window width must equal s={s}, got "
                         f"{qwin.shape[1]} and {cwin.shape[1]}")
    for k in ("qmu", "qsig", "qid"):
        if tuple(named[k].shape) != (bq,):
            raise ValueError(f"{k} must have shape ({bq},), got "
                             f"{tuple(named[k].shape)}")
    for k in ("cmu", "csig", "cid"):
        if tuple(named[k].shape) != (bc,):
            raise ValueError(f"{k} must have shape ({bc},), got "
                             f"{tuple(named[k].shape)}")
    if not 1 <= s < 2 ** 31 or not 0 <= n_valid < 2 ** 31:
        raise ValueError(f"s={s} and n_valid={n_valid} must fit int32 "
                         "(s >= 1, n_valid >= 0)")
    if bq >= 65535 * 128 or bc >= 2 ** 31:
        raise ValueError(f"tile ({bq}, {bc}) exceeds the launch grid")
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"all inputs must lie on one device, got "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def tile_d2_cuda(qwin, qmu, qsig, qid, cwin, cmu, csig, cid, *,
                 s: int, n_valid: int) -> torch.Tensor:
    """The hand-written kernel on CUDA tensors (a fresh contiguous
    (Bq, Bc) f32 tile); the plain version on CPU tensors.  Each launch
    adds one to ``tile_d2_cuda.launches``."""
    s, n_valid = int(s), int(n_valid)
    dev = _check(qwin, qmu, qsig, qid, cwin, cmu, csig, cid, s, n_valid)
    if dev.type == "cpu":
        return tile_d2_torch(qwin, qmu, qsig, qid, cwin, cmu, csig, cid,
                             s=s, n_valid=n_valid)
    if dev.type != "cuda":
        raise ValueError(f"tile_d2_cuda runs on CUDA (or CPU) tensors, "
                         f"got device {dev}")
    bq, bc = qwin.shape[0], cwin.shape[0]
    out = torch.empty((bq, bc), dtype=torch.float32, device=dev)
    if bq == 0 or bc == 0:
        return out
    fn = load_library("tile_d2").tile_d2_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (qwin, qmu, qsig, qid, cwin,
                                          cmu, csig, cid, out)),
                 bq, bc, s, n_valid, stream)
    if err != 0:
        raise RuntimeError(f"tile_d2 kernel launch failed: CUDA error "
                           f"{err}")
    tile_d2_cuda.launches += 1
    return out


tile_d2_cuda.launches = 0
