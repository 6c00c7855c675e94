"""Categorical draws by inverse CDF: the one-hot row of each row of
unnormalized probabilities ``p`` (..., C), given one uniform ``u`` (...) a
row. Every source draw of the port comes here
(``model/math.py::sample_categorical_onehot``, which draws ``u``).

For CUDA tensors ``onehot`` launches ``csrc/draw.cu`` (one thread a row, one
launch, no sync); for CPU tensors it runs ``onehot_plain``, the plain
version. There is no other switch. The kernel draws no random numbers: ``u``
is the caller's, so the random stream is that of the plain version.

The kernel's draws are bit-equal to ``onehot_plain``'s on the card: it adds
the prefix sums in the association of PyTorch's own scan (``csrc/draw.cu``
states the rule) and rounds every add and the multiply on its own. It
replaces no TPU kernel (the JAX package draws with ``jax.random`` inside
XLA); it removes a library scan that runs one 512-thread block a row.
Bound on an H100: memory, 4C + 4 + C bytes a row.
"""
from __future__ import annotations

import torch

from sbayes_tpu_torch.ops import _cuda
from sbayes_tpu_torch.tracing import span

launches = _cuda.LaunchCounter("draw")

# The most components the kernel takes (csrc/draw.cu: kMaxComponents).
MAX_COMPONENTS = 32
BLOCKS_PER_SM = 8                  # resident 256-thread blocks of one SM: one wave


def onehot(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One-hot draws (bool, the shape of ``p``) from unnormalized categorical
    probabilities ``p`` (..., C) with the uniforms ``u`` (...) in [0, 1).
    All-zero rows yield the last category (every caller masks them), rows
    with a NaN category 0. CPU tensors take ``onehot_plain``; CUDA tensors
    launch the kernel."""
    with span("sbt.draw"):
        if not p.is_cuda:
            return onehot_plain(p, u)
        check_launch_args(p, u)
        out = torch.empty(p.shape, dtype=torch.bool, device=p.device)
        if out.numel():
            _launch(p.contiguous(), u.contiguous(), out)
        return out


def onehot_plain(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the port's draw before it)."""
    c = p.shape[-1]
    cdf = torch.cumsum(p, dim=-1)
    u = u * cdf[..., -1]
    idx = torch.clamp((u[..., None] >= cdf).sum(-1), max=c - 1)
    return idx[..., None] == torch.arange(c, device=p.device)


def check_launch_args(p, u):
    """Raise on what the kernel does not take: ``p`` (..., C) float32 with
    1 <= C <= ``MAX_COMPONENTS`` and ``u`` float32 of ``p``'s shape less its
    last axis, on one device."""
    if p.dim() < 1 or not 1 <= p.shape[-1] <= MAX_COMPONENTS:
        raise ValueError(f"probabilities {tuple(p.shape)}: the draw kernel takes 1 to "
                         f"{MAX_COMPONENTS} components in the last axis")
    if tuple(u.shape) != tuple(p.shape[:-1]):
        raise ValueError(f"uniforms {tuple(u.shape)} for probabilities {tuple(p.shape)}: "
                         f"expected {tuple(p.shape[:-1])}")
    for name, t in (("probabilities", p), ("uniforms", u)):
        if t.dtype != torch.float32 or t.device != p.device:
            raise TypeError(f"{name} must be a float32 tensor on {p.device}, "
                            f"not {t.dtype} on {t.device}")


def _launch(p, u, out):
    """Launch ``csrc/draw.cu`` on the current stream of the tensors' device."""
    C = p.shape[-1]
    stream = _cuda.stream_of(out)
    with torch.cuda.device(out.device):
        rc = _cuda.library().sbt_draw(p.data_ptr(), u.data_ptr(), out.data_ptr(),
                                      out.numel() // C, C,
                                      BLOCKS_PER_SM * _cuda.sm_count(out.device), stream)
    _cuda.check(rc, "draw")
    launches.add(C, (out.device.index, stream))
