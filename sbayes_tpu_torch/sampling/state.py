"""The MCMC state of a batch of chains.

Port of ``sbayes_tpu/sampling/state.py``: the same fields, each with an
explicit leading chain axis ``B`` (the JAX package vmaps one chain's state
instead). ``to_numpy`` / ``from_numpy`` use the JAX package's dict keys, so
a ``state_K*_*.pickle`` written by either package loads in the other.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

PRIOR_SIZE, PRIOR_GEO, PRIOR_WEIGHTS, PRIOR_SOURCE = 0, 1, 2, 3
"""Indices into ChainState.prior_parts."""

_COUNT_KEYS = ("cl_counts", "conf_counts", "geo_agg", "pat_counts")


class ChainState(NamedTuple):
    """State of B chains; ``log_prior == prior_parts.sum(-1)`` per chain."""

    clusters: torch.Tensor                 # bool (B, K, N)
    weights: torch.Tensor                  # f32 (B, F, C)
    source: torch.Tensor                   # bool (B, N, F, C), all-zero at NA
    log_lh: torch.Tensor                   # f32 (B,)
    log_prior: torch.Tensor                # f32 (B,)
    prior_parts: torch.Tensor              # f32 (B, 4) [size, geo, weights, source]
    cl_counts: Optional[torch.Tensor] = None    # f32 (B, K, F, S), exact integers
    conf_counts: Optional[torch.Tensor] = None  # f32 (B, C-1, Gmax, F, S)
    geo_agg: Optional[torch.Tensor] = None      # carried geo aggregates (not ported yet)
    pat_counts: Optional[torch.Tensor] = None   # f32 (B, P, F, C)

    @property
    def n_chains(self) -> int:
        return self.clusters.shape[0]

    def select(self, idx) -> "ChainState":
        """The chains ``idx`` (an index tensor or slice) of the batch."""
        return ChainState(*(None if x is None else x[idx] for x in self))

    def where(self, mask, other: "ChainState") -> "ChainState":
        """Per chain: this state where ``mask`` (B,) is True, else ``other``."""
        def pick(a, b):
            if a is None or a is b:
                return a
            return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)

        return ChainState(*(pick(a, b) for a, b in zip(self, other)))

    def to_numpy(self, chain: Optional[int] = None) -> dict:
        """The JAX package's checkpoint dict: of one chain when ``chain`` is
        given (scalars as floats), else of the whole batch."""
        st = self if chain is None else self.select(chain)

        def host(x):
            return x.detach().cpu().numpy()

        d = {
            "clusters": host(st.clusters),
            "weights": host(st.weights),
            "source": host(st.source),
            "log_lh": float(st.log_lh) if chain is not None else host(st.log_lh),
            "log_prior": float(st.log_prior) if chain is not None else host(st.log_prior),
            "prior_parts": host(st.prior_parts),
        }
        for k in _COUNT_KEYS:
            v = getattr(st, k)
            if v is not None:
                d[k] = host(v)
        return d

    @classmethod
    def from_numpy(cls, d: dict, device="cpu") -> "ChainState":
        """Rebuild from a checkpoint dict of one chain (clusters (K, N)) or
        of a batch (clusters (B, K, N)). Only the bool one-hot source form is
        read; counts absent from the dict stay None (refresh with
        ``Posterior.fill_state``)."""
        clusters = np.asarray(d["clusters"])
        single = clusters.ndim == 2
        source = np.asarray(d["source"])
        if source.dtype == np.int8:
            raise NotImplementedError("the packed int8 source form is not ported (scale path)")

        def t(x, dtype, add_batch=single):
            x = np.asarray(x)
            return torch.as_tensor(x[None] if add_batch else x, dtype=dtype, device=device)

        B = 1 if single else clusters.shape[0]

        def scalar(key):
            return t(np.broadcast_to(np.asarray(d.get(key, -np.inf), np.float32), (B,)).copy(),
                     torch.float32, add_batch=False)

        return cls(
            clusters=t(clusters, torch.bool),
            weights=t(d["weights"], torch.float32),
            source=t(source, torch.bool),
            log_lh=scalar("log_lh"),
            log_prior=scalar("log_prior"),
            prior_parts=t(d.get("prior_parts", np.full(4, -np.inf)), torch.float32),
            **{k: t(d[k], torch.float32) for k in _COUNT_KEYS if k in d},
        )

