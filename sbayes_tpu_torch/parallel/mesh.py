"""Chain-axis split of a chain batch over devices.

Port of ``sbayes_tpu/parallel/mesh.py``'s chain mesh, in PyTorch's idiom. A
mesh is an ordered tuple of ``torch.device``s, and a device may repeat (two
shards on one card, eight on the CPU). A chain-batched ``ChainState``,
``OperatorStats`` or (B,) tensor is split into contiguous, equal blocks of
chains, block i on ``mesh[i]``; the model constants are copied once to each
distinct device. Every chain is independent of the others between MC3 swap
phases, so the only traffic between shards is ``permute_chains``: the
chains whose rung a swap phase changed. The runner's ``ShardedRuntime``
(``sampling/runner.py``) steps each block from a host thread of its own.

``auto_chain_mesh`` is the JAX package's policy: every visible device, and
only when the chains split evenly over more than one; the environment
variable ``SBAYES_TPU_SHARDING=off`` (or ``0``, ``none``) turns it off.
``visible_devices`` is the one place the device list comes from, so a test
can split a CPU batch by replacing it (the port's counterpart of the JAX
tests' ``--xla_force_host_platform_device_count``).

Not ported: the object-axis split (``data_mesh``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# Seed offset of shard j's per-chain generator: seed + j * SHARD_SEED_STRIDE.
SHARD_SEED_STRIDE = 0x9E3779B9


def canonical(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current CUDA device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device_type: str = "cuda") -> list:
    """The devices a model of ``device_type`` may split its chains over:
    every CUDA card for a CUDA model, none for a CPU model (a CPU run never
    splits unless asked)."""
    if device_type == "cuda" and torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return []


def chain_mesh(n_devices: Optional[int] = None, devices=None) -> tuple:
    """A mesh over ``devices`` (default: every visible CUDA device), or over
    their first ``n_devices``."""
    if devices is None:
        devices = visible_devices("cuda")
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a chain mesh needs at least one device")
    return tuple(canonical(d) for d in devices)


def auto_chain_mesh(n_chains: int, devices=None, device_type: str = "cuda"):
    """The production policy: a mesh over every device of
    ``visible_devices(device_type)`` (or ``devices``) when there is more
    than one device, more than one chain and the chains split evenly, else
    None (no split). Partial-device meshes are not used, as in the JAX
    package. A device of another type than ``device_type`` raises: a CPU
    model is never split onto a card, nor a CUDA model onto the CPU."""
    if os.environ.get("SBAYES_TPU_SHARDING", "").lower() in ("off", "0", "none"):
        return None
    if devices is None:
        devices = visible_devices(device_type)
    wrong = [str(d) for d in devices if torch.device(d).type != device_type]
    if wrong:
        raise ValueError(f"a {device_type} model cannot split its chains onto {wrong}")
    if len(devices) <= 1 or n_chains <= 1 or n_chains % len(devices):
        return None
    return chain_mesh(devices=devices)


def _n_chains(x) -> int:
    return (x if isinstance(x, torch.Tensor) else x[0]).shape[0]


def _block(x, idx, device):
    """The chains ``idx`` (a slice or an index tensor) of ``x`` on ``device``."""
    return x[idx].to(device) if isinstance(x, torch.Tensor) else x.select(idx).to(device)


def shard_chain_batch(x, mesh) -> list:
    """Contiguous, equal chain blocks of ``x`` (a ChainState, an
    OperatorStats, a (B, ...) tensor or None), block i on ``mesh[i]``."""
    S = len(mesh)
    if x is None:
        return [None] * S
    n = _n_chains(x)
    if n % S:
        raise ValueError(f"{n} chains do not split evenly over {S} devices")
    b = n // S
    return [_block(x, slice(i * b, (i + 1) * b), mesh[i]) for i in range(S)]


def replicate(model_or_consts, mesh) -> tuple:
    """The model constants for each entry of ``mesh``: one ``ModelConstants``
    per distinct device, shared by the entries of that device, and the
    constants themselves (no copy) where they already are."""
    consts = getattr(model_or_consts, "consts", model_or_consts)
    copies = {canonical(consts.device): consts}
    for dev in mesh:
        dev = canonical(dev)
        if dev not in copies:
            copies[dev] = consts.to(dev)
    return tuple(copies[canonical(d)] for d in mesh)


def gather(shards: list, device):
    """The chains of every shard as one batch on ``device``, in order."""
    first = shards[0]
    if first is None:
        return None
    moved = [s.to(device) for s in shards]
    return torch.cat(moved) if isinstance(first, torch.Tensor) else type(first).concat(moved)


def permute_chains(shards: list, perm) -> list:
    """An MC3 swap across the shards of a ChainState: rung r takes the state
    of chain ``perm[r]`` of the whole batch. A shard whose rungs all keep
    their chains is returned as it is; in the others, the chains from the
    shard itself are gathered in place and only the chains from other
    shards are moved there (``.to``). Equal, bit for bit, to
    ``ChainState.concat(shards).select(perm)`` split again. Temperatures
    and operator statistics stay with the rung: pass the states only."""
    perm = np.asarray(perm)
    b = shards[0].n_chains
    out = []
    for j, shard in enumerate(shards):
        rows = perm[j * b:(j + 1) * b]
        if (rows == np.arange(j * b, (j + 1) * b)).all():
            out.append(shard)
            continue
        dev = shard.clusters.device
        src = rows // b
        local = np.where(src == j, rows - j * b, np.arange(b))
        new = shard.select(torch.as_tensor(local, device=dev))
        for k in np.unique(src[src != j]):
            at = np.nonzero(src == k)[0]
            idx = torch.as_tensor(rows[at] - k * b, device=shards[k].clusters.device)
            moved = _block(shards[k], idx, dev)
            at = torch.as_tensor(at, device=dev)
            for dst, val in zip(new, moved):
                if dst is not None:
                    dst[at] = val
        out.append(new)
    return out


class ShardGenerators:
    """The per-chain generators of the shards of a split batch, made from one
    generator ``gen``: shard 0 draws from ``gen`` itself where it lies on
    ``gen``'s device, shard j from a generator on its device seeded with
    ``gen.initial_seed() + j * SHARD_SEED_STRIDE``. Each is made at its first
    use and kept, so the warm-up race and the sampling loop of one run go on
    drawing from the same streams."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self._made: dict = {}

    @classmethod
    def of(cls, gen) -> "ShardGenerators":
        """``gen`` if it is a ShardGenerators already, else one made from it."""
        return gen if isinstance(gen, cls) else cls(gen)

    def for_mesh(self, mesh) -> list:
        if len(mesh) == 1:
            return [self.gen]
        out = []
        for j, dev in enumerate(mesh):
            dev = canonical(dev)
            if j == 0 and canonical(self.gen.device) == dev:
                out.append(self.gen)
                continue
            g = self._made.get(j)
            if g is None or canonical(g.device) != dev:
                g = torch.Generator(device=dev)
                g.manual_seed((self.gen.initial_seed() + j * SHARD_SEED_STRIDE) % (1 << 63))
                self._made[j] = g
            out.append(g)
        return out
