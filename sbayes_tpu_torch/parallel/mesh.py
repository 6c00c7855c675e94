"""Chain-axis split of a chain batch over devices.

Port of ``sbayes_tpu/parallel/mesh.py``'s chain mesh, in PyTorch's idiom. A
mesh is an ordered tuple of ``torch.device``s, and a device may repeat (two
shards on one card, eight on the CPU). A chain-batched ``ChainState``,
``OperatorStats`` or (B,) tensor is split into contiguous, equal blocks of
chains, block i on ``mesh[i]``; the model constants are copied once to each
distinct device. Every chain is independent of the others between MC3 swap
phases, so the only traffic between shards is ``permute_chains``: the
chains whose rung a swap phase changed. The runner's ``ShardedRuntime``
(``sampling/runner.py``) steps block 0 in the calling process and each
other block in a process of its own (``processes.py``).

``auto_chain_mesh`` is the JAX package's policy: every visible device, and
only when the chains split evenly over more than one; the environment
variable ``SBAYES_TPU_SHARDING=off`` (or ``0``, ``none``) turns it off.
``visible_devices`` is the one place the device list comes from, so a test
can split a CPU batch by replacing it (the port's counterpart of the JAX
tests' ``--xla_force_host_platform_device_count``).

The object-axis split (``data_mesh``, a chains x objects grid) is the
counterpart of the JAX package's ``DATA_AXIS``, which GSPMD partitions by
itself; here it is written out. Row i of the grid holds chain shard i: its
first device (the head) keeps the chain state of O(K N) and less per chain
(cluster masks, weights, carried counts, geo aggregates) and the model
constants of O(N) and O(N^2) (groups, patterns, the cost matrix), and
computes every operator; each device of the row holds one contiguous block
of the objects (``object_blocks``): the constants' O(N F) arrays of the
block (``block_constants``) and the chains' source of the block
(``SplitSource``). No O(N F) array is whole on one device. Reductions over
objects (counts, pattern counts, the source prior) are per-block partial
sums added on the head in block order; rows that an operator reads or
writes come from or go to the block that holds them; the membership
marginal runs per block (``ObjectSplit.run``: each block's work on a CUDA
stream of its own, dispatched from the head's host thread). Every tensor
sent between the head and a block other than the first is copied, even
where both lie on one card, and counted in bytes (``ObjectSplit.traffic``).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import numpy as np
import torch

from sbayes_tpu_torch.model.math import batch_take, pack_source, scatter_rows, source_onehot
from sbayes_tpu_torch.tracing import span

CHAIN_AXIS = "chains"
DATA_AXIS = "objects"

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


def chain_block(x, i: int, n_blocks: int):
    """Block ``i`` of ``n_blocks`` contiguous, equal chain blocks of ``x`` (a
    ChainState, an OperatorStats or a (B, ...) tensor), where ``x`` lies."""
    n = _n_chains(x)
    if n % n_blocks:
        raise ValueError(f"{n} chains do not split evenly over {n_blocks} devices")
    b = n // n_blocks
    idx = slice(i * b, (i + 1) * b)
    return x[idx] if isinstance(x, torch.Tensor) else x.select(idx)


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


def permute_plan(perm, b: int) -> list:
    """The moves of an MC3 swap across shards of ``b`` chains, where rung r
    takes the state of chain ``perm[r]`` of the whole batch: for each shard,
    None where its rungs all keep their chains, else (local, moves):
    ``local`` (b,) the indices into the shard of the chains it keeps (its
    own index at a row that another shard fills) and ``moves`` a list of
    (k, at, idx): chains ``idx`` of shard k go to the rows ``at``."""
    perm = np.asarray(perm)
    plans = []
    for j in range(len(perm) // b):
        rows = perm[j * b:(j + 1) * b]
        if (rows == np.arange(j * b, (j + 1) * b)).all():
            plans.append(None)
            continue
        src = rows // b
        local = np.where(src == j, rows - j * b, np.arange(b))
        moves = [(int(k), np.nonzero(src == k)[0], rows[src == k] - k * b)
                 for k in np.unique(src[src != j])]
        plans.append((local, moves))
    return plans


def give_chains(shard, idx):
    """The chains ``idx`` (an index array) of a shard, on its device."""
    with span("sbt.sync/mc3.permute"):
        idx = torch.as_tensor(idx, device=shard.clusters.device)
    return shard.select(idx)


def place_chains(shard, local, moved: list):
    """``shard`` after a swap (``permute_plan``): its chains ``local``, then
    each moved block ``(at, chains)`` (a ChainState of ``len(at)`` chains on
    any device) written at the rows ``at``."""
    dev = shard.clusters.device
    with span("sbt.sync/mc3.permute"):
        local = torch.as_tensor(local, device=dev)
    new = shard.select(local)
    for at, block in moved:
        with span("sbt.sync/mc3.permute"):
            at = torch.as_tensor(at, device=dev)
        for dst, val in zip(new, block):
            if dst is not None:
                dst[at] = val.to(dev)
    return new


def permute_chains(shards: list, perm, give=give_chains, take=place_chains) -> list:
    """An MC3 swap across the shards of a ChainState: rung r takes the state
    of chain ``perm[r]`` of the whole batch. A shard whose rungs all keep
    their chains is returned as it is; in the others, the chains from the
    shard itself are gathered in place and only the chains from other
    shards are moved there. Equal, bit for bit, to
    ``ChainState.concat(shards).select(perm)`` split again. Temperatures
    and operator statistics stay with the rung: pass the states only.
    ``give(shard, idx)`` reads the moved chains of a shard and ``take(shard,
    local, moved)`` writes them (``place_chains``); every read comes before
    the first write. The process split (``parallel/processes.py``) passes
    its own, which move the chains through host memory."""
    plans = permute_plan(perm, shards[0].n_chains)
    moved = [None if plan is None else [(at, give(shards[k], idx)) for k, at, idx in plan[1]]
             for plan in plans]
    return [shard if plan is None else take(shard, plan[0], blocks)
            for shard, plan, blocks in zip(shards, plans, moved)]


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
        return [self.shard(j, dev) for j, dev in enumerate(mesh)]

    def shard(self, j: int, device) -> torch.Generator:
        """The generator of shard ``j`` of a mesh of more than one device,
        on ``device``."""
        dev = canonical(device)
        if j == 0 and canonical(self.gen.device) == dev:
            return self.gen
        g = self._made.get(j)
        if g is None or canonical(g.device) != dev:
            g = shard_generator(self.gen.initial_seed(), j, dev)
            self._made[j] = g
        return g


def shard_generator(seed: int, j: int, device) -> torch.Generator:
    """Shard ``j``'s generator on ``device`` of a batch whose generator has
    the seed ``seed``: seeded with ``seed + j * SHARD_SEED_STRIDE``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + j * SHARD_SEED_STRIDE) % (1 << 63))
    return g


# ---------------------------------------------------------------------------
# The object-axis split
# ---------------------------------------------------------------------------

def data_mesh(n_chain_shards: int, n_data_shards: int, devices=None) -> tuple:
    """A chains x objects grid: ``n_chain_shards`` rows of ``n_data_shards``
    devices each, from the first ``n_chain_shards * n_data_shards`` of
    ``devices`` (default: every visible CUDA device) in row-major order, as
    the JAX package's ``data_mesh`` reshapes them. A device may repeat (two
    object shards on one card)."""
    if devices is None:
        devices = visible_devices("cuda")
    n = n_chain_shards * n_data_shards
    if n < 1 or len(devices) < n:
        raise ValueError(f"a {n_chain_shards} x {n_data_shards} grid needs {n} devices, "
                         f"got {len(devices)}")
    devices = [canonical(d) for d in devices[:n]]
    return tuple(tuple(devices[i * n_data_shards:(i + 1) * n_data_shards])
                 for i in range(n_chain_shards))


def object_blocks(n_objects: int, n_blocks: int) -> tuple:
    """``n_blocks`` contiguous (lo, hi) blocks of the objects, as equal as
    possible: the first ``n_objects % n_blocks`` blocks hold one object more."""
    if not 1 <= n_blocks <= n_objects:
        raise ValueError(f"{n_objects} objects do not split into {n_blocks} blocks")
    base, extra = divmod(n_objects, n_blocks)
    bounds, lo = [], 0
    for j in range(n_blocks):
        hi = lo + base + (j < extra)
        bounds.append((lo, hi))
        lo = hi
    return tuple(bounds)


# The constants' object-axis arrays, and the axis of the objects in each.
OBJECT_ARRAYS = {"features": 0, "na": 0, "feat_idx": 0, "feat_idx_t": 1, "groups": 2,
                 "hc_conf": 0, "group_idx": 1, "static_pat": 0, "locations": 0}
# Of those, the O(N F) ones: never whole on one device.
OBJECT_FEATURE_ARRAYS = ("features", "na", "feat_idx", "feat_idx_t")


def block_constants(consts, lo: int, hi: int, device):
    """The model constants of the objects [lo, hi) on ``device``: each
    object-axis array (``OBJECT_ARRAYS``) cut to the block (a copy of its
    own), the model's tables shared (copied to ``device``), and no (N, N)
    geo tensors (the head computes the geo prior)."""
    device = canonical(device)
    cut = {name: getattr(consts, name).narrow(axis, lo, hi - lo).to(device).clone(
        memory_format=torch.contiguous_format) for name, axis in OBJECT_ARRAYS.items()}
    shapes = dataclasses.replace(consts.shapes, n_sites=hi - lo)
    rest = dataclasses.replace(consts, shapes=shapes, cost_matrix=None, adjacency=None,
                               **{k: None for k in OBJECT_ARRAYS})
    return dataclasses.replace(rest.to(device), **cut)


def head_constants(consts, device):
    """The model constants of a chain shard's head: those of ``consts`` on
    ``device`` without the O(N F) arrays (``OBJECT_FEATURE_ARRAYS`` are
    None), which only the blocks hold."""
    return dataclasses.replace(consts, **{k: None for k in OBJECT_FEATURE_ARRAYS}).to(device)


class Traffic:
    """Bytes sent between a head and its blocks other than the first (the
    port's counterpart of the collectives of the JAX split), by direction."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def add(self, direction: str, x):
        with self._lock:
            self.bytes[direction] += x.numel() * x.element_size()

    def reset(self):
        self.bytes = {"to_blocks": 0, "to_head": 0}


def _map(fn, x):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return fn(x)


class ObjectSplit:
    """The object blocks of one chain shard (a row of ``data_mesh``):
    ``devices[j]`` holds objects ``bounds[j]`` (``object_blocks``) with their
    constants ``blocks[j]`` (``block_constants``); the head, ``devices[0]``,
    holds ``head`` (``head_constants``). ``consts`` may lie on any device
    (the CPU, for a model larger than one card)."""

    def __init__(self, consts, devices):
        self.devices = tuple(canonical(d) for d in devices)
        self.head_device = self.devices[0]
        self.n_blocks = len(self.devices)
        self.N = consts.N
        self.bounds = object_blocks(consts.N, self.n_blocks)
        self.head = head_constants(consts, self.head_device)
        self.blocks = tuple(block_constants(consts, lo, hi, d)
                            for (lo, hi), d in zip(self.bounds, self.devices))
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" and self.n_blocks > 1 else None
                        for d in self.devices]
        self.traffic = Traffic()

    def to_block(self, j: int, x):
        """``x`` (a tensor, tuple or None on the head) for block ``j``: itself for
        the first block, else a copy on its device (counted)."""
        if j == 0:
            return x

        def move(t):
            self.traffic.add("to_blocks", t)
            return t.to(self.devices[j], copy=True)

        return _map(move, x)

    def to_head(self, j: int, x):
        """``x`` of block ``j`` on the head: a counted copy unless ``j`` is 0."""
        if j == 0:
            return x

        def move(t):
            self.traffic.add("to_head", t)
            return t.to(self.head_device, copy=True)

        return _map(move, x)

    def cols(self, j: int, x, dim: int = -1):
        """Block ``j``'s slice of a head tensor along its object axis ``dim``,
        on block ``j``'s device."""
        lo, hi = self.bounds[j]
        return self.to_block(j, x.narrow(dim, lo, hi - lo))

    def run(self, fn) -> list:
        """``[fn(j) for each block j]``: block j's work on its stream, which
        first waits for the head's current stream; the head's stream then
        waits for every block's. One host thread dispatches them all."""
        if self.n_blocks == 1 or self.streams[0] is None:
            return [fn(j) for j in range(self.n_blocks)]
        head = torch.cuda.current_stream(self.head_device)
        out = []
        for j, stream in enumerate(self.streams):
            with torch.cuda.device(self.devices[j]), torch.cuda.stream(stream):
                stream.wait_stream(head)
                out.append(fn(j))
        for stream in self.streams:
            head.wait_stream(stream)
        return out

    def reduce(self, fn):
        """The sum over the blocks of ``fn(j)`` (a tensor or a tuple of them,
        on block j's device), added on the head in block order."""
        parts = self.run(lambda j: self.to_head(j, fn(j)))
        total = parts[0]
        for p in parts[1:]:
            total = (tuple(a + b for a, b in zip(total, p)) if isinstance(total, tuple)
                     else total + p)
        return total

    def take_rows(self, arrays: list, idx, batched: bool):
        """Rows ``idx`` (B, m), each in [0, N), of an object-axis array split
        into ``arrays`` (block j: (N_j, ...), or with ``batched`` a chain
        batch (B, N_j, ...)), gathered on the head: every block sends its
        rows at the indices it holds (elsewhere a clamped row), and the head
        keeps each row from the block that holds it."""
        def one(j):
            lo, hi = self.bounds[j]
            local = self.to_block(j, torch.clamp(idx - lo, 0, hi - lo - 1))
            x = arrays[j]
            return self.to_head(j, batch_take(x, local) if batched else x[local])

        parts = self.run(one)
        out = parts[0]
        for (lo, _hi), rows in zip(self.bounds[1:], parts[1:]):
            mine = (idx >= lo).view(*idx.shape, *([1] * (rows.dim() - idx.dim())))
            out = torch.where(mine, rows, out)
        return out


class SplitSource:
    """The source of a chain batch split over the blocks of an
    ``ObjectSplit``: block j, (B, N_j, F) packed int8 or (B, N_j, F, C) bool,
    on the block's device. It stands where a ChainState holds its source
    tensor: ``model/math.py``'s ``gather_rows`` and ``scatter_rows`` hand
    their work to it. (A grid's operators never replace the whole source,
    so the MH step keeps the candidate's source object and never selects
    between two split sources.)"""

    def __init__(self, split: ObjectSplit, blocks: list):
        self.split = split
        self.blocks = list(blocks)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def shape(self) -> tuple:
        first = self.blocks[0].shape
        return (first[0], self.split.N, *first[2:])

    def gather_rows(self, idx, n_components=None):
        """``model.math.gather_rows`` of the whole source: the one-hot rows
        (B, m, F, C) at ``idx`` (N: padding, an all-zero row) on the head."""
        N = self.split.N
        valid = idx < N
        rows = self.split.take_rows(self.blocks, torch.clamp(idx, max=N - 1), batched=True)
        if self.dtype == torch.int8:
            if n_components is None:
                raise ValueError("gather_rows of a packed source needs n_components")
            return source_onehot(torch.where(valid[..., None], rows, n_components), n_components)
        return rows & valid.view(*valid.shape, 1, 1)

    def scatter_rows(self, idx, rows) -> "SplitSource":
        """``model.math.scatter_rows`` of the whole source: ``rows`` (one-hot
        (B, m, F, C), packed on the head first for a packed source) written
        at the distinct ``idx`` (N: dropped), each into the block that holds it."""
        if self.dtype == torch.int8 and rows.dim() == 4:
            rows = pack_source(rows)
        sp = self.split

        def one(j):
            lo, hi = sp.bounds[j]
            local = torch.where((idx >= lo) & (idx < hi), idx - lo, hi - lo)
            return scatter_rows(self.blocks[j], sp.to_block(j, local), sp.to_block(j, rows))

        return SplitSource(sp, sp.run(one))

    def whole(self, device):
        """The source as one tensor on ``device``: for checks and
        checkpoints, not for sampling."""
        return torch.cat([b.to(device) for b in self.blocks], dim=1)


def shard_objects(consts, grid) -> tuple:
    """The ``ObjectSplit`` of each row of a chains x objects ``grid``
    (``data_mesh``): per row, the head's constants and each block's."""
    return tuple(ObjectSplit(consts, row) for row in grid)


def shard_state(state, split: ObjectSplit):
    """A chain batch (``ChainState``, source whole, on any device) on the
    grid row ``split``: every field on the head but the source, which goes
    to the blocks (``SplitSource``)."""
    blocks = [state.source[:, lo:hi].to(d).clone(memory_format=torch.contiguous_format)
              for (lo, hi), d in zip(split.bounds, split.devices)]
    head = state._replace(source=None).to(split.head_device)
    return head._replace(source=SplitSource(split, blocks))


def unshard_state(state, device):
    """A chain batch of a grid row as one ``ChainState`` on ``device``, its
    source whole."""
    return state._replace(source=None).to(device)._replace(source=state.source.whole(device))
