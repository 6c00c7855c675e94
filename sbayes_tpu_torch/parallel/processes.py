"""The worker processes of the process split of a chain batch.

The chain split of ``sampling/runner.py::ShardedRuntime`` keeps shard 0
in the calling process and gives every other shard a process of its own,
so that each shard dispatches its steps under an interpreter lock of its
own. This module holds both sides: ``serve``, the entry function of a worker, and
``ShardProcesses``, the workers seen from the calling process.

A worker is started with the ``spawn`` context (the caller may hold a CUDA
context, which ``fork`` would copy), receives the model constants once,
builds its ``SamplerRuntime`` on its device and then serves commands until
it is closed or its pipe ends. What a worker computes stays in the worker:
its chain batches, operator statistics and per-chain tensors are held
there under a key and the caller holds a ``Remote`` for each, with the
chains' log-likelihoods and log-priors (of a ChainState) or the count of
non-finite accepts (of an OperatorStats) read with it. When the caller's
``Remote`` is collected, the next command tells the worker to drop it.

Transport: one duplex ``multiprocessing`` pipe per worker, one command and
one reply at a time. Messages are pickled here with every tensor as a
numpy copy of its elements (``_Pickler``), and every array's bytes go
down the pipe apart from the pickle (``send``): chains travel through host
memory only (no CUDA IPC, no shared-memory handles; a view sends only its
own elements). Every reply comes after the worker's device finished the
command's work, so the caller's timings include the workers'.
"""
from __future__ import annotations

import copyreg
import io
import itertools
import multiprocessing
import os
import pickle
import time
import traceback
import weakref
from typing import NamedTuple

import numpy as np
import torch

from sbayes_tpu_torch.parallel.mesh import place_chains, shard_generator

# Seconds the caller waits for a worker to end after ``close`` before killing it
CLOSE_TIMEOUT_S = 60.0


def _tensor(array, order=None):
    t = torch.from_numpy(array)
    return t if order is None else t.permute(*sorted(range(t.dim()), key=order.__getitem__))


def _reduce_tensor(t):
    """A tensor as a numpy copy of its elements; one whose elements are dense
    in another order than row-major (a transpose) keeps its strides, as
    ``Tensor.to`` keeps them."""
    t = t.detach()
    if t.is_contiguous():
        return _tensor, (t.cpu().numpy(),)
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    outer_first = t.permute(*order)
    if not outer_first.is_contiguous():              # not dense: row-major, as ``.to``
        return _tensor, (t.contiguous().cpu().numpy(),)
    return _tensor, (outer_first.cpu().numpy(), order)


def _array(data: bytearray, dtype: str, shape: tuple) -> np.ndarray:
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _reduce_array(a: np.ndarray):
    """An array as a buffer of its elements (sent apart from the pickle,
    ``send``), its dtype by name (so that it loads with the dtype instance
    numpy shares, and pickles again as the sender's would) and its shape."""
    if a.dtype.hasobject:
        return a.__reduce_ex__(4)
    flat = np.ascontiguousarray(a).reshape(-1)
    return _array, (pickle.PickleBuffer(flat), a.dtype.str, a.shape)


class _Pickler(pickle.Pickler):
    """Pickles a tensor as a numpy copy of its elements (on any device), and
    an array by ``_reduce_array``."""

    dispatch_table = copyreg.dispatch_table.copy()
    dispatch_table[torch.Tensor] = _reduce_tensor
    dispatch_table[np.ndarray] = _reduce_array


def send(conn, obj):
    """Send ``obj`` on the pipe ``conn``: the sizes of its arrays' buffers and
    the pickle as two messages, then each buffer's bytes as they lie.
    Large arrays never pass through one message: the reader of a message
    (``Connection.recv_bytes``) allocates what is left of it for each read
    from the pipe. On an H100 host, a worker of the 10,000 x 5,000 model
    (1.2 GB of constants) was ready 523 s after its spawn with each message
    whole, 10.0 s after it as here (``chip_smoke.py``, phase ``mesh``)."""
    stream = io.BytesIO()
    buffers = []
    _Pickler(stream, protocol=5, buffer_callback=buffers.append).dump(obj)
    raws = [b.raw() for b in buffers]
    conn.send_bytes(pickle.dumps([r.nbytes for r in raws]))
    conn.send_bytes(stream.getbuffer())
    for raw in raws:
        done = 0
        while done < raw.nbytes:
            done += os.write(conn.fileno(), raw[done:])


def recv(conn):
    """The object ``send`` sent on ``conn``; its arrays load writable, in
    buffers of their own."""
    sizes = pickle.loads(conn.recv_bytes())
    stream = conn.recv_bytes()
    buffers = []
    for size in sizes:
        buf = bytearray(size)
        view, done = memoryview(buf), 0
        while done < size:
            n = os.readv(conn.fileno(), [view[done:]])
            if n == 0:
                raise EOFError("the pipe ended within a message")
            done += n
        buffers.append(buf)
    return pickle.loads(stream, buffers=buffers)


class Ref(NamedTuple):
    """An object a worker holds, as a command's argument."""
    key: int


class GenRef(NamedTuple):
    """The worker's generator of a split batch whose generator has the seed
    ``seed`` (``mesh.shard_generator``), made at first use and kept under
    ``key`` (one key per ``ShardGenerators`` of the caller)."""
    key: int
    seed: int


class Held(NamedTuple):
    """What a worker answers for an object it keeps: its kind (``state``,
    ``stats`` or ``tensor``), key, chain count, and for a state its (log_lh,
    log_prior), for stats its count of non-finite accepts."""
    kind: str
    key: int
    n_chains: int
    read: object


class Remote:
    """The caller's handle of a chain batch held by a worker: a shard of a
    ChainState (``log_lh``, ``log_prior``: numpy), of an OperatorStats
    (``non_finite``: int) or of a (B, ...) tensor."""

    def __init__(self, worker: "Worker", held: Held):
        self.worker = worker
        self.kind = held.kind
        self.key = held.key
        self.n_chains = held.n_chains
        if held.kind == "state":
            self.log_lh, self.log_prior = held.read
        elif held.kind == "stats":
            self.non_finite = held.read
        weakref.finalize(self, worker.released.append, held.key)


class WorkerError(RuntimeError):
    """A command failed in a worker (its traceback in the message), or the
    worker ended; raised in the caller once every worker has stopped."""


def _to_refs(worker: "Worker", x):
    if isinstance(x, Remote):
        if x.worker is not worker:
            raise ValueError(f"shard {x.worker.j}'s batch passed to shard {worker.j}")
        return Ref(x.key)
    if type(x) in (tuple, list):
        return type(x)(_to_refs(worker, v) for v in x)
    if isinstance(x, dict):
        return {k: _to_refs(worker, v) for k, v in x.items()}
    return x


def _to_remotes(worker: "Worker", x):
    if isinstance(x, Held):
        return Remote(worker, x)
    if type(x) in (tuple, list):
        return type(x)(_to_remotes(worker, v) for v in x)
    return x


class Worker:
    """Shard ``j``'s process, seen from the caller."""

    def __init__(self, ctx, j: int, device):
        self.j = j
        self.conn, child = ctx.Pipe()
        self.process = ctx.Process(target=serve, args=(child, j, device),
                                   name=f"sbayes-shard-{j}", daemon=True)
        self.process.start()
        child.close()                     # the worker's end: EOF here once it ends
        self.pending = False
        self.released: list = []

    def send(self, cmd: str, *args):
        """Send one command (``Remote`` arguments as ``Ref``), with the keys of
        the collected ``Remote``s to drop."""
        if self.pending:
            raise RuntimeError(f"shard {self.j}: a command is still unanswered")
        drop = self.released[:]
        del self.released[:len(drop)]
        send(self.conn, (cmd, _to_refs(self, args), drop))
        self.pending = True

    def recv(self) -> tuple:
        """(True, value with ``Remote``s) or (False, the worker's traceback)."""
        try:
            ok, value = recv(self.conn)
        except (EOFError, OSError):
            self.process.join(CLOSE_TIMEOUT_S)
            ok, value = False, (f"the process of shard {self.j} ended "
                                f"(exit code {self.process.exitcode})")
        self.pending = False
        return ok, (_to_remotes(self, value) if ok else value)


def _stop(workers: list):
    """End every worker: answer what is pending, send ``close``, join; kill
    a worker that does not end."""
    for w in workers:
        try:
            if w.pending and w.conn.poll(CLOSE_TIMEOUT_S):
                recv(w.conn)
            w.pending = False
            send(w.conn, ("close", (), []))
        except (EOFError, OSError):
            pass
    for w in workers:
        w.process.join(CLOSE_TIMEOUT_S)
        if w.process.is_alive():
            w.process.kill()
            w.process.join()
        w.conn.close()
        w.process.close()


class ShardProcesses:
    """The worker processes of shards 1, ..., len(mesh) - 1 of a split chain
    batch, shard j on ``mesh[j]``; each builds its ``SamplerRuntime`` from
    ``setup`` = (model constants, MCMC config, sample_from_prior), received
    once. ``startup_s``: seconds from the first spawn to every worker ready.
    ``close`` (also at collection and at exit) ends them."""

    def __init__(self, mesh, setup: tuple):
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        self.workers: list = []
        self._finalizer = weakref.finalize(self, _stop, self.workers)
        try:
            for j in range(1, len(mesh)):
                self.workers.append(Worker(ctx, j, mesh[j]))
            for w in self.workers:
                w.send("setup", *setup)
            self.replies()
        except BaseException:
            self.close()
            raise
        self.startup_s = time.perf_counter() - t0

    def replies(self) -> list:
        """The reply of every worker with a command pending, in shard order;
        if one failed, every worker is stopped, then its error is raised."""
        out, errors = [], []
        for w in self.workers:
            if not w.pending:
                out.append(None)
                continue
            ok, value = w.recv()
            out.append(value)
            if not ok:
                errors.append(f"shard {w.j}:\n{value}")
        if errors:
            self.close()
            raise WorkerError("\n".join(errors))
        return out

    def send(self, cmd: str, per_worker: list):
        """``cmd`` with the arguments ``per_worker[i]`` sent to every worker,
        whose replies ``replies`` then waits for."""
        for w, args in zip(self.workers, per_worker):
            w.send(cmd, *args)

    def each(self, cmd: str, per_worker: list) -> list:
        """``send``, then the ``replies``."""
        self.send(cmd, per_worker)
        return self.replies()

    def one(self, j: int, cmd: str, *args):
        """``cmd`` on shard ``j``'s worker alone."""
        w = self.workers[j - 1]
        w.send(cmd, *args)
        ok, value = w.recv()
        if not ok:
            self.close()
            raise WorkerError(f"shard {j}:\n{value}")
        return value

    @property
    def closed(self) -> bool:
        return not self._finalizer.alive

    def close(self):
        self._finalizer()


def serve(conn, j: int, device):
    """The entry function of shard ``j``'s worker on ``device``: receive the
    setup, build the runtime, then answer commands until ``close`` or the
    end of the pipe. A command that raises answers its traceback; the
    worker goes on serving."""
    from sbayes_tpu_torch.ops import check
    from sbayes_tpu_torch.sampling.kernel import OperatorStats
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime
    from sbayes_tpu_torch.sampling.state import ChainState

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)        # the shards share the host's cores
    held: dict = {}
    gens: dict = {}
    keys = itertools.count()

    def keep(x):
        if isinstance(x, (ChainState, OperatorStats, torch.Tensor)):
            key = next(keys)
            held[key] = x
            if isinstance(x, ChainState):
                return Held("state", key, x.n_chains,
                            (x.log_lh.cpu().numpy(), x.log_prior.cpu().numpy()))
            if isinstance(x, OperatorStats):
                return Held("stats", key, x.accepts.shape[0], int(x.non_finite.sum()))
            return Held("tensor", key, x.shape[0] if x.dim() else 0, None)
        if type(x) in (tuple, list):
            return type(x)(keep(v) for v in x)
        return x

    def resolve(x):
        if isinstance(x, Ref):
            return held[x.key]
        if isinstance(x, GenRef):
            if x.key not in gens:
                gens[x.key] = shard_generator(x.seed, j, device)
            return gens[x.key]
        if type(x) in (tuple, list):
            return type(x)(resolve(v) for v in x)
        if isinstance(x, dict):
            return {k: resolve(v) for k, v in x.items()}
        return x

    def call(fn, kwargs: dict):
        """``fn`` of the runtime (a method name, or a function of the runtime
        first) with the keywords ``kwargs``."""
        fn = getattr(rt, fn) if isinstance(fn, str) else fn.__get__(rt)
        return keep(fn(**resolve(kwargs)))

    def take(ref, local, moved):
        return keep(place_chains(held[ref.key], local, moved))

    def get(ref, idx):
        x = held[ref.key]
        if idx is None:
            return x
        idx = torch.as_tensor(idx, device=device) if not isinstance(idx, slice) else idx
        return x[idx] if isinstance(x, torch.Tensor) else x.select(idx)

    commands = {
        "call": call,
        "put": lambda x: keep(x.to(device)),
        "get": get,
        "take": take,
        "launches": check.launch_counts,
        "reset_launches": check.reset_launches,
    }
    rt = None
    try:
        _, (consts, mcmc_config, sample_from_prior), _ = recv(conn)
        rt = SamplerRuntime(None, mcmc_config, sample_from_prior, consts=consts.to(device))
        reply = (True, None)
    except EOFError:
        return
    except Exception:
        reply = (False, traceback.format_exc())
    send(conn, reply)
    if rt is None:
        return
    while True:
        try:
            cmd, args, drop = recv(conn)
        except (EOFError, OSError):
            return
        for key in drop:
            held.pop(key, None)
        if cmd == "close":
            return
        try:
            value = commands[cmd](*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            reply = (True, value)
        except Exception:
            reply = (False, traceback.format_exc())
        send(conn, reply)
