"""Build and load the hand-written CUDA kernels of ``sbayes_tpu_torch/csrc``.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), so the build time stays that of
the slowest source as kernels are added; the objects are then linked into
one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use into ``sbayes_tpu_torch/_build/`` (ignored by
git), keyed by a hash of the sources, so an unchanged tree builds once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry points: name -> argument types (pointers, ints, then the stream)
SIGNATURES = {
    "sbt_loglh": [_P] * 7 + [_I] * 8 + [_P],
    "sbt_loglh_feature_tile": [_I] * 7,
    "sbt_loglh_counts": [_P] * 6 + [_I] * 8 + [_P],
    "sbt_loglh_from_counts": [_P] * 5 + [_I] * 6 + [_P],
    "sbt_marginal": [_P] * 13 + [_I] * 12 + [_P],
    "sbt_mst": [_P] * 6 + [_I] * 3 + [_P],
    "sbt_draw": [_P] * 3 + [_L] + [_I] * 2 + [_P],
    "sbt_empty": [_P],
}
_BUILD_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def build(verbose: bool = False) -> Path:
    """Compile every source (one nvcc each, all started together), link the
    objects into one library and return its path; ``verbose`` prints
    ptxas's register, shared-memory and spill report. One build runs at a
    time in a process (a lock, for callers in threads of their own), and
    each build writes its objects into a directory of its own, so that
    builds in several processes never share a file until the whole library
    replaces its path."""
    with _BUILD_LOCK:
        return _build(verbose)


def _build(verbose: bool) -> Path:
    srcs = sources()
    hashed = srcs + sorted(SRC_DIR.glob("*.cuh"))          # headers the sources share
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in hashed)
                            + " ".join(ARCH_FLAGS).encode())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib = out_dir / "libsbayes_kernels.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build.", dir=out_dir))
    try:
        objs = [work / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                                   "-fPIC", "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(srcs, procs)]
        failed = [src.name for src, proc in zip(srcs, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        partial = work / lib.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(partial),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}\n{link.stderr}")
        os.replace(partial, lib)  # a library that exists is always whole
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if verbose:
        print("\n".join(logs))
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sbt_error_string.argtypes = [ctypes.c_int]
    lib.sbt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = library().sbt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")


class LaunchCounter:
    """How often a wrapper launched its kernel (the plain version and
    refused launches do not count): in all, by variant, and by the place of
    the launch, ``(device index, stream handle)``, so that the object blocks
    of a grid row, each on a stream of its own, count apart. A lock guards
    the counts for callers in threads of their own."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.variants: dict = {}
        self.by_place: dict = {}
        self._lock = threading.Lock()

    def add(self, variant=None, place=None, n: int = 1):
        """Count ``n`` launches (of ``variant``, for kernels built in
        variants) at ``place``: (device index, stream handle) of the launch."""
        with self._lock:
            self.count += n
            if variant is not None:
                self.variants[variant] = self.variants.get(variant, 0) + n
            if place is not None:
                counts = self.by_place.setdefault(place, {})
                counts[variant] = counts.get(variant, 0) + n

    def state(self) -> tuple:
        """The counts as they are, for ``rewind``."""
        with self._lock:
            return (self.count, dict(self.variants),
                    {p: dict(v) for p, v in self.by_place.items()})

    def rewind(self, state: tuple) -> dict:
        """Put the counts back to ``state`` and return what was counted
        since, by variant (None: launches of no variant). A CUDA graph's
        capture counts launches that only its replays make
        (``sampling/graphs.py``)."""
        with self._lock:
            count, variants, by_place = state
            since = {v: n - variants.get(v, 0) for v, n in self.variants.items()
                     if n != variants.get(v, 0)}
            if self.count - count - sum(since.values()):
                since[None] = self.count - count - sum(since.values())
            self.count, self.variants, self.by_place = count, dict(variants), by_place
            return since

    def reset(self):
        with self._lock:
            self.count = 0
            self.variants.clear()
            self.by_place.clear()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
