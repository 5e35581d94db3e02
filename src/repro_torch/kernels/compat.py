"""Device resolution, the CUDA kernel builder/loader, launch counters and the
per-weight derived-value memo.

Counterpart of ``repro/kernels/compat.py``: where the reference asks "should
Pallas run compiled or interpreted?", the port asks "is this tensor on the
card?". A kernel wrapper launches its hand-written CUDA kernel for a CUDA
tensor and takes its plain PyTorch version only for a CPU tensor; it never
retreats from one to the other.

Kernels are CUDA C++ sources under ``csrc/``, each compiled at first use by
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
with a plain C interface (``build/repro_torch_kernels/`` at the repo root,
one ``nvcc`` per source, all started together) and loaded with ``ctypes``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import weakref
from typing import Callable, Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
# The H100 SXM's SMs, which the GEMM launch plans fill, and the bound on any
# split-K partials buffer (the launch plan of K2, K3 and K7's FIP/FFIP).
SMS = 132
WORKSPACE_BYTES = 512 * 1024 * 1024


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda:0``); with no card that raises rather
    than quietly running on the CPU. Tests pass ``"cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card unless the "
                "caller passes device='cpu'")
        return torch.device("cuda", 0)
    return torch.device(device)


def device_kind() -> str:
    """Schedule-cache device key, e.g. ``NVIDIA_H100_80GB_HBM3`` or ``cpu``."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0).replace(" ", "_")


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

class LaunchCounter:
    """Plain count of kernel launches, bumped by a wrapper exactly where it
    launches its CUDA kernel (never on the CPU plain path)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def bump(self) -> None:
        self.n += 1


counters: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    counters[name] = LaunchCounter(name)
    return counters[name]


def reset_counters() -> None:
    for c in counters.values():
        c.n = 0


def launch_counts() -> Dict[str, int]:
    return {name: c.n for name, c in counters.items()}


# ---------------------------------------------------------------------------
# Kernel build + load (ctypes route, plain C interface)
# ---------------------------------------------------------------------------

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    """The library of ``src``, named by a digest of the source, the shared
    headers it may include and the flags: an edit to any of them rebuilds."""
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all(names=None) -> float:
    """Compile every (or the named) kernel source that has no up-to-date
    library yet, one ``nvcc`` process per source, all started together.
    Returns the wall time spent; raises with the compiler's output if any
    build fails."""
    srcs = sorted(CSRC.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
    t0 = time.perf_counter()
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in srcs:
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library (building it first if needed) and
    declare each C entry point's ``argtypes``; every entry point returns the
    ``cudaError_t`` of its launch as an int."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    path = _lib_path(src)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def refuse_grad(what: str, *tensors: torch.Tensor, hint: str = "") -> None:
    """Raise where a forward-only kernel would meet autograd: with grad mode
    on and an operand that requires grad. On the card the kernel writes into
    an output with no ``grad_fn``, so a ``backward()`` would silently drop
    the gradients upstream; on the CPU the plain version would differentiate.
    The reference raises on both (its Pallas kernels have no gradient:
    ``jax.grad`` through ``repro.kernels.ops.matmul`` fails), and so does
    the port, on both devices."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} has no gradient, as in the reference (its Pallas kernel "
            f"has no VJP: jax.grad through it fails); run it under "
            f"torch.no_grad(){hint}")


# ---------------------------------------------------------------------------
# Per-weight derived values (Eq. 9 y-deltas)
# ---------------------------------------------------------------------------

class DerivedCache:
    """Per-weight derived-value memo (the FFIP y-deltas, §4.4: y is an
    offline transform of the trained weights, not per-call work).

    The reference keys on ``id(array)``. In torch every view (``table.T``,
    ``stacked[i]``) is a new object, so an id key would recompute e.g. the
    tied unembed's (2304, 122753) f32 deltas on every decode step. The key is
    the STORAGE instead: (tag, data_ptr, shape, stride, dtype, device) plus
    the version counter, which any in-place write to the weight bumps. A
    weakref on the view's base tensor drops the entry when the weight dies,
    so a recycled address can never alias a freed weight.
    """

    def __init__(self):
        self._cache: dict = {}
        self.stats = {"computed": 0, "hits": 0}

    @staticmethod
    def _key(tag: str, t: torch.Tensor):
        return (tag, t.data_ptr(), tuple(t.shape), tuple(t.stride()),
                t.dtype, str(t.device))

    def get(self, tag: str, t: torch.Tensor, fn: Callable):
        key = self._key(tag, t)
        root = t._base if t._base is not None else t
        hit = self._cache.get(key)
        if (hit is not None and hit[0]() is root
                and hit[1] == t._version):
            self.stats["hits"] += 1
            return hit[2]
        val = fn(t)
        self.stats["computed"] += 1
        # the callback holds the memo only weakly: a strong reference would
        # close a cycle (memo -> entry -> weakref -> callback -> memo) that
        # keeps a dropped memo's values alive until the next gc pass
        self._cache[key] = (weakref.ref(root, functools.partial(
            _drop_entry, weakref.ref(self), key)), t._version, val)
        return val

    def __len__(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        self._cache.clear()


def _drop_entry(memo_ref, key, _dead) -> None:
    memo = memo_ref()
    if memo is not None:
        memo._cache.pop(key, None)


# The memo for calls outside any server. A BatchServer installs its own
# (:func:`use_derived`), so the y-deltas it prepares live and die with it.
derived = DerivedCache()
_derived_state = threading.local()


def current_derived() -> DerivedCache:
    return getattr(_derived_state, "cache", derived)


@contextlib.contextmanager
def use_derived(cache: DerivedCache):
    prev = current_derived()
    _derived_state.cache = cache
    try:
        yield
    finally:
        _derived_state.cache = prev
