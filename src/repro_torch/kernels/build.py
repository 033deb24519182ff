"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
library is built on first use into ``_build/`` beside this file (listed in
``.gitignore``), named by a hash of its sources, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import:
a CPU-only process imports this module without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels. A source of the round holds a dense kernel
and its ragged sibling; their counters (``relax`` and ``relax_ragged``,
...) are kept apart, so a run also shows which layout family it used.
``relax.cu`` also holds the single-query kernels of the standalone kernel
API, each with its own counter: ``relax_single`` (the fixpoint),
``relax_masked`` (the masked sweep) and ``relax_sweep`` (the plain sweep).
``embedding_bag.cu`` holds one kernel under its own name. Kernel 12 has two
sources, one kernel each, chosen by the inputs' type, both on the tensor
cores and sharing ``hopper.cuh``: ``flash_attention.cu`` (f32 in 3xTF32,
counter ``flash_attention``) and ``flash_attention_tc.cu`` (bf16, counter
``flash_attention_tc``).

Every call into a loaded library goes through ``call``, which sets the card
that holds the operands as the thread's current card for the length of the
call (PyTorch's device guard, which restores the caller's card), so a
kernel launches on its operands' card whatever card the caller has made
current, and a launch takes that card's current stream. Counting is safe
from several host threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
ROUND = ("relax", "send", "merge", "round")   # dense + ragged kernel each
KERNELS = ROUND + ("embedding_bag", "flash_attention",   # a library each
                   "flash_attention_tc")
COUNTERS = (ROUND + tuple(f"{k}_ragged" for k in ROUND)
            + ("relax_single", "relax_masked", "relax_sweep", "embedding_bag",
               "flash_attention", "flash_attention_tc"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in COUNTERS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()        # LAUNCHES and _LIBS, across host threads
_QUERIES: dict[tuple, int] = {}  # call's query values, per card and arguments


def count_launch(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None when already built)."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build(names=KERNELS) -> tuple[float, dict[str, str]]:
    """Compile the named kernels, one nvcc each, all started together.
    Returns (wall seconds, compiler log per kernel)."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    logs = {name: _finish(name, s) for name, s in started.items()}
    return time.perf_counter() - t0, logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built if missing), with
    ``argtypes``/``restype`` set from ``signatures`` = {symbol: argtypes}.
    Every entry point returns the ``cudaGetLastError`` code of its launch."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for symbol, argtypes in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def _current_card() -> int:
    """``torch.cuda.current_device()`` without its lazy-init check: a
    launch's operands are on a card, so CUDA is up."""
    return torch._C._cuda_getDevice()


def call(lib: ctypes.CDLL, symbol: str, device: torch.device, *args,
         launch: str | None = None) -> int:
    """Call entry point ``symbol`` of ``lib`` with ``args`` on CUDA card
    ``device``, the card of the operands: under PyTorch's device guard for
    that card, which restores the caller's card after the call, an error
    included (no guard where the card is already current). With
    ``launch``, the kernel's name, the call launches: the card's current
    stream is passed last, and a nonzero return raises (``check``).
    Without it, the call is a query (sizes, scratch: integers in, an
    integer out, a function of the card and the arguments alone), whose
    value is kept per (card, arguments) and returned: a launch's host time
    goes to the launch's one guarded call. Moves nothing and picks no card
    of its own."""
    if launch is None:
        key = (lib, symbol, device.index, args)
        code = _QUERIES.get(key)
        if code is not None:
            return code
    fn = getattr(lib, symbol)
    if launch is not None:
        args = (*args, current_stream(device))
    if _current_card() == device.index:
        code = fn(*args)
    else:
        with torch.cuda.device(device.index):
            code = fn(*args)
    if launch is None:
        _QUERIES[key] = code
    else:
        check(lib, launch, code)
    return code


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(error {code})")


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on CUDA ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it, without
    making a Stream object on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def ptr_or_null(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else ptr(t)


def signature(n_ptr: int, n_int: int) -> list:
    """argtypes of an entry point: pointers, then ints, then the stream."""
    return [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
