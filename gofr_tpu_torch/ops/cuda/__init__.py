"""Build and load the hand-written Hopper kernels.

The CUDA C++ sources live in ``gofr_tpu_torch/csrc``. At first use each
``*.cu`` is compiled by its own ``nvcc`` process (all started together) for
``sm_90a`` with a plain C interface, the objects are linked into
``gofr_tpu_torch/build/libgofr_kernels.so``, and the library is loaded with
``ctypes`` — a few seconds, where a build that includes PyTorch's headers
takes minutes. Pointers and the stream go over as ``c_void_p``.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check`` raises ``KernelError`` on anything but 0. A failed build raises it
too, and ``require`` raises ``KernelInputError`` (a ``ValueError`` as well)
on input a kernel does not take: the kernels never fall back to their
plain versions on the card, and a caller that absorbs other failures (the
quality plane's scorer) lets these through.

Importing this package builds nothing and needs no CUDA toolkit; the CPU
tests import it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
LIBRARY = BUILD / "libgofr_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch."""


class KernelInputError(KernelError, ValueError):
    """Input a kernel does not take (checked before any pointer reaches C)."""


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda's,
    else the one on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def compile_commands(compiler: str = "nvcc", csrc: Path = CSRC,
                     build_dir: Path = BUILD) -> list[list[str]]:
    """One compile command per source, then the link command."""
    library = build_dir / LIBRARY.name
    objs = [build_dir / f"{src.stem}.o" for src in sources(csrc)]
    cmds = [[compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(csrc), objs)]
    cmds.append([compiler, *ARCH, "-shared", *map(str, objs), "-o", str(library) + ".tmp"])
    return cmds


def build(csrc: Path = CSRC, build_dir: Path = BUILD) -> dict:
    """Compile every source of ``csrc`` in parallel and link the library in
    ``build_dir``. Returns the seconds taken, the compiler's register/
    shared-memory report and the library's path."""
    start = time.perf_counter()
    library = build_dir / LIBRARY.name
    build_dir.mkdir(parents=True, exist_ok=True)
    *compiles, link = compile_commands(nvcc(), csrc, build_dir)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    reports = [proc.communicate()[0] for proc in procs]
    for cmd, proc, report in zip(compiles, procs, reports):
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed ({proc.returncode}) on {cmd[-3]}:\n{report}")
    linked = subprocess.run(link, capture_output=True, text=True)
    if linked.returncode != 0:
        raise KernelError(f"link failed ({linked.returncode}):\n{linked.stdout}{linked.stderr}")
    os.replace(str(library) + ".tmp", library)
    return {"seconds": time.perf_counter() - start, "ptxas": "".join(reports), "library": library}


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir())


def load(library: Path = LIBRARY) -> ctypes.CDLL:
    """Load a built kernel library and make it the one every wrapper
    launches from (a check of a modified copy of the sources loads its own)."""
    global _lib
    loaded = ctypes.CDLL(str(library))
    loaded.gofr_error_string.argtypes = [ctypes.c_int]
    loaded.gofr_error_string.restype = ctypes.c_char_p
    _lib = loaded
    return loaded


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than its
    sources."""
    with _lock:
        if _lib is None:
            if _stale():
                build()
            load()
        return _lib


def bind(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared."""
    fn = getattr(lib(), name)  # ctypes caches the function object per name
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device, from the
    raw accessor PyTorch's own compiled kernels launch with:
    ``torch.cuda.current_stream`` builds a Stream object per call, a few
    microseconds of every launch (scripts/torch_launcher_cost.py)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require(cond: bool, msg: str) -> None:
    """Reject input a kernel does not take (wrappers validate before any
    pointer reaches C)."""
    if not cond:
        raise KernelInputError(msg)


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} ({lib().gofr_error_string(rc).decode()})")


def _wrappers() -> dict:
    from gofr_tpu_torch.ops.cuda import (
        decode_attention,
        flash_attention,
        kv_append,
        paged_decode,
        paged_decode_q,
        paged_decode_q4,
        w8a16,
    )

    return {"paged_decode": paged_decode.paged_decode,
            "kv_append": kv_append.kv_append,
            "flash_attention": flash_attention.flash_attention,
            "paged_decode_q": paged_decode_q.paged_decode_q,
            "paged_decode_q4": paged_decode_q4.paged_decode_q4,
            "decode_attention": decode_attention.decode_attention,
            "kv_append_slot": kv_append.kv_append_slot,
            "kv_append_q": kv_append.kv_append_q,
            "kv_append_q4": kv_append.kv_append_q4,
            "kv_append_slot_q": kv_append.kv_append_slot_q,
            "w8a16": w8a16.w8a16}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset (wrappers count only
    where they launch, never on the plain path)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["flash_attention"].offset_launches = 0
