"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``), then loaded with
``ctypes``. The library's file name carries a hash of its source, so
an edited kernel rebuilds and a stale one is never loaded. Builds run
at first use; :func:`build_all` starts one ``nvcc`` per source, all at
once, for callers that want every kernel ready up front.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. Every launch goes through :func:`launch`, which makes the
tensors' device current first: an entry launches on the current device
and keeps its per-device state (SM count, shared-memory attributes)
under that device's index.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: dict = {}       # (library, symbol) → ctypes function with argtypes set


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels build only where the toolkit is")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out), str(CSRC / f"{name}.cu")]


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Compile every kernel source not yet built, one ``nvcc`` process
    per source, all started together. Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in sources()}
    procs = {}
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
        else:
            tmp.replace(out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                res = subprocess.run(_command(name, tmp),
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                                       f"{res.stdout}{res.stderr}")
                tmp.replace(out)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA error {code} launching {what}")


def entry(lib_name: str, fn_name: str, argtypes) -> Callable[..., int]:
    """The C function ``fn_name`` of ``csrc/<lib_name>.cu`` (built and
    loaded at first use), returning an int."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def launch(device: torch.device, lib_name: str, symbol: str,
           argtypes: Sequence, *args) -> None:
    """Call the entry ``symbol`` of ``csrc/<lib_name>.cu`` with ``args``
    and then the current stream of ``device``, with ``device`` the
    current device during the call; raise on a non-zero code."""
    fn = entry(lib_name, symbol, list(argtypes) + [ctypes.c_void_p])
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(code, symbol)
