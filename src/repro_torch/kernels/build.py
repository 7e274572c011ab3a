"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries land
in ``src/repro_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing compiles at import time: a kernel builds at its
first launch, or all at once, in parallel, through :func:`build_all`.

Every exported launcher takes tensor pointers and the CUDA stream as
``void*`` and returns the ``cudaError_t`` of its launch; :meth:`Kernel.launch`
raises on a non-zero code and counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels need the "
                       "CUDA toolkit")


class Kernel:
    """One CUDA source -> one shared library -> one launcher symbol.

    ``launches`` counts successful launches; :func:`reset_counts` zeroes
    it.  The library is built (if missing) and loaded on first use.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: list):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._others: dict = {}
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def compile_command(self, out: Path) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.lib_path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn, self._err = lib, fn, err

    def load(self) -> None:
        """Build (if needed) and bind the launcher; needs a CUDA device."""
        if self._fn is not None:
            return
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {self.name}: no CUDA device; the "
                               "plain PyTorch version serves CPU tensors")
        with self._lock:
            if self._fn is None:
                if not self.lib_path.exists():
                    build_all([self])
                self._bind()

    def _call(self, fn, device: torch.device, args) -> None:
        # the launcher runs on the current device: switch only when the
        # tensors lie on another one (the switch costs more than a check)
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        if index == torch.cuda.current_device():
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(index):
                rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(f"kernel {self.name}: launch failed with "
                               f"CUDA error {rc} ({msg})")

    def launch(self, device: torch.device, *args) -> None:
        """Call the launcher on ``device``'s current stream, with that
        device made current (the tensors' pointers belong to it); raise on
        a CUDA error."""
        self.load()
        self._call(self._fn, device, args)
        self.launches += 1

    def launch_uncounted(self, symbol: str, device: torch.device,
                         *args) -> None:
        """Call another launcher of the same library, with the same
        argument types (an earlier design kept for timing); not counted
        in ``launches``."""
        self.load()
        fn = self._others.get(symbol)
        if fn is None:
            fn = self._others[symbol] = getattr(self._lib, symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
        self._call(fn, device, args)


def build_all(kernels: list[Kernel]) -> dict[str, str]:
    """Compile every missing library at once (one ``nvcc`` per source,
    all started together) -> {kernel name: compiler output}.  Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in kernels:
        if k.lib_path.exists():
            continue
        tmp = k.lib_path.with_suffix(f".{os.getpid()}.tmp")
        procs[k.name] = (k, tmp, subprocess.Popen(
            k.compile_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (k, tmp, p) in procs.items():
        out, _ = p.communicate()
        k.build_log = out
        if p.returncode != 0:
            failed.append(f"{name} (nvcc exit {p.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, k.lib_path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {k.name: k.build_log for k in kernels}


def reset_counts(kernels: list[Kernel]) -> None:
    for k in kernels:
        k.launches = 0
