"""Build, load and launch the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``*.cu`` source is compiled on first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.  Libraries
land in ``build/repro_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source builds anew and a stale library is
never loaded.  ``build_all`` starts one ``nvcc`` per source at once.

A ``CudaKernel`` is one launcher symbol plus a plain launch counter: every
successful launch through ``CudaKernel.launch`` adds one, and nothing else does.
Importing this module builds and loads nothing, so the CPU path never needs
``nvcc``: a library is built and loaded at its kernel's first launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("modops.cu", "ntt.cu", "fusedks.cu", "bconv.cu", "hoistrot.cu", "bsgsmac.cu", "rescale.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise FileNotFoundError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(source: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def _nvcc_command(source: str, out: pathlib.Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc`` runs at once.

    Returns {source: compiler output}; raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(_nvcc_command(src, tmp), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        logs[src], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(src)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[s] for s in failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    path = library_path(source)
    if not path.exists():
        build_all((source,))
    return ctypes.CDLL(str(path))


class CudaKernel:
    """One CUDA launcher (an ``extern "C"`` symbol) and its launch counter."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0

    @functools.cached_property
    def _fn(self):
        fn = getattr(library(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the launcher on ``device``'s current stream; raise on a CUDA error."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int


def pass_blocks(source: str, symbol: str, *args: int) -> tuple[int, int]:
    """The two block counts that ``source``'s C function ``symbol(*args, int
    blocks[2])`` reports for a launch: a two-pass launcher's blocks per pass, or
    ``bconv``'s grid."""
    blocks = (ctypes.c_int * 2)()
    if getattr(library(source), symbol)(*args, blocks) != 0:
        raise ValueError(f"{symbol} refused {args}")
    return blocks[0], blocks[1]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """Validate the residue tensors a kernel is given: int32, contiguous, on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device} and {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"kernel inputs hold residues as int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev


def u32_tensor(values, device) -> torch.Tensor:
    """uint32 values (< 2^32) → an int32 tensor holding the same bit patterns."""
    a = np.ascontiguousarray(np.asarray(values, np.uint64).astype(np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def mont_form(values: np.ndarray, qs) -> np.ndarray:
    """Plain residues (rows over the moduli ``qs``) → Montgomery form v·2^32 mod q, uint64."""
    q = np.asarray(qs, np.uint64).reshape((-1,) + (1,) * (np.ndim(values) - 1))
    return (np.asarray(values, np.uint64) << np.uint64(32)) % q
