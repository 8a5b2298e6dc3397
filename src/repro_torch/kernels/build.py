"""Build the Hopper kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, at first use.  The library's
file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Sources that
are not built yet are compiled in parallel, one ``nvcc`` each.  Nothing
includes PyTorch's headers: a build takes seconds, not minutes.
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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "paged_decode_attention", "paged_prefill_attention", "fused_decode_tail",
           "linear_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Dict]:
    """Compile every named kernel that is not built yet, all at once.
    Returns, per kernel, the seconds its build took (0.0 when it was
    already built) and nvcc's output, which holds ptxas's report of
    registers, shared memory and spills."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {n: {"seconds": 0.0, "log": ""} for n in names}
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    failed = []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def load_variant(name: str, source: str) -> ctypes.CDLL:
    """A scratch variant of a kernel for a timing experiment: ``source``
    (CUDA C++ that may include ``csrc/``'s files by name) built into
    ``build/kernels/variants/`` and loaded, once per distinct text."""
    digest = hashlib.sha256(source.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / "variants" / f"{name}-{digest.hexdigest()[:16]}.so"
    with _LOCK:
        if str(out) not in _LIBS:
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                src = out.with_suffix(".cu")
                src.write_text(source)
                proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
                                       str(src)], capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}"
                                       f"{proc.stderr}")
            _LIBS[str(out)] = ctypes.CDLL(str(out))
        return _LIBS[str(out)]

