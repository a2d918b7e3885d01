"""Build and load the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C interface; what several
share sits in ``csrc/*.cuh`` headers. At first use it is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``build/torch_kernels/``
at the repository root, named by a hash of its source, the headers and the
flags (an edited source or header builds anew; an unchanged one loads the
library already built), and loaded with ``ctypes``. Nothing here runs when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
#: Libraries built or loaded in this process: a frame of the engine's
#: goodput ledger during which it grew paid for a build or a load
#: (``compile``), not for device work (``models/serving.py::_led_device``).
loads = 0
#: What nvcc printed for each source built in this process: with
#: ``-Xptxas=-v``, every kernel's registers, shared memory and spills.
reports: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/{name}.cu`` lands, keyed by its hash."""
    source = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(path.read_bytes() for path in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` unless its hashed library exists."""
    target = library_path(name)
    if target.is_file():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private file, then rename: concurrent builders never load
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        result = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if result.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu:\n{result.stdout}{result.stderr}"
            )
        reports[name] = result.stdout + result.stderr
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    global loads
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
        loads += 1
    return _loaded[name]
