# coding: utf-8
"""
Build and load the port's hand-written CUDA kernels (``joeys2t_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/joeys2t_torch/``, named after a hash of its source so an edited
source is rebuilt and a stale library is never loaded. Libraries are loaded
with ``ctypes``. Nothing is built at import time: the first kernel launch
builds what it needs, and :func:`build_all` builds every kernel at once, one
``nvcc`` process per source, all started together.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "joeys2t_torch"
KERNELS = ("flash_attention", "decode_attention")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of joeys2t_torch cannot be built")


def _library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    # --split-compile=0: the device code's optimization passes run on as many
    # threads as the machine has (a source holds dozens of kernel
    # instantiations, and one thread compiled them one after another)
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library not yet built, all ``nvcc`` runs in parallel.

    The compiler's report (registers, shared memory, spills from
    ``-Xptxas -v``) is kept beside each library as ``.log``. Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    running = {}
    for name, path in paths.items():
        if path.is_file():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        output, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output}")
            continue
        os.replace(tmp, paths[name])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            _loaded[name] = lib
        return lib
