"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``_build/<name>-<hash>.so``, compiled by ``nvcc`` for ``sm_90a`` at
first use and loaded with ``ctypes``. The hash covers every file of
``csrc/`` and the compiler flags, so an edit rebuilds. :func:`build_all`
starts one ``nvcc`` per source, all at once, so that a cold start pays the
slowest file and not the sum.

A failed build raises with the compiler's output. Nothing here runs when the
package is imported, so machines without ``nvcc`` or a card can import it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# compiler output of the last successful build of each source (ptxas -v:
# registers, shared memory, spills)
build_log: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernels' sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of pyaudiodsptools_tpu_torch are compiled at first use and "
        "need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together. Returns name -> path."""
    names = sources() if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, cmd, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"$ {' '.join(cmd)}\n{out}")
        else:
            build_log[name] = out
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            # a cold start builds every kernel at once, in parallel
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


_launchers: dict[tuple[str, str], object] = {}


def launcher(source: str, name: str, argtypes: list):
    """The C function ``name`` of ``csrc/<source>.cu`` (returns the CUDA
    error code as an int) with its argument types set, looked up once: a
    streaming step calls it block after block."""
    fn = _launchers.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _launchers[(source, name)] = fn
    return fn


_SAME_DEVICE = contextlib.nullcontext()


def on_device(device):
    """A context in which the CUDA ``device`` (a ``torch.device``) is the
    current one, as a launch needs: nothing to enter where it already is,
    which is what a streaming step meets block after block."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)
