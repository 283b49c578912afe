"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/repro_torch/<hash>/lib<name>.so`` at the root of
the checkout, keyed by a hash of the sources and the compiler command, and
is built at first use.  A missing ``nvcc`` or a failed build raises.
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
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit's."""
    path = shutil.which("nvcc") or TOOLKIT_NVCC
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found on PATH or at {TOOLKIT_NVCC}; the port's CUDA "
            f"kernels cannot be built")
    return path


def nvcc_command(source: Path, output: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def _library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the bytes of every
    source under ``csrc/`` (headers included) and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` each, all started together.  Returns the
    library path of each name; raises if any build fails."""
    if names is None:
        names = sorted(f.stem for f in CSRC.glob("*.cu"))
    libs = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    for n, lib in todo.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = nvcc_command(CSRC / f"{n}.cu", Path(tmp), nvcc)
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    Path(tmp), cmd)
    failed = []
    for n, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, libs[n])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
