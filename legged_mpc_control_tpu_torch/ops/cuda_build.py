"""Build and load the package's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled with nvcc for Hopper (`sm_90a`) into a shared library under the
package's `_build/` directory (git-ignored), named by a hash of the source
and the flags so an edit rebuilds, and loaded with ctypes. Nothing is built
when the package is imported, and nothing is built on a machine that never
launches a kernel.

`LAUNCHES` counts the kernel launches of every wrapper, by kernel name: each
wrapper adds one where it launches its kernel, and nowhere else.
"""

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches: riccati_ipm (K1), substep_chain (K2),
# substep_chain_kf1 (K3), chol_factor (K4), chol_solve (K5),
# chol_solve_multi (K6), ci_sweeps (K7; its batch variant also under
# ci_sweeps_batch)
LAUNCHES = collections.Counter()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu for the current source goes."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its build exists; returns the .so path.
    The compiler's report (registers, spills) is kept beside it as .log."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if needed, loaded."""
    return ctypes.CDLL(str(build(name)))


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
