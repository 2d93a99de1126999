"""Build a CUDA source of the port into a shared library with ``nvcc``.

Each kernel module compiles its ``csrc/*.cu`` at first use into the
git-ignored ``build/`` beside it and loads it with ``ctypes`` (a plain C
interface: no PyTorch headers, so a build takes seconds).  The library's
name carries a hash of the source, of the headers it includes with
``#include "..."`` (and those include, in turn) and of the flags, and it
is renamed into place atomically, so concurrent builders never load a
torn file.
``nvcc``'s diagnostics (``-Xptxas -v`` where a module asks for them) are
kept beside the library as ``<name>.log``.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

#: target and language flags every kernel of the port is built with
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own lookup of the toolkit (CUDA_HOME, CUDA_PATH, defaults)
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen: dict) -> dict:
    """``path`` and the headers beside it that it includes, transitively:
    path -> text, in the order first reached."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for name in _LOCAL_INCLUDE.findall(text):
            _sources(path.parent / name.decode(), seen)
    return seen


def build_library(source: Path, build_dir: Path, flags) -> Path:
    """Compile ``source`` with ``flags`` (once per source, the headers it
    includes, and flags) and return the shared library's path."""
    text = b"".join(_sources(source, {}).values())
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    out = build_dir / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
