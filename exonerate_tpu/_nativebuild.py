"""Shared builder for the packaged C++ runtime components.

The native sources (sdplib.cpp, seedlib.cpp) ship inside the package;
shared objects are compiled on first use into a content-hash-keyed
cache beside the package (native/build/, or EXONERATE_TPU_NATIVE_DIR),
the runtime analogue of the reference bootstrapper's build-time archive
(ref: src/model/bootstrapper.c:199-265), so they rebuild automatically
when the source changes.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))


def _cache_dir() -> str:
    return os.environ.get("EXONERATE_TPU_NATIVE_DIR") or os.path.join(
        os.path.dirname(_PKG), "native", "build")


def build_lib(src_name: str) -> str | None:
    """Compile <package>/<src_name> to a cached .so; return its path or
    None when the toolchain is unavailable."""
    src = os.path.join(_PKG, src_name)
    try:
        with open(src, "rb") as fh:
            digest = hashlib.sha1(fh.read()).hexdigest()[:16]
    except OSError:
        return None
    stem = os.path.splitext(src_name)[0]
    so = os.path.join(_cache_dir(), f"lib{stem}-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src]
    try:
        try:
            subprocess.run(base[:2] + ["-march=native"] + base[2:],
                           check=True, capture_output=True, timeout=300)
        except subprocess.SubprocessError:
            subprocess.run(base, check=True, capture_output=True,
                           timeout=300)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
