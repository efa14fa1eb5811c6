"""Build the native host libraries of ``native/csrc/`` with g++ and load them.

Each ``csrc/<name>.cpp`` exports plain C functions (no Python headers), so
``g++`` builds it in a few seconds; it links libpng, libjpeg and zlib,
whose development headers (``png.h``, ``jpeglib.h``) the build needs. The
library goes into ``efficientdepthestimation_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt. A build writes a file of its own process and thread and
renames it into place (``os.replace``), so a process never loads a library
that another one is still writing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Callable

__all__ = ["CSRC_DIR", "BUILD_DIR", "GXX_FLAGS", "LIBS", "target", "build",
           "headers", "Library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")


def target(name: str) -> Path:
    """Where the library of ``csrc/<name>.cpp`` is built."""
    src = CSRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cpp`` unless its library is there (or
    ``force``); return the library's path. Raises RuntimeError with the
    compiler's message if the compile fails or there is no ``g++``."""
    so = target(name)
    if so.exists() and not force:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(
        f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(CSRC_DIR / f"{name}.cpp"), "-o", str(tmp),
           *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"g++ not found: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def headers() -> dict[str, bool]:
    """Whether ``g++`` finds each header the libraries include."""
    found = {}
    for header in ("png.h", "jpeglib.h"):
        try:
            proc = subprocess.run(
                ["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                input=f"#include <{header}>\n", capture_output=True,
                text=True)
        except FileNotFoundError:
            found[header] = False
        else:
            found[header] = proc.returncode == 0
    return found


class Library:
    """One native library, built and loaded at its first use.

    ``declare(lib)`` sets the ``argtypes`` and ``restype`` of its
    functions. If the build or the load fails, ``get()`` returns None from
    then on and ``error`` holds the message (also issued as a warning), so
    callers take their PIL or cv2 route, as the JAX package's do."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self._declare = declare
        self._lock = threading.Lock()
        self._lib = None
        self.error: str | None = None

    def build(self, force: bool = False) -> str | None:
        """The library's path, compiled if needed; None if that failed."""
        with self._lock:
            return self._build(force)

    def _build(self, force: bool) -> str | None:
        try:
            return str(build(self.name, force))
        except (RuntimeError, OSError) as exc:  # OSError: _build unwritable
            self.error = str(exc)
            warnings.warn(f"native {self.name} build failed: "
                          f"{self.error[:500]}")
            return None

    def get(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is None and self.error is None:
                path = self._build(False)
                if path is not None:
                    try:
                        lib = ctypes.CDLL(path)
                    except OSError as exc:
                        self.error = str(exc)
                        warnings.warn(f"native {self.name} load failed: "
                                      f"{self.error[:500]}")
                    else:
                        self._declare(lib)
                        self._lib = lib
            return self._lib
