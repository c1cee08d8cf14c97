"""Build the port's native C++ libraries at first use (the port's copy of
``tpuseg/native_build.py``).

- ``native/sparsity.cpp`` (host-side mask generation and BSR packing, bound
  by ``tpuseg_torch.native``);
- ``native/videodec.cpp`` (libav frame-threaded decode, a swscale /
  cv::resize worker pool and an in-order ring buffer, bound by
  ``tpuseg_torch.video.native_source``).

Each compiles with ``g++`` into ``tpuseg_torch/_build/`` under a name keyed
by a hash of the source and the command, built to a temporary name and
moved into place with ``os.replace``, so concurrent builds never load a
half-written file.  ``tpuseg``'s own ``native/*.so`` are never loaded: its
tests rebuild them in place.

    python -m tpuseg_torch.native_build     # build both now, print the commands
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
SPARSITY_SRC = os.path.join(NATIVE_DIR, "sparsity.cpp")
VIDEODEC_SRC = os.path.join(NATIVE_DIR, "videodec.cpp")
# tpuseg/native_build.py:15-49's commands, output and source filled in
_SPARSITY_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-I/usr/include/opencv4")
_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lopencv_core",
         "-lopencv_imgproc")


def _keyed_path(stem: str, src: str, flags: tuple, libs: tuple, build_dir: str) -> str:
    h = hashlib.sha256(" ".join(flags + libs).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _build(stem: str, src: str, flags: tuple, libs: tuple, build_dir: str, verbose: bool,
           hint: str) -> str:
    """Compile ``src`` unless its keyed library exists; returns its path.
    Raises ``RuntimeError`` with ``g++``'s output when ``g++`` or the source
    is missing or the compile fails."""
    if not os.path.exists(src):
        raise RuntimeError(f"{src} not found")
    out = _keyed_path(stem, src, flags, libs, build_dir)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp_dir:
        tmp = os.path.join(tmp_dir, f"lib{stem}.so")
        cmd = [gxx, *flags, "-o", tmp, src, *libs]
        if verbose:
            print(" ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{stem} build failed ({proc.returncode}{hint}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def sparsity_path(src: str = SPARSITY_SRC, build_dir: str = BUILD_DIR) -> str:
    """Where the sparsity library for the current source and command lives."""
    return _keyed_path("tpuseg_sparsity", src, _SPARSITY_FLAGS, (), build_dir)


def build_sparsity(src: str = SPARSITY_SRC, build_dir: str = BUILD_DIR,
                   verbose: bool = False) -> str:
    """Compile ``native/sparsity.cpp`` unless the keyed library exists;
    returns its path.  Raises ``RuntimeError`` with ``g++``'s output."""
    return _build("tpuseg_sparsity", src, _SPARSITY_FLAGS, (), build_dir, verbose, "")


def videodec_path(src: str = VIDEODEC_SRC, build_dir: str = BUILD_DIR) -> str:
    """Where the decoder library for the current source and command lives."""
    return _keyed_path("tpuseg_videodec", src, _FLAGS, _LIBS, build_dir)


def build_videodec(src: str = VIDEODEC_SRC, build_dir: str = BUILD_DIR,
                   verbose: bool = False) -> str:
    """Compile the decoder unless the keyed library exists; returns its
    path.  Raises ``RuntimeError`` with ``g++``'s output when ``g++``, the
    source, the libav headers or OpenCV's headers are missing."""
    return _build("tpuseg_videodec", src, _FLAGS, _LIBS, build_dir, verbose,
                  "; missing libav or OpenCV headers?")


@functools.cache
def videodec_library() -> tuple[str | None, str]:
    """``(path, "")`` once the decoder is built, else ``(None, reason)``;
    decided once a process."""
    try:
        return build_videodec(), ""
    except RuntimeError as e:
        return None, str(e)


if __name__ == "__main__":
    print(build_sparsity(verbose=True))
    print(build_videodec(verbose=True))
    sys.exit(0)
