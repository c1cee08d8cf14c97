"""Build the native video decoder at first use (the port's copy of
``tpuseg/native_build.py``'s ``build_videodec``).

``native/videodec.cpp`` (libav frame-threaded decode, a swscale / cv::resize
worker pool and an in-order ring buffer) compiles with ``g++`` into
``tpuseg_torch/_build/`` under a name keyed by a hash of the source and the
command, built to a temporary name and moved into place with
``os.replace``, so concurrent builds never load a half-written file.
``tpuseg``'s own ``native/libtpuseg_videodec.so`` is never loaded.

    python -m tpuseg_torch.native_build     # build now, print the command
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
VIDEODEC_SRC = os.path.join(os.path.dirname(PKG_DIR), "native", "videodec.cpp")
# tpuseg/native_build.py:29-49's command, output and source filled in
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-I/usr/include/opencv4")
_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lopencv_core",
         "-lopencv_imgproc")


def videodec_path(src: str = VIDEODEC_SRC, build_dir: str = BUILD_DIR) -> str:
    """Where the decoder library for the current source and command lives."""
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir, f"libtpuseg_videodec_{h.hexdigest()[:16]}.so")


def build_videodec(src: str = VIDEODEC_SRC, build_dir: str = BUILD_DIR,
                   verbose: bool = False) -> str:
    """Compile the decoder unless the keyed library exists; returns its
    path.  Raises ``RuntimeError`` with ``g++``'s output when ``g++``, the
    source, the libav headers or OpenCV's headers are missing."""
    if not os.path.exists(src):
        raise RuntimeError(f"{src} not found")
    out = videodec_path(src, build_dir)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp_dir:
        tmp = os.path.join(tmp_dir, "libvideodec.so")
        cmd = [gxx, *_FLAGS, "-o", tmp, src, *_LIBS]
        if verbose:
            print(" ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"videodec build failed ({proc.returncode}; missing libav or "
                               f"OpenCV headers?):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.cache
def videodec_library() -> tuple[str | None, str]:
    """``(path, "")`` once the decoder is built, else ``(None, reason)``;
    decided once a process."""
    try:
        return build_videodec(), ""
    except RuntimeError as e:
        return None, str(e)


if __name__ == "__main__":
    print(build_videodec(verbose=True))
    sys.exit(0)
