"""Native threaded video decode: ctypes bindings of ``native/videodec.cpp``
(counterpart of ``tpuseg/video/native_source.py``).

libav frame-threaded decoding plus a pool of swscale workers doing BGR->RGB
and the resize, delivering frames in order through a ring buffer, off the
interpreter lock, so host decode stays out of the serving loop's way.  The
library is the port's own build (``tpuseg_torch.native_build``, at first
use); ``available()`` is False when it cannot be built (no ``g++``, no libav
or OpenCV headers), and ``tpuseg_torch.video.pipeline.FrameSource`` then
decodes with cv2 or imageio.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from tpuseg_torch.native_build import videodec_library


@functools.cache
def lib() -> ctypes.CDLL | None:
    """The decoder library with every entry point's types declared, or
    None when it cannot be built or loaded."""
    path, _reason = videodec_library()
    if path is None:
        return None
    try:
        L = ctypes.CDLL(path)
    except OSError:
        return None
    L.vdec_open.restype = ctypes.c_void_p
    L.vdec_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
    L.vdec_open2.restype = ctypes.c_void_p
    L.vdec_open2.argtypes = L.vdec_open.argtypes + [ctypes.c_int]
    L.vdec_info.restype = ctypes.c_int
    L.vdec_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_int64)]
    L.vdec_acquire.restype = ctypes.c_int64
    L.vdec_acquire.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    L.vdec_release.restype = None
    L.vdec_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    L.vdec_close.restype = None
    L.vdec_close.argtypes = [ctypes.c_void_p]
    return L


def available() -> bool:
    return lib() is not None


class NativeFrameSource:
    """Iterate uint8 frames of a video file with the native decoder: RGB
    ``(out_h, out_w, 3)`` by default, or with ``fmt="i420"`` the decoder's
    own chroma-subsampled planes packed ``(out_h*3/2, out_w)`` (for
    ``VideoSegmenter``'s yuv420 transport, with no RGB detour on the
    host).  Frames are copied out of the ring slot before it is released."""

    def __init__(self, path: str, size: tuple[int, int] | None = None,
                 decode_threads: int = 0, sws_threads: int = 4,
                 ring_capacity: int = 8, fmt: str = "rgb"):
        L = lib()
        if L is None:
            raise RuntimeError("the native video decoder could not be built: "
                               + videodec_library()[1])
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if fmt not in ("rgb", "i420"):
            raise ValueError(f"fmt must be 'rgb' or 'i420', got {fmt!r}")
        h, w = size if size is not None else (0, 0)
        self._L = L
        self.fmt = fmt
        if fmt == "i420":
            self._h = L.vdec_open2(path.encode(), int(w), int(h), int(decode_threads),
                                   int(sws_threads), int(ring_capacity), 1)
        else:
            self._h = L.vdec_open(path.encode(), int(w), int(h), int(decode_threads),
                                  int(sws_threads), int(ring_capacity))
        if not self._h:
            raise RuntimeError(
                f"vdec_open failed for {path!r}"
                + (" (i420 needs h%4==0 and w%2==0)" if fmt == "i420" else ""))
        cw, ch = ctypes.c_int(), ctypes.c_int()
        fps, nf = ctypes.c_double(), ctypes.c_int64()
        L.vdec_info(self._h, ctypes.byref(cw), ctypes.byref(ch),
                    ctypes.byref(fps), ctypes.byref(nf))
        self.width, self.height = cw.value, ch.value
        self.fps, self.nframes = fps.value, nf.value

    def __iter__(self):
        if self.fmt == "i420":
            nbytes = self.height * self.width * 3 // 2
            shape = (self.height * 3 // 2, self.width)
        else:
            nbytes = self.height * self.width * 3
            shape = (self.height, self.width, 3)
        while True:
            ptr = ctypes.POINTER(ctypes.c_uint8)()
            seq = self._L.vdec_acquire(self._h, ctypes.byref(ptr))
            if seq < 0:
                break
            try:
                buf = np.ctypeslib.as_array(ptr, shape=(nbytes,))
                yield buf.reshape(shape).copy()
            finally:
                self._L.vdec_release(self._h, seq)

    def close(self):
        if getattr(self, "_h", None):
            self._L.vdec_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
