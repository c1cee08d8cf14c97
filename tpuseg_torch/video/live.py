"""Live overlay viewer (counterpart of ``tpuseg/video/live.py``).

A pyqtgraph window with an EMA fps counter, a matplotlib ``plt.ion()``
overlay, or a headless PNG writer, picked by what is installed.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from tpuseg_torch.metrics.meters import FpsMeter


def _have(mod: str) -> bool:
    try:
        __import__(mod)
        return True
    except ImportError:
        return False


class LiveViewer:
    """Streams (frame, overlay) pairs to a window or to disk."""

    def __init__(self, backend: str | None = None, out_dir: str = "live_out"):
        if backend is None:
            if _have("pyqtgraph"):
                backend = "pyqtgraph"
            elif _have("matplotlib") and os.environ.get("DISPLAY"):
                backend = "matplotlib"
            else:
                backend = "headless"
        self.backend = backend
        self.out_dir = out_dir
        self.fps = FpsMeter()
        self._im = None

    def show(self, overlay: np.ndarray, index: int) -> float | None:
        fps = self.fps.tick()
        if self.backend == "pyqtgraph":
            self._show_pyqtgraph(overlay)
        elif self.backend == "matplotlib":
            self._show_matplotlib(overlay)
        else:
            from PIL import Image

            os.makedirs(self.out_dir, exist_ok=True)
            Image.fromarray(overlay).save(
                os.path.join(self.out_dir, f"live_{index:05d}.png")
            )
        return fps

    def _show_pyqtgraph(self, overlay):
        import pyqtgraph as pg

        if self._im is None:
            self._app = pg.mkQApp()
            self._win = pg.GraphicsLayoutWidget(title="tpuseg_torch live")
            view = self._win.addViewBox()
            view.setAspectLocked(True)
            self._im = pg.ImageItem()
            view.addItem(self._im)
            self._win.show()
        self._im.setImage(np.rot90(overlay, 3))
        self._app.processEvents()

    def _show_matplotlib(self, overlay):
        import matplotlib.pyplot as plt

        if self._im is None:
            plt.ion()
            self._fig, ax = plt.subplots()
            self._im = ax.imshow(overlay)
        else:
            self._im.set_data(overlay)
        plt.pause(0.001)


def run_live(segmenter, frames: Iterable[np.ndarray], viewer: LiveViewer,
             max_frames: int | None = None) -> dict:
    """Per-frame pump: segment the frames, display each overlay, track the
    display fps."""
    shown = 0
    result = segmenter.run(frames, max_frames=max_frames)
    for i, overlay in enumerate(result["color"]):
        fps = viewer.show(overlay, i)
        shown += 1
    result["display_fps"] = viewer.fps.fps
    result["shown"] = shown
    return result
