"""ids agreement of int8 serving with the int8 stem against int8 serving
without it, in tpuseg on the CPU: DRN-D-22 with seed-0 weights, both
calibrated on 8 shapes frames of seed 0 and run on those frames, at each
size given.  chip_smoke.py's phase 21 floor (INT8_STEM_MIN) is set from it.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/int8_stem_agreement.py \\
        128x256 256x512 512x1024

Prints one JSON line per size and dtype (bf16, then f32).  512x1024 takes
about 15 minutes a dtype on 4 CPU threads.
"""

import json
import sys
import time

import jax.numpy as jnp
import numpy as np

from tpuseg.data.shapes import shapes_video
from tpuseg.models import init_drnseg
from tpuseg.video.pipeline import VideoSegmenter

MEAN, STD = [0.290, 0.328, 0.287], [0.183, 0.187, 0.184]


def main(sizes):
    params, state, spec = init_drnseg(0, "drn_d_22", 19)
    for size in sizes:
        frames = list(shapes_video(8, size, seed=0)[0])
        for dtype, name in ((jnp.bfloat16, "bf16"), (None, "f32")):
            t0 = time.time()
            ids = {}
            for stem in (False, True):
                seg = VideoSegmenter(params, state, spec, MEAN, STD, compute_dtype=dtype,
                                     batch=4, quantize=True, quantize_stem=stem,
                                     calib_frames=frames)
                ids[stem] = np.asarray(seg.run(frames, warmup=False, need_color=False)["ids"])
            print(json.dumps({"size": list(size), "dtype": name,
                              "stem_vs_no_stem": float((ids[True] == ids[False]).mean()),
                              "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main([tuple(int(v) for v in a.split("x")) for a in sys.argv[1:]])
