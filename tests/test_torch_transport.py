"""Port parity for the transport options: id packing (``ops/idpack.py``),
I420 (``video/yuv.py``, K8's plain version), the device resize
(``target_size``), ``device_outputs`` with the overlay, and the CLI's
ids-pack policy, against ``tpuseg`` on the same numpy-seeded inputs,
weights and frames (f32, CPU)."""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.cli import seg_video as j_cli
from tpuseg.models.drnseg import init_drnseg as j_init
from tpuseg.ops import idpack as jpack
from tpuseg.video import yuv as jyuv
from tpuseg.video.pipeline import VideoSegmenter as JSegmenter
from tpuseg_torch.cli import seg_video as t_cli
from tpuseg_torch.models.drnseg import init_drnseg
from tpuseg_torch.ops import idpack
from tpuseg_torch.video import yuv
from tpuseg_torch.video.pipeline import VideoSegmenter as TSegmenter
from tpuseg_torch.video.pipeline import resize_frames

torch.set_num_threads(2)

MEAN = [0.290, 0.328, 0.287]
STD = [0.183, 0.187, 0.184]


def _segmenters(**kw):
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    jp, js, jspec = j_init(0, "drn_d_22", 19)
    return (TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", compute_dtype=torch.float32,
                       **kw),
            JSegmenter(jp, js, jspec, MEAN, STD, compute_dtype=None, **kw))


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_ids_bit_equal_and_round_trip(bits):
    """pack_ids equals tpuseg's bit for bit on (2, 3, 64) ids < 2**bits
    (the extremes included); unpack_ids inverts it and equals tpuseg's."""
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 2 ** bits, size=(2, 3, 64)).astype(np.uint8)
    ids[0, 0] = 2 ** bits - 1
    ids[0, 1] = 0
    got = idpack.pack_ids(torch.from_numpy(ids), bits).numpy()
    want = np.asarray(jpack.pack_ids(jnp.asarray(ids), bits))
    assert got.shape == (2, 3, idpack.packed_width(64, bits)) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(idpack.unpack_ids(got, bits), ids)
    np.testing.assert_array_equal(idpack.unpack_ids(got, bits), jpack.unpack_ids(want, bits))


def test_pack_ids_checks():
    with pytest.raises(ValueError, match="multiple of 8"):
        idpack.pack_ids(torch.zeros((1, 12), dtype=torch.uint8), 5)
    with pytest.raises(ValueError, match="1..8"):
        idpack.pack_ids(torch.zeros((1, 16), dtype=torch.uint8), 0)
    with pytest.raises(TypeError, match="uint8"):
        idpack.pack_ids(torch.zeros((1, 16), dtype=torch.int32), 5)


def test_rgb_to_i420_equal():
    f = np.stack(_frames(3, 16, 24, seed=1))
    f[0], f[1, :8] = 0, 255
    np.testing.assert_array_equal(yuv.rgb_to_i420(f), jyuv.rgb_to_i420(f))
    np.testing.assert_array_equal(yuv.rgb_to_i420(f[0]), jyuv.rgb_to_i420(f[0]))
    assert yuv.i420_geometry(24) == 16
    with pytest.raises(ValueError, match="H%4"):
        yuv.rgb_to_i420(np.zeros((1, 6, 8, 3), np.uint8))


def _k8_loop(x):
    """K8's arithmetic in numpy f32, in the kernel's order: each product and
    sum rounded on its own, rint (half to even), clip."""
    b, rows, w = x.shape
    h = rows * 2 // 3
    f32 = np.float32
    y = x[:, :h].astype(f32)
    u = x[:, h:h + h // 4].reshape(b, h // 2, w // 2).astype(f32) - f32(128)
    v = x[:, h + h // 4:].reshape(b, h // 2, w // 2).astype(f32) - f32(128)
    u = u.repeat(2, 1).repeat(2, 2)
    v = v.repeat(2, 1).repeat(2, 2)
    r = y + f32(1.402) * v
    g = (y - f32(0.344136) * u) - f32(0.714136) * v
    bl = y + f32(1.772) * u
    rgb = np.clip(np.rint(np.stack([r, g, bl], -1)), 0, 255).astype(np.uint8)
    return rgb.reshape(b, h, w * 3)


@pytest.mark.parametrize("case", ["encoded", "random", "extremes", "sweep"])
def test_i420_to_rgb_bit_equal(case):
    """K8's plain version equals tpuseg.video.yuv.i420_to_rgb_flat bit for
    bit, and so does the kernel's arithmetic: encoded frames, random
    planes, all-0 and all-255 planes, and every (U, V) pair at 8 luma
    levels."""
    rng = np.random.default_rng(2)
    if case == "encoded":
        x = jyuv.rgb_to_i420(np.stack(_frames(2, 32, 48, seed=3)))
    elif case == "random":
        x = rng.integers(0, 256, size=(3, 48, 40), dtype=np.uint8)
    elif case == "extremes":
        x = np.stack([np.zeros((24, 16), np.uint8), np.full((24, 16), 255, np.uint8)])
    else:
        # U and V planes of 128x128 pixels cover all 256 x 256 pairs: each
        # chroma sample feeds a 2x2 block
        uv = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
        x = np.empty((8, 768, 512), np.uint8)
        for i, yl in enumerate(np.linspace(0, 255, 8).astype(np.uint8)):
            x[i, :512] = yl
            x[i, 512:640] = uv[..., 0].reshape(128, 512)
            x[i, 640:] = uv[..., 1].reshape(128, 512)
    got = yuv.i420_to_rgb_flat(torch.from_numpy(x)).numpy()
    want = np.asarray(jyuv.i420_to_rgb_flat(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_k8_loop(x), want)


def test_i420_wrapper_checks_and_counts_no_cpu_launch():
    yuv.i420_to_rgb_flat.launches = 0
    yuv.i420_to_rgb_flat(torch.zeros((1, 12, 8), dtype=torch.uint8))
    assert yuv.i420_to_rgb_flat.launches == 0
    with pytest.raises(ValueError, match="I420"):
        yuv.i420_to_rgb_flat(torch.zeros((1, 13, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        yuv.i420_to_rgb_flat(torch.zeros((1, 12, 8)))


def _jax_resize(frames, size):
    """tpuseg's resize_frames (pipeline.py:434-455) on (B, h, w, 3)."""
    th, tw = size
    x = jax.image.resize(jnp.asarray(frames, jnp.float32), (frames.shape[0], th, tw, 3),
                         method="bilinear", antialias=False)
    return np.asarray(jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8))


@pytest.mark.parametrize("decode,target,share", [
    ((64, 64), (128, 128), 1.0),      # up x2: equal
    ((48, 80), (128, 256), 1.0),      # up, non-integer scale: equal
    ((128, 128), (64, 96), 0.999),    # down: 1 LSB apart on 0.076 % of the values
    ((90, 160), (64, 128), 0.999),
    ((512, 1024), (1024, 2048), 1.0),  # chip_smoke.py phase 29's resize
])
def test_device_resize_within_one_lsb(decode, target, share):
    """resize_frames against tpuseg's device resize: never more than 1 LSB
    apart, equal on at least ``share`` of the values (measured: all of them
    up and at 90x160 -> 64x128; 0.99924 at 128x128 -> 64x96, where
    PyTorch's and XLA's f32 weights of the downscale round differently)."""
    f = np.stack(_frames(2, *decode, seed=4))
    got = resize_frames(torch.from_numpy(f.reshape(2, decode[0], -1)), target).numpy()
    want = _jax_resize(f, target).reshape(2, target[0], -1)
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and (d == 0).mean() >= share, (d.max(), (d == 0).mean())


def test_segmenter_yuv420_equals_tpuseg():
    """transport="yuv420" at 64x64: the same ids as tpuseg's, and I420
    ships 1.5 bytes a pixel."""
    frames = _frames(4, 64, 64, seed=5)
    tseg, jseg = _segmenters(batch=2, transport="yuv420")
    out = tseg.run(frames, need_color=False)
    ref = np.asarray(jseg.run(frames, warmup=False, need_color=False)["ids"])
    np.testing.assert_array_equal(out["ids"], ref)
    assert out["h2d_bytes"] == 4 * 64 * 64 * 3 // 2


def test_segmenter_device_resize_and_packed_ids():
    """Decode 40x48 frames -> target 64x64 on the device, ids packed to 5
    bits, yuv420: ids equal tpuseg's (the upscale is exact), the packed fetch
    is 5/8 of the bytes and unpacks to the unpacked run's ids; the transport
    ships 1.5 bytes a pixel at decode size."""
    frames = _frames(4, 40, 48, seed=6)
    kw = dict(batch=2, target_size=(64, 64), transport="yuv420")
    tseg, jseg = _segmenters(ids_bits=5, **kw)
    out = tseg.run(frames, need_color=False)
    ref = np.asarray(jseg.run(frames, warmup=False, need_color=False)["ids"])
    assert out["ids"].shape == (4, 64, 64)
    np.testing.assert_array_equal(out["ids"], ref)
    plain, _ = _segmenters(**kw)
    unpacked = plain.run(frames, need_color=False)
    np.testing.assert_array_equal(unpacked["ids"], out["ids"])
    assert out["d2h_bytes"] * 8 == unpacked["d2h_bytes"] * 5
    assert out["h2d_bytes"] == 4 * 40 * 48 * 3 // 2


@pytest.mark.parametrize("decode", [(64, 64), (40, 48)])
def test_device_outputs_overlay_equals_tpuseg(decode):
    """device_outputs with the overlay: tpuseg's device color and overlay
    (frames resized to 64x64 when decoded smaller).  At the serving size the
    host reconstruction (ids-only fetch) gives the same images; after a
    device resize the host blend uses PIL's resize, as tpuseg's does, and
    differs from the device one."""
    frames = _frames(4, *decode, seed=7)
    for overlay in (False, True):
        kw = dict(batch=2, target_size=(64, 64), device_outputs=True, want_overlay=overlay)
        tseg, jseg = _segmenters(**kw)
        out = tseg.run(frames)
        ref = jseg.run(frames, warmup=False)
        assert out["color"].shape == (4, 64, 64, 3)
        np.testing.assert_array_equal(out["ids"], np.asarray(ref["ids"]))
        np.testing.assert_array_equal(out["color"], np.asarray(ref["color"]))
        host, jhost = _segmenters(batch=2, target_size=(64, 64), want_overlay=overlay)
        host_out = host.run(frames)
        np.testing.assert_array_equal(host_out["color"],
                                      np.asarray(jhost.run(frames, warmup=False)["color"]))
        if decode == (64, 64) or not overlay:
            np.testing.assert_array_equal(host_out["color"], out["color"])


def test_calibration_frames_take_the_device_resize():
    """quantize + calib_frames at decode size with target_size: the static
    scales equal those of a segmenter calibrated on the frames resize_frames
    gives (tpuseg pipeline.py:295-308)."""
    frames = _frames(2, 40, 48, seed=8)
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    kw = dict(device="cpu", compute_dtype=torch.float32, batch=2, quantize=True)
    seg = TSegmenter(tp, ts, tspec, MEAN, STD, target_size=(64, 64), calib_frames=frames, **kw)
    resized = resize_frames(torch.from_numpy(np.stack(frames).reshape(2, 40, -1)), (64, 64))
    ref = TSegmenter(tp, ts, tspec, MEAN, STD,
                     calib_frames=list(resized.numpy().reshape(2, 64, 64, 3)), **kw)
    assert {n: p.x_scale for n, p in seg.exec_plans.items()} == \
        {n: p.x_scale for n, p in ref.exec_plans.items()}


def test_ids_bits_checks():
    tp, ts, tspec = init_drnseg(0, "drn_d_22", 19)
    with pytest.raises(ValueError, match="cannot hold 19 classes"):
        TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", ids_bits=4)
    with pytest.raises(ValueError, match="transport"):
        TSegmenter(tp, ts, tspec, MEAN, STD, device="cpu", transport="nv12")


@pytest.mark.parametrize("ids_pack,device_outputs,w,classes", [
    (None, False, 128, 19), (None, True, 128, 19), (None, False, 132, 19),
    (None, False, 128, 33), (None, False, 128, 2), (0, False, 128, 19), (8, False, 128, 19),
    (4, False, 128, 16),
])
def test_ids_pack_policy_matches_tpuseg(capsys, ids_pack, device_outputs, w, classes):
    """The CLI's --ids-pack policy and its ids_pack_auto event equal
    tpuseg's (tpuseg/cli/seg_video.py:242-258)."""
    args = types.SimpleNamespace(ids_pack=ids_pack, device_outputs=device_outputs,
                                 classes=classes)
    got = t_cli._resolve_ids_pack(args, w)
    got_out = capsys.readouterr().out
    want = j_cli._resolve_ids_pack(args, w)
    want_out = capsys.readouterr().out
    assert got == want and got_out == want_out
    if got_out:
        assert json.loads(got_out) == {"event": "ids_pack_auto", "bits": got, "classes": classes}


def test_run_live_headless_matches_tpuseg(tmp_path):
    """video/live.py's headless viewer writes each overlay as a PNG, as
    tpuseg's does, and run_live reports what it showed."""
    from PIL import Image

    from tpuseg.video.live import LiveViewer as JViewer
    from tpuseg.video.live import run_live as j_run_live
    from tpuseg_torch.video.live import LiveViewer, run_live

    frames = _frames(3, 32, 32, seed=9)
    tseg, jseg = _segmenters(batch=2, want_overlay=True)
    out = run_live(tseg, frames, LiveViewer(backend="headless", out_dir=str(tmp_path / "t")))
    ref = j_run_live(jseg, frames, JViewer(backend="headless", out_dir=str(tmp_path / "j")))
    assert out["shown"] == ref["shown"] == 3 and out["display_fps"] is not None
    for i in range(3):
        got = np.asarray(Image.open(tmp_path / "t" / f"live_{i:05d}.png"))
        want = np.asarray(Image.open(tmp_path / "j" / f"live_{i:05d}.png"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, out["color"][i])
