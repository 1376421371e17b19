"""The port's deblocking filter (brief_pytorch_tpu_torch/post/deblock.py)
against the JAX package's (brief_pytorch_tpu/post/deblock.py, which
tests/test_deblock.py holds bit-identical to native/deblock.cpp): the
same block names give the same boundary lines, the same windows the same
filtered samples, the same 2-D images and 3-D volumes the same output bit
for bit, and the -stp CLI writes the same TIFF.  Integer arithmetic on
both sides: no tolerance.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from brief_pytorch_tpu.io.image import read_img as jread
from brief_pytorch_tpu.post import deblock as jdb
from brief_pytorch_tpu_torch.io.image import read_img, save_img
from brief_pytorch_tpu_torch.post import deblock as tdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blocky(rng, shape, step, base=1000, jump=60):
    """A smooth ramp with per-block DC offsets: strong block edges."""
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    vol = base + sum((2 + i) * g for i, g in enumerate(grids[::-1]))
    offs = rng.integers(-jump, jump, tuple(-(-n // step) for n in shape))
    for axis in range(len(shape)):
        offs = np.repeat(offs, step, axis)
    vol = vol + offs[tuple(slice(0, n) for n in shape)]
    return np.clip(vol, 0, 65535).astype(np.uint16)


def _names(shape, step):
    """Chunk names of a regular grid of step-sized blocks (inclusive
    extents), 'h_..-w_..' for 2-D, 'd_..-h_..-w_..' for 3-D."""
    axes = "dhw"[-len(shape):]
    ranges = [[(a, min(a + step, n) - 1) for a in range(0, n, step)]
              for n in shape]
    out = [[]]
    for ax, rs in zip(axes, ranges):
        out = [o + [f"{ax}_{a}_{b}"] for o in out for a, b in rs]
    return ["-".join(o) for o in out]


NAME_CASES = [
    ["h_0_15-w_0_15", "h_0_15-w_16_31"],
    ["h_0_15-w_0_15", "h_0_15-w_16_31", "h_0_15-w_0_15"],
    _names((24, 40), 8),
    ["d_0_3-h_0_7-w_0_7"],
    ["d_0_3-h_0_7-w_0_7", "d_0_3-h_0_7-w_8_15", "d_0_3-h_0_7-w_0_7"],
    _names((16, 32, 32), 8),
    ["d_0_31-h_0_255-w_0_255", "d_0_31-h_0_255-w_256_511",
     "d_32_63-h_256_511-w_0_255"],
]


@pytest.mark.parametrize("names", NAME_CASES, ids=range(len(NAME_CASES)))
def test_block_names_give_the_same_lines(names):
    collect = "collect_lines_3d" if names[0].startswith("d_") \
        else "collect_lines_2d"
    assert getattr(tdb, collect)(names) == getattr(jdb, collect)(names)


@pytest.mark.parametrize("index_a,index_b,thres", [
    (51, 2000, 65535), (40, 30, 65535), (51, 2000, 20000), (20, 10, 1500)])
def test_windows_filter_alike(index_a, index_b, thres):
    rng = np.random.default_rng(int(index_a + index_b))
    win = rng.integers(0, 3000, (4096, 6))
    win[::3] += np.arange(6) * rng.integers(0, 60, (1366, 1))
    out = tdb.filter_line_windows(win, index_a, index_b, thres)
    assert out.dtype == np.int64
    np.testing.assert_array_equal(
        out, jdb.filter_line_windows(win, index_a, index_b, thres))


@pytest.mark.parametrize("shape,step,channels", [
    ((32, 48), 8, 1), ((40, 24), 12, 2), ((16, 32, 32), 8, 1),
    ((12, 20, 28), 6, 1), ((8, 16, 16), 8, 2)])
def test_images_and_volumes_are_bit_identical(shape, step, channels):
    rng = np.random.default_rng(sum(shape) + step)
    img = np.stack([_blocky(rng, shape, step) for _ in range(channels)], -1)
    names = _names(shape, step)
    got = tdb.deblock_image(img.copy(), names, 51, 2000, 65535)
    want = jdb.deblock_image(img.copy(), names, 51, 2000, 65535)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


def test_unsupported_rank_raises():
    with pytest.raises(NotImplementedError):
        tdb.deblock_image(np.zeros((4, 4), np.uint16), [], 51, 2000, 65535)


def _step_dir(root, vol, names):
    """The step-dir layout of a DivideTask checkpoint: the merged volume
    under decompressed/, one compressed/module/<chunk>/ per block."""
    step = root / "steps100"
    (step / "decompressed").mkdir(parents=True)
    for n in names:
        (step / "compressed" / "module" / n).mkdir(parents=True)
    save_img(str(step / "decompressed" / "vol_decompressed.tif"), vol)
    return step


def test_stp_cli_writes_the_jax_tools_tiff(tmp_path):
    """python -m brief_pytorch_tpu_torch.post.deblock -stp <step dir>
    writes deblock/<name>_deblocked_python.tif, equal bit for bit to the
    JAX tool's output on a copy of the same step dir."""
    rng = np.random.default_rng(7)
    vol = _blocky(rng, (16, 32, 32), 8)
    names = _names((16, 32, 32), 8)
    port = _step_dir(tmp_path / "port", vol, names)
    jax_dir = tmp_path / "jax"
    shutil.copytree(tmp_path / "port", jax_dir)
    p = subprocess.run([sys.executable, "-m",
                        "brief_pytorch_tpu_torch.post.deblock", "-stp",
                        str(port)], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    want = jdb.main(str(jax_dir / "steps100"))
    got = port / "deblock" / os.path.basename(want)
    assert os.path.basename(want) == "vol_decompressed_deblocked_python.tif"
    out = read_img(str(got))
    np.testing.assert_array_equal(out, jread(want))
    assert out.shape == (16, 32, 32, 1) and out.dtype == np.uint16
    assert (out[..., 0] != vol).any()
    assert tdb.main(str(port)) == str(got)
