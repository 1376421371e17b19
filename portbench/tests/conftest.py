"""Shared pieces of the benchmark's CPU tests: a small volume and the
configuration overrides that shrink a cell to it."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a cell at a size a test holds: randompoint as the full-size blocks take
# it after the cube guard, a given budget in place of the file's size
SMALL = {"CompressFramework.Compress.sampler.name": "randompoint",
         "CompressFramework.Compress.sampler.sample_size": 256,
         "CompressFramework.Compress.param.given_size": 20000,
         "CompressFramework.Compress.param.filesize_ratio": 0}


@pytest.fixture(scope="session")
def small_volume(tmp_path_factory):
    """An 8x32x32 uint16 TIFF with the full range in it."""
    import cv2
    z, y, x = np.meshgrid(np.arange(8), np.arange(32), np.arange(32),
                          indexing="ij")
    v = (30000 + 20000 * np.sin(z / 3.0) * np.cos(y / 5.0)
         + 8000 * np.sin(x / 4.0)).astype(np.uint16)
    v[0, 0, 0], v[-1, -1, -1] = 0, 65535
    path = str(tmp_path_factory.mktemp("vol") / "vol.tif")
    assert cv2.imwritemulti(path, list(v))
    return path


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
