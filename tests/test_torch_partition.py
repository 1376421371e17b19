"""The port's volume partition (brief_pytorch_tpu_torch/partition/) against
the JAX package's, exactly: chunk lists, names and extents, boundary
volumes, byte allocations, cal_divide_num, the adaptive octree's selection
and objective, merges — on the bundled 64^3 fixture and on random volumes.
"""
import numpy as np
import pytest

from brief_pytorch_tpu.io.image import save_img as jsave_img
from brief_pytorch_tpu.partition import divide as jd
from brief_pytorch_tpu.partition import tree as jt
from brief_pytorch_tpu_torch.partition import divide as td
from brief_pytorch_tpu_torch.partition import tree as tt


def _random_volume(shape, seed):
    """Smooth blobs plus noise: uneven variance across blocks, flat
    corners for the pruning thresholds."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, s) for s in shape], indexing="ij")
    vol = np.zeros(shape)
    for _ in range(4):
        c = rng.uniform(0, 1, len(shape))
        vol += rng.uniform(500, 3000) * np.exp(-sum(
            (g - ci) ** 2 for g, ci in zip(grids, c)) / 0.02)
    vol += rng.uniform(0, 20, shape)
    return vol.astype(np.uint16)[..., None]


def _volumes(brain64):
    return {"brain64": brain64,
            "random_32x64x64": _random_volume((32, 64, 64), 0),
            "random_16x32x48": _random_volume((16, 32, 48), 1)}


def _same_chunks(a, b):
    assert [c["name"] for c in a] == [c["name"] for c in b]
    for x, y in zip(a, b):
        for k in ("d", "h", "w", "size", "total_size"):
            assert x.get(k) == y.get(k), k
        np.testing.assert_array_equal(x["data"], y["data"])


@pytest.mark.parametrize("name", ["brain64", "random_32x64x64",
                                  "random_16x32x48"])
@pytest.mark.parametrize("divide_type", ["total_2_2_2", "total_1_2_4",
                                         "every_16_16_16", "every_8_32_24"])
def test_divide_data_exact(brain64, name, divide_type):
    vol = _volumes(brain64)[name]
    jc, ji = jd.divide_data(vol, divide_type)
    tc, ti = td.divide_data(vol, divide_type)
    _same_chunks(tc, jc)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("name", ["brain64", "random_32x64x64"])
@pytest.mark.parametrize("mode", ["equal", "by_size", "by_var", "by_d",
                                  "by_dv"])
@pytest.mark.parametrize("thres", [26, 3000])
def test_alloc_param_exact(brain64, name, mode, thres):
    vol = _volumes(brain64)[name]
    jc, _ = jd.divide_data(vol, "total_2_2_2")
    tc, _ = td.divide_data(vol, "total_2_2_2")
    ja = jd.alloc_param([dict(c) for c in jc], 3e4, mode, thres)
    ta = td.alloc_param([dict(c) for c in tc], 3e4, mode, thres)
    assert [c["name"] for c in ta] == [c["name"] for c in ja]
    assert [c["param_size"] for c in ta] == [c["param_size"] for c in ja]


@pytest.mark.parametrize("dims,nb,ps", [((64, 512, 512), 4, 262144.0),
                                        ((64, 64, 64), 8, 1e5),
                                        ((30, 42, 12), -1, 2e5),
                                        ((1, 100, 60), 6, 1e4)])
def test_cal_divide_num_exact(dims, nb, ps):
    np.testing.assert_array_equal(td.cal_divide_num(*dims, nb, ps),
                                  jd.cal_divide_num(*dims, nb, ps))
    assert td.cal_factor(dims[1]) == jd.cal_factor(dims[1])


@pytest.mark.parametrize("name", ["brain64", "random_32x64x64"])
@pytest.mark.parametrize("nb,var_thr,e_thr", [(20, 0, 0), (8, -1, -1),
                                              (30, 100, 50), (3, 0, 0)])
def test_adaptive_tree_exact(brain64, tmp_path, name, nb, var_thr, e_thr):
    vol = _volumes(brain64)[name]
    path = str(tmp_path / "vol.tif")
    jsave_img(path, vol)     # the JAX package reads the file itself
    jtree, jdraw, jdim = jt.adaptive_cal_tree(path, 1e5, var_thr=var_thr,
                                              e_thr=e_thr, Nb=nb)
    ttree, tdraw, tdim = tt.adaptive_cal_tree(vol, 1e5, var_thr=var_thr,
                                              e_thr=e_thr, Nb=nb)
    geo = lambda t: [(p.z, p.y, p.x, p.d, p.h, p.w, p.level)
                     for p in t.get_active()]
    assert tdim == jdim == 3
    assert geo(ttree) == geo(jtree)
    assert ttree.objective == jtree.objective
    assert ttree.prune_count == jtree.prune_count
    np.testing.assert_array_equal(tdraw, jdraw)


@pytest.mark.parametrize("name", ["brain64", "random_16x32x48"])
def test_merge_divided_data_exact(brain64, name):
    vol = _volumes(brain64)[name]
    chunks, _ = td.divide_data(vol, "total_2_2_2")
    rng = np.random.default_rng(3)
    dec = [{"data": rng.integers(0, 65535, c["data"].shape).astype(np.uint16),
            **td.parse_chunk_name(c["name"])} for c in chunks]
    np.testing.assert_array_equal(td.merge_divided_data(dec, vol.shape),
                                  jd.merge_divided_data(dec, vol.shape))
    for c in chunks:
        assert td.parse_chunk_name(c["name"]) == jd.parse_chunk_name(c["name"])


def test_cal_feature_exact(brain64):
    for vol in _volumes(brain64).values():
        assert td.cal_feature(vol) == jd.cal_feature(vol)
        assert td.cal_feature(vol[0]) == jd.cal_feature(vol[0])
    assert td.cal_feature(np.zeros((4, 4, 4, 1))) == 0.0


def test_default_divide_chunk_names_match_jax(brain64):
    """opt/DivideTask/default.yaml's adaptive blocking and by_dv budget on
    the fixture: the same chunks, names and budgets as the JAX runner."""
    import os
    from brief_pytorch_tpu.core import config as jcfg
    from brief_pytorch_tpu.parallel import divide_runner as jdr
    from brief_pytorch_tpu_torch.core import config as tcfg
    from brief_pytorch_tpu_torch.parallel import divide_runner as tdr
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yaml = os.path.join(root, "opt", "DivideTask", "default.yaml")
    jopt = jcfg.load(yaml).CompressFramework
    topt = tcfg.load(yaml).CompressFramework
    path = os.path.join(root, jcfg.load(yaml).Dataset.data_path)
    ps = os.path.getsize(path) / 80
    jchunks, jviz = jdr.divide(jopt, brain64, path, ps)
    tchunks, tviz = tdr.divide(topt, brain64, ps)
    _same_chunks(tchunks, jchunks)
    np.testing.assert_array_equal(tviz, jviz)
    ja = jd.alloc_param(jchunks, ps, "by_dv", 26)
    ta = td.alloc_param(tchunks, ps, "by_dv", 26)
    assert [(c["name"], c["param_size"]) for c in ta] == \
        [(c["name"], c["param_size"]) for c in ja]
    assert len(ta) == 15
