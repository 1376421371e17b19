"""The port's initial SIREN weights follow the JAX package's distribution,
layer by layer (models/phi.py init_linear against brief_pytorch_tpu's).

Over SEEDS seeds of the SIREN 5 x 17 with two coordinates that
tests/test_torch_media.py and scripts/init_spread_2d.py train, each
layer's weights and biases pooled across seeds: the two-sample
Kolmogorov-Smirnov statistic between the packages is below the
alpha = 0.001 critical value 1.95 * sqrt((n + m) / (n m)), and each
package's sample against the uniform law U(-bound, bound) of its layer
(first layer 1/fan_in, hidden sqrt(6/fan_in)/30, biases 1/sqrt(fan_in))
as well.
"""
import math

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from brief_pytorch_tpu.models import phi as jphi
from brief_pytorch_tpu_torch.models import phi as tphi

SEEDS = 200
CFG = {"name": "SIREN", "coords_channel": 2, "data_channel": 1,
       "features": 17, "layers": 5, "w0": 20}


def _critical(n: int, m: int) -> float:
    return 1.95 * math.sqrt((n + m) / (n * m))


@pytest.fixture(scope="module")
def samples():
    """{(layer, 'w' | 'b'): (port values, JAX values)} pooled over seeds."""
    jnet, tnet = jphi.init_phi(dict(CFG)), tphi.init_phi(dict(CFG))
    pooled = {}
    for seed in range(SEEDS):
        jp = jnet.init(jax.random.PRNGKey(seed))["layers"]
        tp = tnet.init(torch.Generator().manual_seed(seed))["layers"]
        for i, (a, b) in enumerate(zip(tp, jp)):
            for k in ("w", "b"):
                pooled.setdefault((i, k), ([], []))
                pooled[(i, k)][0].append(a[k].numpy().ravel())
                pooled[(i, k)][1].append(np.asarray(b[k]).ravel())
    return {key: (np.concatenate(p), np.concatenate(j))
            for key, (p, j) in pooled.items()}


def _bound(layer: int, kind: str) -> float:
    fan_in = CFG["coords_channel"] if layer == 0 else CFG["features"]
    if kind == "b":
        return 1 / math.sqrt(fan_in)
    return 1 / fan_in if layer == 0 else math.sqrt(6 / fan_in) / 30


@pytest.mark.parametrize("layer", range(CFG["layers"]))
@pytest.mark.parametrize("kind", ["w", "b"])
def test_initial_weights_share_the_jax_distribution(samples, layer, kind):
    port, ref = samples[(layer, kind)]
    assert port.shape == ref.shape
    d = stats.ks_2samp(port, ref).statistic
    assert d < _critical(len(port), len(ref)), (layer, kind, d)
    bound = _bound(layer, kind)
    law = stats.uniform(loc=-bound, scale=2 * bound).cdf
    for values in (port, ref):
        assert np.abs(values).max() <= bound
        assert stats.kstest(values, law).statistic < \
            1.95 / math.sqrt(len(values))
