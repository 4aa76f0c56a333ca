"""The port's useful-FLOP accounting (``utils/flops.py``) against the JAX
package's, on one config-1 batch (``configs/config1_tiny_5cm.yaml`` as it
is) and one dense-tail batch (``tests/test_torch_dense_tail.py``'s
config, dense tail from scale 1).

Tolerances: the site and pair counts are integers, so bit-exact (JAX
returns them as floats of exact integers); ``useful_forward_flops`` is the
same formula on the same counts, so equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.utils import flops as JF
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.utils import flops as PF
from tests.test_torch_dense_tail import OVERRIDES, TRAIN_SCENE

CONFIG1 = "configs/config1_tiny_5cm.yaml"


def _config1():
    cfg = load_config(CONFIG1)
    b = synthetic.generate_batch(0, cfg.data.batch_size, num_points=cfg.data.num_points,
                                 num_instances=6, num_classes=cfg.model.num_classes)
    return cfg, jax_load_config(CONFIG1), b


def _dense_tail():
    kw = dict(TRAIN_SCENE)
    b = synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)
    return load_config(overrides=OVERRIDES), jax_load_config(overrides=OVERRIDES), b


@pytest.mark.parametrize("case", ["config1", "dense_tail"])
def test_rulebook_stats_and_flops_match_jax(case):
    cfg, jcfg, b = _config1() if case == "config1" else _dense_tail()
    assert (cfg.model.backbone.dense_from_scale is not None) == (case == "dense_tail")
    want = JF.collect_rulebook_stats(jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    got = PF.collect_rulebook_stats(cfg, b, device="cpu")
    ns = len(cfg.model.backbone.widths)
    assert sorted(got) == sorted(want)
    for key, n in (("sites", ns), ("subm_pairs", ns), ("down_pairs", ns - 1)):
        assert len(got[key]) == n
        assert all(isinstance(x, int) for x in got[key]), key
        assert all(float(x).is_integer() for x in want[key]), key
        assert got[key] == [int(x) for x in want[key]], key
    # the dense-tail scales are counted too (rulebooks built at every scale)
    assert all(x > 0 for x in got["subm_pairs"])
    flops = PF.useful_forward_flops(cfg, got)
    assert flops == JF.useful_forward_flops(jcfg, want)
    assert np.isfinite(flops) and flops > 0
