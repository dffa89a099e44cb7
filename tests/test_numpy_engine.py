"""NumPy latency engine ≡ jitted Servable for the whole CTR zoo."""

import jax
import numpy as np
import pytest

from recsys.core.config import CriteoConfig, ModelConfig
from recsys.data import criteo
from recsys.models.api import make_model
from recsys.serve.export import Servable, export_servable

SMALL = CriteoConfig(cat_vocabs=tuple([50] * 20 + [5000] * 6))


def _export(tmp_path, name, **cfg_kw):
    mcfg = ModelConfig(name=name, embedding_dim=8, deep_layers=(16, 8),
                       cin_layers=(6, 4), cross_layers=3, **cfg_kw)
    model = make_model(name, SMALL, mcfg)
    params, state = model.init(jax.random.key(3))
    d = str(tmp_path / f"exp_{name}")
    export_servable(d, name, params, state, mcfg, SMALL)
    return d


@pytest.mark.parametrize(
    "name", ["fm", "deepfm", "dnn", "dcn", "xdeepfm", "wide"])
def test_numpy_matches_jit(tmp_path, name):
    d = _export(tmp_path, name)
    feats = criteo.synthetic_criteo(37, SMALL, start_row=11)
    feats.pop("label")
    jit_probs = Servable(d, buckets=(64,)).predict(feats)
    np_probs = Servable(d, buckets=(64,), engine="numpy").predict(feats)
    assert np_probs.shape == (37,)
    np.testing.assert_allclose(np_probs, jit_probs, rtol=2e-4, atol=2e-6)


def test_numpy_engine_no_bn(tmp_path):
    d = _export(tmp_path, "deepfm", use_bn=False)
    feats = criteo.synthetic_criteo(16, SMALL)
    feats.pop("label")
    np.testing.assert_allclose(
        Servable(d, buckets=(16,), engine="numpy").predict(feats),
        Servable(d, buckets=(16,)).predict(feats), rtol=2e-4, atol=2e-6)


def test_numpy_engine_rejects_unsupported(tmp_path):
    from recsys.models.din import make_din

    mcfg = ModelConfig(name="din", embedding_dim=8, use_bn=False,
                       attention_layers=(8, 4), mlp_layers=(16, 8, 4))
    model = make_din(item_vocab=100, cate_vocab=10, cfg=mcfg)
    params, state = model.init(jax.random.key(0))
    d = str(tmp_path / "din")
    export_servable(d, "din", params, state, mcfg,
                    factory_kwargs={"item_vocab": 100, "cate_vocab": 10})
    with pytest.raises(NotImplementedError):
        Servable(d, engine="numpy")
