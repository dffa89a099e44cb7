"""Device-side planted-task sampler vs the host generator: same ground
truth, same marginals, usable for training (tools/converge.py protocol)."""

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import CriteoConfig, ModelConfig
from recsys.data import criteo, synthetic_device as sd

SMALL = CriteoConfig(cat_vocabs=tuple([200] * 6))


def test_planted_tables_match_host_generator():
    """The uploaded effect + interaction-latent tables are bit-identical to
    the host generator's PRNG streams — both samplers share one ground
    truth."""
    tabs = sd.planted_tables(SMALL)
    spec = criteo.SyntheticSpec()
    f = 7   # arbitrary field
    expect = np.random.default_rng([spec.seed, 31 * f + 1]).normal(
        0.0, spec.effect_scale, SMALL.field_vocab_sizes[f])
    lo = tabs["offsets"][f]
    np.testing.assert_allclose(
        tabs["effects"][lo:lo + len(expect)], expect, rtol=1e-6)
    lat = np.random.default_rng([spec.seed, 31 * f + 2]).normal(
        0.0, spec.interaction_scale,
        (SMALL.field_vocab_sizes[f], spec.interaction_rank))
    np.testing.assert_allclose(
        tabs["latents"][lo:lo + len(lat)], lat, rtol=1e-6)
    assert tabs["w_dense"].shape == (13,)


def test_host_and_device_logits_share_ground_truth():
    """Same ids+dense ⇒ same planted logit on both samplers: recompute the
    host generator's label probability from the device tables."""
    import scipy.special as sp

    spec = criteo.SyntheticSpec()
    d = criteo.synthetic_criteo(4096, SMALL, start_row=123, _return_prob=True)
    tabs = sd.planted_tables(SMALL)
    gids = d["ids"].astype(np.int64) + tabs["offsets"][None, :]
    logit = (spec.bias + tabs["effects"][gids].sum(axis=1)
             + sd._pairwise_term(tabs["latents"], gids)
             + d["dense"] @ tabs["w_dense"])
    np.testing.assert_allclose(sp.expit(logit), d["_true_prob"],
                               rtol=2e-4, atol=2e-6)


def test_second_order_task_ceiling_ordering():
    """linear < id-only strictly (the interaction gap is real structure) and
    the ANOVA additive oracle is tight enough to sit well above a
    first-order-only scorer."""
    full = criteo.synthetic_bayes_metrics(30_000, SMALL)
    ido = sd.idonly_bayes_metrics(30_000, SMALL)
    lin = sd.linear_bayes_metrics(30_000, SMALL)
    assert lin["auc"] < ido["auc"] - 0.005, (lin["auc"], ido["auc"])
    assert ido["auc"] <= full["auc"] + 1e-9
    assert lin["logloss"] > ido["logloss"]
    # zipf marginals are exact probabilities
    p = sd.zipf_marginals(200)
    assert abs(p.sum() - 1.0) < 1e-12 and (p >= 0).all()
    assert p[0] > p[50] > p[150]


def test_device_sampler_matches_host_marginals():
    sampler = sd.make_device_sampler(SMALL)
    tabs = {k: jnp.asarray(v) for k, v in sd.planted_tables(SMALL).items()}
    b = sampler(jax.random.key(0), tabs, 50_000)
    host = criteo.synthetic_criteo(50_000, SMALL, start_row=999_999)

    # label rate within sampling noise of the host generator's
    assert abs(float(b["label"].mean()) - host["label"].mean()) < 0.01
    # dense marginal: log1p(lognormal)
    assert abs(float(b["dense"].mean()) - host["dense"].mean()) < 0.01
    # zipf id skew per field: mean id within 2% of vocab
    for f in (0, 13, 15):
        dev_m = float(jnp.mean(b["ids"][:, f]))
        host_m = host["ids"][:, f].mean()
        vocab = SMALL.field_vocab_sizes[f]
        assert abs(dev_m - host_m) < 0.03 * vocab + 0.5, (f, dev_m, host_m)
        assert int(jnp.max(b["ids"][:, f])) < vocab


def test_idonly_ceiling_below_full_ceiling():
    full = criteo.synthetic_bayes_metrics(30_000, SMALL)
    ido = sd.idonly_bayes_metrics(30_000, SMALL)
    assert ido["auc"] <= full["auc"] + 1e-9
    assert ido["logloss"] >= full["logloss"] - 1e-9
    # and still far above random
    assert ido["auc"] > 0.75


def test_sampler_fused_training_learns():
    """The sampler-fused scan (converge.py's step) trains toward the
    planted task on fresh device samples."""
    from recsys.models.api import make_model
    from recsys.train import fast, optim, train_state as TS

    model = make_model("fm", SMALL, ModelConfig(name="fm", embedding_dim=8))
    sched = optim.cosine_decay(5e-3, 300, warmup_steps=20)
    ts, tx = TS.create_train_state(model, seed=0, learning_rate=5e-3,
                                  opt=optim.adam(sched))
    sampler = sd.make_device_sampler(SMALL)
    tabs = {k: jnp.asarray(v) for k, v in sd.planted_tables(SMALL).items()}
    step_fn = fast.make_scanned_train_step_sampler(model, tx, sampler, 512)
    ts, loss0 = step_fn(ts, tabs, 20)
    ts, loss1 = step_fn(ts, tabs, 280)
    assert float(loss1) < float(loss0) - 0.05, (float(loss0), float(loss1))


def test_cosine_decay_schedule():
    lr = optim_lr = None
    from recsys.train import optim
    lr = optim.cosine_decay(1.0, total_steps=100, warmup_steps=10)
    assert float(lr(jnp.float32(5))) == 0.5           # mid-warmup
    assert abs(float(lr(jnp.float32(10))) - 1.0) < 1e-6
    assert abs(float(lr(jnp.float32(55)))) < 1.0      # decaying
    assert float(lr(jnp.float32(100))) < 1e-6         # → 0 at budget
