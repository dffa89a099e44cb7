"""On-device sampler for the planted synthetic-Criteo task.

The host generator (`data/criteo.py synthetic_criteo`) plants a sparse
logistic ground truth:  logit = bias + Σ_f effect_f[id_f] + w·dense.  It is
the repo's stand-in for the reference's real Criteo runs (README metric
tables, README.md:20-28) and its AUC has a computable Bayes ceiling — but
generating rows with numpy tops out around a few million rows/minute and
every batch must cross the host↔device boundary.

This module re-expresses the SAME planted distribution as a jittable
function of a PRNG key, so the training scan draws fresh i.i.d. rows at
device speed — training becomes true one-pass online SGD on the population
distribution (no epoch reuse, no host traffic). The planted parameters
(per-id effects, dense weights) are generated ONCE with the identical
numpy PRNG streams as the host generator and uploaded (~3.4 MB), so both
samplers share the exact ground truth; only the sample path differs
(jax threefry vs numpy philox — distributionally equivalent draws).

Used by tools/converge.py, the convergence-quality protocol that closes
the gap between trained AUC and the planted ceiling.

Three ceilings matter (all computed here / in criteo.py):
- the full Bayes ceiling (`criteo.synthetic_bayes_metrics`) scores the true
  probabilities — attainable only by a model that sees the raw `dense`
  values (of the CTR zoo, only xDeepFM's linear branch does,
  xdeepfm/xdeepfm.py:82);
- the id-only ceiling (`idonly_bayes_metrics`) scores E[y | ids] — the best
  any model consuming only the 39 categorical ids can do (FM, DeepFM, DCN,
  DNN per the reference architectures). The dense term is drawn
  independently of the ids in the planted task, so for these models it is
  irreducible noise;
- the linear ceiling (`linear_bayes_metrics`) is the best ADDITIVE model
  (per-id weights + linear dense — wide/FTRL's class). Since the planted
  task is second-order (SyntheticSpec.interaction_*), linear < id-only
  strictly: the gap is exactly the interaction structure the FM/cross/CIN
  towers exist to capture — the synthetic analog of the reference's
  real-Criteo model ordering (/root/reference/README.md:20-28).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from recsys.core.config import CriteoConfig
from recsys.data.criteo import SyntheticSpec, synthetic_criteo


def planted_tables(
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
) -> dict[str, np.ndarray]:
    """The planted ground-truth parameters, bit-identical to the host
    generator's streams (criteo.py synthetic_criteo: per-field
    ``default_rng([seed, 31*f+1])`` effects, ``default_rng([seed, 31*f+2])``
    interaction latents, ``default_rng([seed, 999])`` dense weights)."""
    field_vocabs = cfg.field_vocab_sizes
    effects = np.concatenate([
        np.random.default_rng([spec.seed, 31 * f + 1]).normal(
            0.0, spec.effect_scale, vocab)
        for f, vocab in enumerate(field_vocabs)
    ]).astype(np.float32)
    k = spec.interaction_rank if spec.interaction_scale else 0
    latents = np.concatenate([
        np.random.default_rng([spec.seed, 31 * f + 2]).normal(
            0.0, spec.interaction_scale, (vocab, k))
        for f, vocab in enumerate(field_vocabs)
    ]).astype(np.float32) if k else np.zeros((sum(field_vocabs), 1),
                                             np.float32)
    w_dense = np.random.default_rng([spec.seed, 999]).normal(
        0.0, spec.dense_scale, len(cfg.cont_boundaries)).astype(np.float32)
    offsets = np.cumsum([0] + list(field_vocabs[:-1])).astype(np.int32)
    return {
        "effects": effects,                                   # [Σ vocab]
        "latents": latents,                                   # [Σ vocab, k]
        # effect + latents packed per row: the device sampler reads ONLY
        # this — one row gather per field instead of two
        "eff_lat": np.concatenate([effects[:, None], latents], axis=1),
        "w_dense": w_dense,                                   # [13]
        "offsets": offsets,                                   # [39]
        "vocabs": np.asarray(field_vocabs, np.float32),       # [39]
        "vocabs_i": np.asarray(field_vocabs, np.int32),       # [39]
    }


def make_device_sampler(
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
):
    """Returns ``sample(key, tables, batch_size) -> batch`` drawing from the
    planted distribution entirely on device.

    Matches the host generator's draws field by field
    (criteo.py synthetic_criteo): zipf-ish ids ``floor(V·u^2.2) mod V``,
    dense = log1p(lognormal(0,1)) (= softplus of a standard normal),
    label ~ Bernoulli(sigmoid(planted logit)).
    """
    n_fields = len(cfg.field_vocab_sizes)
    n_cont = len(cfg.cont_boundaries)

    @partial(jax.jit, static_argnums=(2,))
    def sample(key: jax.Array, tables: dict, batch_size: int) -> dict:
        ku, kd, kl = jax.random.split(key, 3)
        u = jax.random.uniform(ku, (batch_size, n_fields))
        raw = jnp.floor(tables["vocabs"] * u ** 2.2).astype(jnp.int32)
        ids = raw % tables["vocabs_i"]
        # softplus(z) = log1p(e^z) = log1p(lognormal sample), numerically
        # stable for large z
        dense = jax.nn.softplus(
            jax.random.normal(kd, (batch_size, n_cont)))
        gids = ids + tables["offsets"]
        rows = tables["eff_lat"][gids]                  # [B, F, 1+k]
        logit = (
            spec.bias
            + jnp.sum(rows[:, :, 0], axis=1)
            + dense @ tables["w_dense"]
        )
        if spec.interaction_rank and spec.interaction_scale:
            # second-order term via the FM identity (see criteo.py)
            lat = rows[:, :, 1:]                        # [B, F, k]
            s = jnp.sum(lat, axis=1)                    # [B, k]
            logit += 0.5 * (jnp.einsum("bk,bk->b", s, s)
                            - jnp.einsum("bfk,bfk->b", lat, lat))
        label = (
            jax.random.uniform(kl, (batch_size,)) < jax.nn.sigmoid(logit)
        ).astype(jnp.float32)
        return {"ids": ids, "dense": dense, "label": label}

    return sample


def _pairwise_term(latents: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Σ_{f<g} <U_f[id_f], U_g[id_g]> per row, via ½(||Σu||² − Σ||u||²)."""
    rows = latents[gids]                                     # [N, F, k]
    s = rows.sum(axis=1)                                     # [N, k]
    return 0.5 * (np.einsum("nk,nk->n", s, s)
                  - np.einsum("nfk,nfk->n", rows, rows))


def zipf_marginals(vocab: int, power: float = 2.2) -> np.ndarray:
    """Exact per-id probabilities of the samplers' zipf-ish draw
    ``floor(V·u^power) mod V`` with u ~ U[0,1):
    p_i = ((i+1)/V)^(1/power) − (i/V)^(1/power)."""
    grid = (np.arange(vocab + 1, dtype=np.float64) / vocab) ** (1.0 / power)
    return np.diff(grid)


def idonly_bayes_metrics(
    num_rows: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
    start_row: int = 0,
    mc_samples: int = 512,
    chunk: int = 65536,
) -> dict[str, float]:
    """AUC/logloss ceiling for models that consume ONLY the 39 ids.

    The optimal id-only predictor is E[y | ids] = E_z[sigmoid(id_logit + z)]
    with z = w·dense the independent dense contribution. AUC needs only the
    ranking, and E_z[sigmoid(l+z)] is monotone in l, so AUC is scored on
    id_logit directly; logloss integrates z by Monte Carlo (shared draws,
    chunked over rows).
    """
    from recsys.train.metrics import roc_auc

    tables = planted_tables(cfg, spec)
    d = synthetic_criteo(num_rows, cfg, spec, start_row)
    gids = d["ids"].astype(np.int64) + tables["offsets"][None, :]
    id_logit = spec.bias + tables["effects"][gids].sum(axis=1)
    if spec.interaction_rank and spec.interaction_scale:
        id_logit += _pairwise_term(tables["latents"], gids)
    y = d["label"]

    zrng = np.random.default_rng([spec.seed, 424242])
    z = np.log1p(np.exp(zrng.normal(size=(mc_samples, len(cfg.cont_boundaries))))) @ tables["w_dense"]
    ll_sum = 0.0
    for lo in range(0, num_rows, chunk):
        l_chunk = id_logit[lo:lo + chunk]
        p = 1.0 / (1.0 + np.exp(-(l_chunk[:, None] + z[None, :])))
        p = np.clip(p.mean(axis=1), 1e-12, 1 - 1e-12)
        yc = y[lo:lo + chunk]
        ll_sum += float(-np.sum(yc * np.log(p) + (1 - yc) * np.log(1 - p)))
    return {
        "auc": float(roc_auc(y, id_logit)),
        "logloss": ll_sum / num_rows,
    }


def linear_bayes_metrics(
    num_rows: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
    start_row: int = 0,
    mc_samples: int = 8192,
    chunk: int = 65536,
) -> dict[str, float]:
    """AUC/logloss ceiling for ADDITIVE id models (the wide/LinearClassifier
    hypothesis class: one weight per (field, id), no dense input —
    models/ctr.py make_wide), the third ceiling next to
    `idonly_bayes_metrics` and `criteo.synthetic_bayes_metrics`.

    The planted logit (criteo.py SyntheticSpec) is additive in the ids
    except for the pairwise term S = Σ_{f<g} <U_f[id_f], U_g[id_g]>. Its
    best additive L2 approximation (the ANOVA projection under the
    independent per-field zipf marginals, `zipf_marginals`) is

        S_add = c0 + Σ_f <U_f[id_f] − μ_f, M − μ_f>,
        μ_f = E[U_f[id_f]],  M = Σ_g μ_g,  c0 = Σ_{f<g} <μ_f, μ_g>,

    computed exactly from the planted tables. The oracle additive predictor
    is the planted logit with S replaced by S_add and the dense term
    dropped; AUC is scored on it directly. For logloss the predictor must
    stay calibrated despite what it cannot see — the non-additive residual
    r = S − S_add (drawn empirically from an independent slice) plus the
    independent dense contribution z = w·dense (same MC scheme idonly uses)
    — so p = E_{r,z}[sigmoid(g + r + z)] by Monte Carlo with shared draws.

    This is the L2-additive-in-logit projection, a tight proxy for (not
    exactly) the logloss-optimal additive model; trained wide/FTRL models
    land at or below it within noise (CONVERGENCE.md is the empirical
    check). An additive model provably cannot reach the id-only ceiling:
    the gap idonly − linear is pure interaction structure.
    """
    from recsys.train.metrics import roc_auc

    tables = planted_tables(cfg, spec)
    field_vocabs = cfg.field_vocab_sizes
    d = synthetic_criteo(num_rows, cfg, spec, start_row)
    gids = d["ids"].astype(np.int64) + tables["offsets"][None, :]
    g = spec.bias + tables["effects"][gids].sum(axis=1)

    res_rows = min(mc_samples, 8192)
    if spec.interaction_rank and spec.interaction_scale:
        k = spec.interaction_rank
        mus = np.zeros((len(field_vocabs), k))
        for f, vocab in enumerate(field_vocabs):
            lo = tables["offsets"][f]
            p = zipf_marginals(vocab)
            mus[f] = p @ tables["latents"][lo:lo + vocab].astype(np.float64)
        M = mus.sum(axis=0)
        c0 = 0.5 * (M @ M - np.einsum("fk,fk->", mus, mus))
        rows = tables["latents"][gids].astype(np.float64)    # [N, F, k]
        s_add = c0 + np.einsum("nfk,fk->n", rows - mus[None], M[None] - mus)
        g += s_add

        # residual samples from an independent slice (ids only matter)
        dres = synthetic_criteo(res_rows, cfg, spec,
                                start_row=start_row + num_rows + 1_000_003)
        rg = dres["ids"].astype(np.int64) + tables["offsets"][None, :]
        rrows = tables["latents"][rg].astype(np.float64)
        rs = c0 + np.einsum("nfk,fk->n", rrows - mus[None], M[None] - mus)
        r = _pairwise_term(tables["latents"], rg) - rs       # [mc]
    else:
        r = np.zeros(res_rows)

    # dense contribution: independent noise for an id-only additive model
    zrng = np.random.default_rng([spec.seed, 515151])
    z = np.log1p(np.exp(zrng.normal(
        size=(res_rows, len(cfg.cont_boundaries))))) @ tables["w_dense"]
    r = r + z

    y = d["label"]
    ll_sum = 0.0
    for lo in range(0, num_rows, chunk):
        gc = g[lo:lo + chunk]
        p = 1.0 / (1.0 + np.exp(-(gc[:, None] + r[None, :])))
        p = np.clip(p.mean(axis=1), 1e-12, 1 - 1e-12)
        yc = y[lo:lo + chunk]
        ll_sum += float(-np.sum(yc * np.log(p) + (1 - yc) * np.log(1 - p)))
    return {
        "auc": float(roc_auc(y, g)),
        "logloss": ll_sum / num_rows,
    }
