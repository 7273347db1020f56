"""The online latency estimators in the port against the JAX package's:
``OnlineLatencyTable`` and ``LatencyBank`` fed the same observations (a
numpy stream with a seed, adversarial values included) serve the same
``mu_sigma``, ``t_slack`` and per-worker ``drift``, equal as floats (both
are the same plain-Python arithmetic), and the ``to_dict`` family round
trips across the two packages."""
import json
import math

import numpy as np
import pytest

from repro.core.latency import LatencyBank as JLatencyBank
from repro.core.latency import LatencyTable as JLatencyTable
from repro.core.latency import OnlineLatencyTable as JOnlineLatencyTable
from repro.core.latency import latency_from_dict as jlatency_from_dict
from repro_torch.core.latency import (LatencyBank, LatencyTable,
                                      OnlineLatencyTable, latency_from_dict)

SEED = {1: (0.004, 0.0005), 2: (0.007, 0.0008), 4: (0.012, 0.001),
        8: (0.021, 0.002)}


def seeds(table=None, slack_sigmas=3.0):
    t = dict(table or SEED)
    return (JLatencyTable(dict(t), slack_sigmas=slack_sigmas),
            LatencyTable(dict(t), slack_sigmas=slack_sigmas))


def observations(seed, n=60, workers=3, adversarial=False):
    """(batch, elapsed, worker) triples; adversarial streams mix in NaN,
    +-inf, zero, negative and huge times and empty batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = int(rng.integers(1, 11))
        elapsed = float(rng.lognormal(math.log(0.01 * batch), 0.6))
        if adversarial and rng.random() < 0.3:
            elapsed = float(rng.choice([np.nan, np.inf, -np.inf, 0.0, -0.5,
                                        1e9, 1e-15]))
            batch = int(rng.choice([batch, 0, -1]))
        out.append((batch, elapsed, int(rng.integers(workers))))
    return out


def readings(est, workers=3):
    rows = [(b, est.mu_sigma(b), est.t_slack(b)) for b in range(0, 13)]
    if not hasattr(est, "drift"):          # a static table
        return rows, None
    drift = [est.drift()] + [est.drift(worker=w) for w in range(workers + 1)]
    return rows, drift


@pytest.mark.parametrize("alpha,bounds", [(0.25, (0.05, 50.0)),
                                          (1.0, (0.5, 2.0)),
                                          (0.05, (0.2, 5.0))])
@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_online_table_equals_jax(seed, adversarial, alpha, bounds):
    jseed, tseed = seeds()
    jt = JOnlineLatencyTable(jseed, alpha=alpha, ratio_bounds=bounds)
    tt = OnlineLatencyTable(tseed, alpha=alpha, ratio_bounds=bounds)
    assert readings(tt) == readings(jt)          # exactly the seed
    for i, (b, e, w) in enumerate(observations(seed,
                                               adversarial=adversarial)):
        worker = w if i % 4 else None
        assert tt.observe(b, e, worker=worker) == jt.observe(b, e,
                                                             worker=worker)
        if i % 7 == 0:
            assert readings(tt) == readings(jt)
    assert readings(tt) == readings(jt)
    assert (tt.n_observations, tt.n_rejected) == (jt.n_observations,
                                                  jt.n_rejected)
    for b in range(1, 13):
        mu, sigma = tt.mu_sigma(b)
        assert math.isfinite(mu) and mu > 0 and math.isfinite(sigma)
        assert sigma >= 0


def test_online_table_rejects_what_jax_rejects():
    jseed, tseed = seeds()
    jt, tt = JOnlineLatencyTable(jseed), OnlineLatencyTable(tseed)
    for obs in [(1, "x"), (1, None), (0, 0.1), (2, float("nan")),
                (2, -1.0), (3, 0.02)]:
        assert tt.observe(*obs) == jt.observe(*obs)
    assert (tt.n_observations, tt.n_rejected) == (1, 5)
    assert readings(tt) == readings(jt)
    with pytest.raises(ValueError, match="alpha"):
        OnlineLatencyTable(tseed, alpha=0.0)
    with pytest.raises(ValueError, match="ratio_bounds"):
        OnlineLatencyTable(tseed, ratio_bounds=(2.0, 1.0))


@pytest.mark.parametrize("seed", [0, 3])
def test_latency_bank_equals_jax(seed):
    """Per-model routing: each model's table sees its own observations,
    untagged ones go to the default (one table) or nowhere (several)."""
    slow = {b: (mu * 3, s) for b, (mu, s) in SEED.items()}
    (ja, ta), (jb, tb) = seeds(), seeds(slow)
    jbank = JLatencyBank({"a": JOnlineLatencyTable(ja),
                          "b": JOnlineLatencyTable(jb), "c": ja})
    tbank = LatencyBank({"a": OnlineLatencyTable(ta),
                         "b": OnlineLatencyTable(tb), "c": ta})
    rng = np.random.default_rng(seed)
    for b, e, w in observations(seed):
        model = [None, "a", "b", "c"][int(rng.integers(4))]
        assert tbank.observe(b, e, worker=w, model=model) == \
            jbank.observe(b, e, worker=w, model=model)
    for model in ("a", "b", "c"):
        assert readings(tbank.table(model)) == readings(jbank.table(model))
        assert [tbank.drift(worker=w, model=model) for w in (None, 0, 1, 2)] \
            == [jbank.drift(worker=w, model=model) for w in (None, 0, 1, 2)]
    assert [tbank.drift(worker=w) for w in (None, 0, 1, 2)] == \
        [jbank.drift(worker=w) for w in (None, 0, 1, 2)]
    assert tbank.default is jbank.default is None
    one = LatencyBank({"a": OnlineLatencyTable(ta)})
    assert one.default == "a" and one.observe(2, 0.01)
    with pytest.raises(ValueError, match="unknown model"):
        LatencyBank({"a": ta}, default="z")
    with pytest.raises(ValueError, match="unknown model"):
        tbank.table("z")


def _specs():
    jt, tt = seeds(slack_sigmas=2.5)
    j_online = JOnlineLatencyTable(jt, alpha=0.5, ratio_bounds=(0.1, 10.0))
    t_online = OnlineLatencyTable(tt, alpha=0.5, ratio_bounds=(0.1, 10.0))
    jbank = JLatencyBank({"vit_s16": j_online, "tangram": jt},
                         default="tangram")
    tbank = LatencyBank({"vit_s16": t_online, "tangram": tt},
                        default="tangram")
    return [(jt, tt), (j_online, t_online), (jbank, tbank)]


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_to_dict_round_trips_across_packages(kind):
    """A spec logged by one package, through JSON, rebuilds in the other
    with the same readings; learned state is not logged, so a rebuilt
    online table starts at its seed."""
    j, t = _specs()[kind]
    for b, e, w in observations(5, n=10):
        for est in (j, t):
            if hasattr(est, "observe"):
                est.observe(b, e, worker=w)
    assert t.to_dict() == j.to_dict()
    wire_j = json.loads(json.dumps(j.to_dict()))
    wire_t = json.loads(json.dumps(t.to_dict()))
    from_j, from_t = latency_from_dict(wire_j), jlatency_from_dict(wire_t)
    assert type(from_j).__name__ == type(j).__name__
    assert from_j.to_dict() == from_t.to_dict() == j.to_dict()
    tables = ([(from_j, from_t)] if kind < 2 else
              [(from_j.table(m), from_t.table(m))
               for m in ("vit_s16", "tangram")])
    for a, b in tables:
        assert readings(a) == readings(b)
    with pytest.raises(ValueError, match="unknown latency spec kind"):
        latency_from_dict({"kind": "bogus"})
