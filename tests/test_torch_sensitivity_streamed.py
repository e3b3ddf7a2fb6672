"""The port's streamed gradients (``sensitivity(block_size=...)``) on the CPU:
the mean, var, std, q and cvar folds against analytic values, the value
against ``estimate(executor=None)`` on the same blocks, a partial last
block, Sobol-sequence streams against one shot, a correlated stream,
checkpointed runs (bitwise resume, R3's and R4's fixes) and GBM Greeks.

Sizes are 2^13 to 2^17 draws in blocks of 2^10 to 2^14; the analytic
tolerances are the JAX package's own (``tests/test_sensitivity.py``).
"""

import os

import numpy as np
import pytest
import torch
from scipy import stats as sps

import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import sensitivity as sens
from probabilit_tpu_torch.engine import streaming
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def test_streamed_mean_matches_analytic_and_the_estimate():
    """The streamed value is estimate(executor=None)'s mean on the same
    blocks, bit for bit (the same draws, block means and float64 merge)."""
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    y = 5 * x + 1
    res = pt.sensitivity(y, wrt=x, size=2**16, random_state=0, block_size=2**13)
    assert res[(x, "loc")] == pytest.approx(5.0, abs=1e-3)
    assert abs(res[(x, "scale")]) < 0.1
    est = streaming.estimate(y, 2**16, block_size=2**13, random_state=0, executor=None)
    assert res.value == est["mean"]


def test_partial_last_block():
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    y = 5 * x + 1
    res = pt.sensitivity(y, wrt=x, size=2**13 + 137, random_state=1, block_size=2**13)
    assert res[(x, "loc")] == pytest.approx(5.0, abs=1e-3)
    est = streaming.estimate(y, 2**13 + 137, block_size=2**13, random_state=1, executor=None)
    assert res.value == est["mean"]
    var = pt.sensitivity(x, wrt={x: ["scale"]}, size=2**13 + 41, random_state=2,
                         statistic="var", block_size=2**13)
    assert var[(x, "scale")] == pytest.approx(6.0, rel=0.05)


def test_var_and_std_match_analytic():
    # var(loc + scale Z) = scale^2: d/dscale = 2 scale; std's d/dscale = 1.
    x = pt.Distribution("norm", loc=1.0, scale=3.0)
    res = pt.sensitivity(x, wrt=x, size=2**16, random_state=0, statistic="var",
                         block_size=2**13)
    assert res[(x, "scale")] == pytest.approx(6.0, rel=0.02)
    assert abs(res[(x, "loc")]) < 0.05
    assert res.value == pytest.approx(9.0, rel=0.02)
    est = streaming.estimate(x, 2**16, block_size=2**13, random_state=0, executor=None)
    assert res.value == pytest.approx(est["var"] * 2**16 / (2**16 - 1), rel=1e-12)
    z = pt.Distribution("norm", loc=-2.0, scale=1.7)
    sd = pt.sensitivity(z, wrt={z: ["scale"]}, size=2**15, random_state=1, statistic="std",
                        block_size=2**12)
    assert sd[(z, "scale")] == pytest.approx(1.0, rel=0.01)
    assert sd.value == pytest.approx(1.7, rel=0.02)


def test_tail_gradients_match_analytic():
    # ES_a(loc + scale Z) = loc + scale phi(z_a) / (1 - a); q_a = loc + scale z_a.
    x = pt.Distribution("norm", loc=1.0, scale=2.0)
    res = pt.sensitivity(x, wrt=x, size=2**17, random_state=0, statistic="cvar0.95",
                         block_size=2**14)
    want = sps.norm.pdf(sps.norm.ppf(0.95)) / 0.05
    assert res[(x, "loc")] == pytest.approx(1.0, abs=0.02)
    assert res[(x, "scale")] == pytest.approx(want, rel=0.03)
    assert res.value == pytest.approx(1.0 + 2.0 * want, rel=0.02)
    q = pt.sensitivity(x, wrt=x, size=2**17, random_state=1, statistic="q0.9",
                       block_size=2**14)
    assert q[(x, "loc")] == pytest.approx(1.0, abs=0.05)
    assert q[(x, "scale")] == pytest.approx(sps.norm.ppf(0.9), rel=0.05)


@pytest.mark.parametrize("statistic", ["q0.95", "cvar0.9"])
def test_streamed_tail_matches_single_shot(statistic):
    """The two-pass stream and the single-shot sort estimate the same
    quantities from independent draws (the stream's blocks are seeded
    apart): at 2^17 draws the lognormal tail's values differ by about 1%
    (one standard error), so 3% holds them, and 5% the gradients."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    y = pt.Exp(x)
    ss = pt.sensitivity(y, wrt={x: ["loc"]}, size=2**17, random_state=2, statistic=statistic)
    st = pt.sensitivity(y, wrt={x: ["loc"]}, size=2**17, random_state=2, statistic=statistic,
                        block_size=2**14)
    assert st[(x, "loc")] == pytest.approx(ss[(x, "loc")], rel=0.05)
    assert st.value == pytest.approx(ss.value, rel=0.03)


def test_pass_one_reads_band_levels_by_position():
    """Levels whose "q%g" keys collide keep their own values in the carry,
    which pass 2 reads by position."""
    levels = (0.5000001, 0.5000002, 0.5000003)
    assert len({f"q{lv:g}" for lv in levels}) == 1
    x = pt.Distribution("norm")
    carry = streaming._estimate_carry(x, 1 << 15, 1 << 12, 0, None, quantiles=levels)
    tails = streaming._host(carry[6]) / float(carry[0])
    assert tails.shape == (3,) and tails[0] <= tails[1] <= tails[2] and abs(tails[1]) < 0.05


@pytest.mark.parametrize("statistic", ["mean", "var"])
def test_streamed_sobol_equals_single_shot(statistic):
    """The blocks are slices of the one Sobol sequence: the streamed
    gradient equals the single-shot one within 1e-4 (the JAX package's
    tolerance; float32 sums in different orders)."""
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    y = (x - 1.0) ** 2
    ss = pt.sensitivity(y, wrt=x, size=2**13, random_state=3, method="sobol",
                        statistic=statistic)
    st = pt.sensitivity(y, wrt=x, size=2**13, random_state=3, method="sobol",
                        statistic=statistic, block_size=2**11)
    assert st.value == pytest.approx(ss.value, rel=1e-4)
    for pair in ss.gradients:
        assert st[pair] == pytest.approx(ss[pair], rel=1e-4, abs=1e-4)


def test_replicated_sobol_streams_report_error_bars():
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    res = pt.sensitivity(pt.Exp(x), wrt={x: ["loc"]}, size=2**16, random_state=2,
                         method="sobol", replicates=4, block_size=2**13)
    want = np.exp(0.5)
    sem = res.sems[(x, "loc")]
    assert 0.0 <= sem < 0.02 and res.value_sem is not None
    assert res[(x, "loc")] == pytest.approx(want, abs=5 * sem + 5e-3)


def test_correlated_streams_differentiate_through_the_recolouring():
    # E[(a + b)^2] and var(a + b) with corr 0.7 and scale_b = 2: the
    # scale gradient is 2 * 2 + 2 * 0.7 = 5.4 only through the recolouring.
    a = pt.Distribution("norm")
    b = pt.Distribution("norm", loc=1.0, scale=2.0)
    s = (a + b) ** 2
    s.correlate(a, b, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
    res = pt.sensitivity(s, wrt={b: ["scale"]}, size=2**16, random_state=0, block_size=2**13)
    assert res[(b, "scale")] == pytest.approx(5.4, rel=0.05)
    ss = pt.sensitivity(s, wrt=b, size=2**15, random_state=5)
    st = pt.sensitivity(s, wrt=b, size=2**15, random_state=5, block_size=2**13)
    for pair in ss.gradients:
        assert st[pair] == pytest.approx(ss[pair], rel=0.08, abs=0.08)
    c = pt.Distribution("norm")
    d = pt.Distribution("norm", loc=0.0, scale=2.0)
    t = c + d
    t.correlate(c, d, corr_mat=np.array([[1.0, 0.7], [0.7, 1.0]]))
    var = pt.sensitivity(t, wrt={d: ["scale"]}, size=2**16, random_state=1, statistic="var",
                         block_size=2**13)
    assert var[(d, "scale")] == pytest.approx(5.4, rel=0.05)


def test_streamed_gbm_greeks():
    # E[S_T] = s0 e^{mu T}: delta e^{mu T}, d/dmu s0 T e^{mu T}; the 99%
    # quantile is homogeneous in s0 (d q / d s0 = q / s0).
    g = pt.GeometricBrownianMotion(s0=100.0, mu=0.05, sigma=0.2, T=1.0, steps=8)
    res = pt.sensitivity(g.terminal(), wrt={g: ["s0", "mu", "sigma"]}, size=2**16,
                         random_state=0, block_size=2**13)
    assert res[(g, "s0")] == pytest.approx(np.exp(0.05), rel=0.01)
    assert res[(g, "mu")] == pytest.approx(100 * np.exp(0.05), rel=0.01)
    assert abs(res[(g, "sigma")]) < 3.0
    q = pt.sensitivity(g.terminal(), wrt={g: ["s0"]}, size=2**16, random_state=1,
                       statistic="q0.99", block_size=2**13)
    want = float(np.exp(0.03 + 0.2 * sps.norm.ppf(0.99)))
    assert q[(g, "s0")] == pytest.approx(want, rel=0.03)


# --- checkpoints ------------------------------------------------------------------------


def _model():
    x = pt.Distribution("norm", loc=2.0, scale=3.0)
    return x, 5 * x + 1


def _kw(path, **extra):
    kw = dict(size=20_000, block_size=1_024, random_state=0, checkpoint=str(path),
              checkpoint_every=4_096)
    kw.update(extra)
    return kw


def test_checkpointed_run_removes_its_file_and_equals_the_plain_stream(tmp_path):
    x, y = _model()
    p = tmp_path / "g.npz"
    a = pt.sensitivity(y, wrt=x, **_kw(p))
    assert not p.exists()
    b = pt.sensitivity(y, wrt=x, **_kw(p))
    assert a.value == b.value and a.gradients == b.gradients
    plain = pt.sensitivity(y, wrt=x, size=20_000, block_size=1_024, random_state=0)
    assert a[(x, "loc")] == pytest.approx(plain[(x, "loc")], abs=1e-12)
    assert a.value == pytest.approx(plain.value, rel=1e-12)


@pytest.mark.parametrize("statistic", ["mean", "var"])
def test_cut_run_resumes_bitwise(tmp_path, monkeypatch, statistic):
    x, y = _model()
    p = tmp_path / "g.npz"
    kw = _kw(p, statistic=statistic)
    full = pt.sensitivity(y, wrt=x, **kw)
    real = sens._save_grad_checkpoint
    calls = []

    def dying(*args, **kwargs):
        real(*args, **kwargs)
        calls.append(1)
        if len(calls) >= 2:
            raise RuntimeError("cut after the second segment")

    monkeypatch.setattr(sens, "_save_grad_checkpoint", dying)
    with pytest.raises(RuntimeError, match="cut after"):
        pt.sensitivity(y, wrt=x, **kw)
    monkeypatch.setattr(sens, "_save_grad_checkpoint", real)
    assert p.exists()
    resumed = pt.sensitivity(y, wrt=x, **kw)
    assert resumed.value == full.value and resumed.gradients == full.gradients
    assert not p.exists()


def test_checkpoint_refuses_another_run(tmp_path, monkeypatch):
    x, y = _model()
    p = tmp_path / "g.npz"
    real = sens._save_grad_checkpoint

    def dying(*args, **kwargs):
        real(*args, **kwargs)
        raise RuntimeError("cut")

    monkeypatch.setattr(sens, "_save_grad_checkpoint", dying)
    with pytest.raises(RuntimeError, match="cut"):
        pt.sensitivity(y, wrt=x, **_kw(p))
    monkeypatch.setattr(sens, "_save_grad_checkpoint", real)
    x.kwargs["loc"] = 2.5  # the same graph with another current value
    with pytest.raises(ValueError, match="different run"):
        pt.sensitivity(y, wrt=x, **_kw(p))
    with pytest.raises(ValueError, match="different run"):
        pt.sensitivity(y, wrt=x, **_kw(p, random_state=1))


def test_checkpoint_needs_an_explicit_random_state(tmp_path):
    """R3: the JAX package takes checkpoint= with random_state=None, whose
    fresh entropy can never resume; the port refuses it."""
    x, y = _model()
    with pytest.raises(ValueError, match="explicit random_state"):
        pt.sensitivity(y, wrt=x, size=4096, block_size=1024, checkpoint=str(tmp_path / "g"))


def test_a_non_finite_result_keeps_its_checkpoint(tmp_path):
    """R4: the JAX package removes the file before its finite check, so a
    failed run loses its carries; the port removes it only after a finite
    result."""
    x = pt.Distribution("norm", loc=0.0, scale=1.0)
    p = tmp_path / "g.npz"
    with pytest.raises(FloatingPointError, match="Non-finite"):
        pt.sensitivity(pt.Log(x), wrt=x, **_kw(p))
    assert p.exists()
    assert len(sens._load_grad_checkpoint(str(p), _fingerprint_of(p))) == 5


def _fingerprint_of(path):
    with np.load(path, allow_pickle=False) as data:
        return str(data["fingerprint"])


def test_checkpoint_composition_errors(tmp_path):
    x, y = _model()
    p = str(tmp_path / "g.npz")
    with pytest.raises(ValueError, match="block_size"):
        pt.sensitivity(y, wrt=x, size=1_000, random_state=0, checkpoint=p)
    with pytest.raises(ValueError, match="single-stream"):
        pt.sensitivity(y, wrt=x, size=1_000, block_size=256, replicates=2, random_state=0,
                       checkpoint=p)
    with pytest.raises(ValueError, match="single-pass"):
        pt.sensitivity(y, wrt=x, size=1_000, block_size=256, statistic="q0.9", random_state=0,
                       checkpoint=p)
    with pytest.raises(ValueError, match="checkpoint_every"):
        pt.sensitivity(y, wrt=x, size=1_000, checkpoint_every=100)
    assert not os.path.exists(p)


def test_block_memory_is_freed_between_blocks():
    """Each block's graph is released before the next: after a streamed
    run no tensor keeps a grad_fn alive through the nodes' parameters."""
    x = pt.Distribution("norm", loc=1.0, scale=2.0)
    pt.sensitivity(x * x, wrt=x, size=2**12, random_state=0, block_size=2**10)
    assert x.kwargs == {"loc": 1.0, "scale": 2.0}
    assert not any(isinstance(v, torch.Tensor) for v in x.kwargs.values())


def test_single_shot_quantile_past_the_limit_of_torch_quantile():
    """``torch.quantile`` refuses more than 2^24 elements; the single-shot
    ``q<level>`` sorts, so it differentiates past that: q_0.9 of
    loc + scale Z has d/dloc = 1 and d/dscale = z_0.9."""
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(torch.zeros(2**24 + 1), 0.9)
    x = pt.Distribution("norm", loc=1.0, scale=2.0)
    res = pt.sensitivity(x, wrt=x, size=2**24 + 2, statistic="q0.9", random_state=0)
    assert res[(x, "loc")] == pytest.approx(1.0, abs=1e-6)
    assert res[(x, "scale")] == pytest.approx(sps.norm.ppf(0.9), rel=1e-3)
