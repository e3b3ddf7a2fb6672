"""K1's closed-form family branches: ``ops/fast_math.py`` (the PyTorch
transcription of ``csrc/fast_math.cuh`` and of the rewritten bodies of
``csrc/ppf_ops.cuh``) against float64 numpy and against the JAX package.

* Each device function on its stated range, with exact stand-ins for the
  MUFU approximations, within its stated bound (float32 ulps of the
  float64 value, or absolute where the comment says so): what the
  reductions and polynomials themselves give.
* Each rewritten family at its ``FAMILY_SWEEP`` parameters against
  ``probabilit_tpu.ops.ppf`` (one ``jax.jit`` for all of them) on a q grid
  that holds 2^-24, 1 - 2^-24, the draws' 2^-23 grid near both ends, the
  family's branch points and their neighbours: within 1e-4 of the largest
  JAX value on the grid (the tolerance ``chip_smoke.py`` holds the kernel to
  against its twin), with exact stand-ins and with every MUFU stand-in
  off by its documented bound in either direction (``mufu_error``).
* The traps: the Cauchy pole, where only the twin's own float argument
  gives the twin's value; gumbel_r at q = 1 - 2^-24, where an absolute-
  accuracy log of q has no digit left; geom at q = 1 - (1 - p)^k, where the
  ratio of logs is an integer and libm's rounding of log1pf decides the
  step (geom keeps it).
* The generated text: ``_HEADERS`` lists the new header, and no rewritten
  family's body (nor a closed-form tape's family rows) calls libm, but
  geom's log1pf, or divides in IEEE.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from probabilit_tpu.ops import ppf as jax_ppf
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.ops import fast_math as fm
from probabilit_tpu_torch.ops import ppf, special
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

CSRC = Path(__file__).resolve().parent.parent / "probabilit_tpu_torch" / "csrc"
REL_TOL = 1e-4
UNCHANGED = ("uniform", "norm", "triang", "bernoulli", "randint")
SWEEP = {name: (args, kwargs) for name, args, kwargs in benchmarks.FAMILY_SWEEP}
# The first two rewritten families are not in the sweep (they are the main path's).
SWEEP.update({"expon": ((), {"scale": 0.1}), "lognorm": ((0.25,), {"scale": 50.0})})
REWRITTEN = [f for f in cuda_exec._CLOSED_FORM_FAMILIES if f not in UNCHANGED]


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _f32(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _ulps(got, want):
    """|got - want| in float32 ulps of want (float64 want)."""
    got = np.asarray(got, dtype=np.float64)
    with np.errstate(over="ignore"):  # beyond the float32 range: inf spacing
        spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return np.abs(got - want) / spacing


# ---- The device functions -------------------------------------------------

_RNG = np.random.default_rng(12)
_POS = np.concatenate([
    np.float32(2.0) ** np.arange(-126, 128, dtype=np.float32),
    np.logspace(-37.5, 38, 4000), np.linspace(2 / 3, 4 / 3, 4001),
    1.0 + _RNG.uniform(-1e-4, 1e-4, 2000), np.float32(1.0) - np.arange(1, 512) * 2.0**-24,
]).astype(np.float32)


def test_log_fast_is_relative_accurate_everywhere():
    got = fm.log_fast(_f32(_POS)).numpy()
    want = np.log(_POS.astype(np.float64))
    keep = _POS != 1.0
    assert _ulps(got[keep], want[keep]).max() <= 2.0
    assert got[_POS == 1.0].tolist() == [0.0] * int((_POS == 1.0).sum())
    special_values = fm.log_fast(_f32([0.0, np.inf, -1.0, np.nan, 1e-40])).numpy()
    assert special_values[0] == -np.inf and special_values[1] == np.inf
    assert np.isnan(special_values[2]) and np.isnan(special_values[3])
    assert abs(special_values[4] - np.log(np.float64(np.float32(1e-40)))) < 1e-5


def test_log1p_fast_is_relative_accurate_from_minus_one_up():
    x = np.concatenate([
        -np.float32(1.0) + np.arange(1, 64) * np.float32(2.0**-24),
        -np.logspace(-30, -0.0001, 3000), np.logspace(-30, 6, 3000),
        np.linspace(-0.5, 0.5, 4001), np.arange(1, 300) * np.float32(2.0**-23),
    ]).astype(np.float32)
    x = x[(x > -1.0) & (x != 0.0)]
    got = fm.log1p_fast(_f32(x)).numpy()
    assert _ulps(got, np.log1p(x.astype(np.float64))).max() <= 2.0


def test_exp_fast_and_expm1_fast():
    x = np.concatenate([np.linspace(-87.0, 88.0, 20001), np.linspace(-1, 1, 2001)]).astype(np.float32)
    # ex2 of the rounded x log2 e: 8e-8 |x| relative, and 2 ulps.
    want = np.exp(x.astype(np.float64))
    rel = np.abs(fm.exp_fast(_f32(x)).numpy() - want) / want
    assert (rel <= 8e-8 * np.abs(x) + 2.0**-22).all()
    assert fm.exp_fast(_f32([-np.inf, np.inf, -120.0])).numpy().tolist()[:2] == [0.0, np.inf]
    assert np.isnan(fm.exp_fast(_f32([np.nan])).numpy()[0])
    x = x[x != 0.0]
    want = np.expm1(x.astype(np.float64))
    # The Taylor branch to |x| < 0.25, e^x - 1 beyond it (as expm1_safe).
    got = fm.expm1_fast(_f32(x)).numpy()
    small = np.abs(x) < 0.25
    assert _ulps(got[small], want[small]).max() <= 2.0
    # e^x as above, then the subtraction's rounding.
    bound = ((8e-8 * np.abs(x) + 2.0**-22) * np.exp(x.astype(np.float64))
             + np.spacing(np.abs(want).astype(np.float32)))
    assert (np.abs(got - want)[~small] <= bound[~small]).all()


def test_pow_fast_on_the_families_bases():
    x = np.concatenate([np.logspace(-30, 6, 600), np.linspace(0.5, 2.0, 301)]).astype(np.float32)
    y = np.array([-2.5, -1.0 / 1.7, -0.4, 0.2, 0.5, 1.0 / 1.7, 2.0, 3.0], dtype=np.float32)
    X, Y = np.meshgrid(x, y)
    want = X.astype(np.float64) ** Y.astype(np.float64)
    ok = (want > 1e-37) & (want < 1e37)
    got = fm.pow_fast(_f32(X), _f32(Y)).numpy()
    t = np.abs(Y * np.log2(X.astype(np.float64)))
    # ex2 of a rounded y log2 x: the product's half ulp times |t| ln 2 more.
    assert (_ulps(got, want)[ok] <= 2.0 + 1.5 * t[ok]).all()
    assert fm.pow_fast(_f32([0.0, 0.0, 5.0]), _f32([0.5, -0.5, 0.0])).numpy().tolist() == [
        0.0, np.inf, 1.0]


def test_tan_and_cot_up_to_the_float_nearest_half_pi():
    half_pi = np.float32(np.pi / 2)
    x = np.concatenate([
        np.linspace(-half_pi, half_pi, 40001),
        np.nextafter(half_pi, np.float32(0)) - np.arange(0, 64, dtype=np.float32) * 1.2e-7,
        [half_pi, np.nextafter(half_pi, np.float32(2))],
        np.logspace(-30, -1, 300),
    ]).astype(np.float32)
    x = x[x != 0.0]
    want = np.tan(x.astype(np.float64))
    assert _ulps(fm.tan_fast(_f32(x)).numpy(), want).max() <= 3.0
    assert _ulps(fm.cot_fast(_f32(x)).numpy(), 1.0 / want).max() <= 3.0


def test_sin_fast_on_zero_to_half_pi():
    x = np.concatenate([np.linspace(1e-6, np.float32(np.pi / 2), 40001),
                        np.logspace(-30, -1, 300)]).astype(np.float32)
    assert _ulps(fm.sin_fast(_f32(x)).numpy(), np.sin(x.astype(np.float64))).max() <= 2.0


def test_div_fast_is_within_an_ulp_and_div_rounded_is_ieee():
    a = _RNG.uniform(-1e3, 1e3, 20000).astype(np.float32)
    b = (_RNG.uniform(0.5, 2.0, 20000) * 10.0 ** _RNG.integers(-20, 20, 20000)).astype(np.float32)
    want = a.astype(np.float64) / b
    assert _ulps(fm.div_fast(_f32(a), _f32(b)).numpy(), want).max() <= 1.0
    np.testing.assert_array_equal(fm.div_rounded(_f32(a), _f32(b)).numpy(), a / b)


def test_ndtr_mufu_and_the_wide_quantile():
    x = np.linspace(-9.0, 9.0, 20001).astype(np.float32)
    assert np.abs(fm.ndtr_mufu(_f32(x)).numpy() - scipy.special.ndtr(x.astype(np.float64))).max() <= 3e-7
    q = np.concatenate([np.logspace(-37, np.log10(0.5), 4000), 1.0 - np.logspace(-7.2, -0.31, 2000),
                        [2.0**-24, 1 - 2.0**-24]]).astype(np.float32)
    got = fm.ndtri_wide_fast(_f32(q)).numpy()
    # The formula of special.ndtri_fast_wide (what the Newton tier keeps):
    # the one lg2 of t (1 - t) for two logs moves w by ulps.
    np.testing.assert_allclose(got, special.ndtri_fast_wide(_f32(q)).numpy(), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, scipy.special.ndtri(q.astype(np.float64)), rtol=2e-4, atol=2e-6)


# ---- The families against the JAX package ---------------------------------


def _branch_points(name, args):
    """The q at which the family's body switches formula, at ``args``."""
    if name in ("laplace", "dweibull", "loglaplace", "hypsecant", "powernorm", "powerlognorm"):
        return [0.5]
    if name == "alpha":
        return [0.999]
    if name == "skewcauchy":
        f0 = 0.5 * (1 - args[0])
        return [f0, 0.5 * f0, f0 + 0.25 * (1 + args[0])]
    if name == "trapezoid":
        c, d = args
        h = 2 / (1 + d - c)
        return [0.5 * h * c, h * (d - 0.5 * c)]
    if name == "laplace_asymmetric":
        k2 = args[0] ** 2
        return [k2 / (1 + k2)]
    if name == "crystalball":
        beta, m = args
        C = m / (beta * (m - 1)) * math.exp(-0.5 * beta * beta)
        D = math.sqrt(2 * math.pi) * scipy.special.ndtr(beta)
        return [C / (C + D)]
    if name == "geom":
        p = args[0]
        return [1 - (1 - p) ** k for k in range(1, 12)]
    return []


# The draws' values: 2^-24, 1 - 2^-24 and multiples of 2^-23, densely near
# both ends (off that grid the two packages round 2q - 1 and 1 - q apart).
_K = np.unique(np.concatenate([np.arange(1, 257), np.round(np.logspace(8, 22.9, 600, base=2))]))
_GRID = np.concatenate([
    [2.0**-24, 1 - 2.0**-24], _K * 2.0**-23, 1 - _K * 2.0**-23,
    np.round(np.linspace(0.001, 0.999, 4001) * 2**23) * 2.0**-23,
])


def _grid(name, args):
    points = np.asarray(_branch_points(name, args), dtype=np.float32)
    near = np.concatenate([points, np.nextafter(points, np.float32(0)),
                           np.nextafter(points, np.float32(1))])
    return np.concatenate([_GRID.astype(np.float32), near]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_values():
    """{family: (q, JAX float32 values)}: one jit for every rewritten family."""
    grids = {name: _grid(name, SWEEP[name][0]) for name in REWRITTEN}

    def all_families(qs):
        return {name: jax_ppf.call(name, qs[name], *SWEEP[name][0], **SWEEP[name][1])
                for name in REWRITTEN}

    out = jax.jit(all_families)({name: jnp.asarray(q) for name, q in grids.items()})
    return {name: (grids[name], np.asarray(out[name])) for name in REWRITTEN}


@pytest.mark.parametrize("sign", [0, 1, -1], ids=["exact", "mufu_up", "mufu_down"])
@pytest.mark.parametrize("name", REWRITTEN)
def test_family_matches_jax(jax_values, name, sign):
    q, ref = jax_values[name]
    args, kwargs = SWEEP[name]
    with fm.mufu_error(sign):
        got = fm.value(name, _f32(q), args, kwargs).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    err = np.abs(got.astype(np.float64) - ref)
    scale = np.abs(ref).max()
    if name == "geom":
        # Discrete: equal wherever the ratio of logs is no integer.  At
        # q = 1 - (1 - p)^k, XLA's logs round off the correctly rounded
        # floats (the port's twin and the kernel take those): see
        # test_geom_takes_correctly_rounded_logs_at_its_steps.
        lattice = np.isin(q, np.asarray(_branch_points(name, args), dtype=np.float32))
        assert (err[~lattice] == 0).all()
        assert (err[lattice] <= 1).all()
    else:
        assert err.max() <= REL_TOL * scale, (q[err.argmax()], got[err.argmax()], ref[err.argmax()])


@pytest.mark.parametrize("name", REWRITTEN)
def test_family_matches_the_twin(name):
    """The transcription against the port's plain twin (``ops/ppf.py``
    under ``kernel_safe_special``): what chip_smoke.py holds the kernel to."""
    args, kwargs = SWEEP[name]
    q = _f32(_grid(name, args))
    with special.kernel_safe_special():
        ref = ppf.call(name, q, *args, **kwargs)
    got = fm.value(name, q, args, kwargs)
    assert (got - ref).abs().max() <= REL_TOL * ref.abs().max()


def test_cauchy_takes_the_twins_float_argument_at_the_pole():
    q = _f32([2.0**-24, 1 - 2.0**-24, 3 * 2.0**-24, 1 - 2.0**-23, 1 - 3 * 2.0**-24])
    twin = ppf.call("cauchy", q)
    got = fm.value("cauchy", q)
    assert ((got - twin).abs() <= 1e-6 * twin.abs()).all()
    # tan of the exact angle pi (q - 1/2), from the exact 1 - q, is the
    # family's true value; the twin's float32 angle sits 6e-8 off a
    # distance of 1.9e-7 from pi/2, so the twin is about 30% off it, and a
    # kernel that reduced exactly would fail the twin tolerance.
    qd = q.double().numpy()
    exact = np.where(qd < 0.5, -1.0 / np.tan(np.pi * qd), 1.0 / np.tan(np.pi * (1.0 - qd)))
    rel = np.abs(exact - twin.double().numpy()) / np.abs(twin.double().numpy())
    assert rel.max() > 0.1


def test_gumbel_r_at_one_minus_two_to_the_minus_24():
    q = _f32([1 - 2.0**-24, 1 - 2.0**-23, 1 - 3 * 2.0**-24])
    twin = ppf.call("gumbel_r", q)
    for sign in (0, 1, -1):
        with fm.mufu_error(sign):
            got = fm.value("gumbel_r", q)
        assert ((got - twin).abs() <= 1e-6 * twin.abs()).all()
    # lg2.approx's 2^-22 absolute error against -log q = 6e-8: no digit.
    with fm.mufu_error(1):
        naive = -torch.log(-fm.log_mufu(q))
    assert not torch.isfinite(naive).all() or ((naive - twin).abs() > 0.1).any()


def test_geom_steps_as_the_twin_does():
    """geom keeps libm's log1pf (torch.log1p stands in) and divides as IEEE
    does: equal to the twin at its integer steps q = 1 - (1 - p)^k, where
    an ulp of the ratio is a whole step, and everywhere else."""
    for p in (0.25, 0.3, 0.01):
        steps = [1 - (1 - p) ** k for k in range(1, 40)]
        q = _f32(np.concatenate([steps, _GRID]))
        got = fm.value("geom", q, (p,))
        np.testing.assert_array_equal(got.numpy(), ppf.call("geom", q, p).numpy())
    a, b = _f32(-_RNG.uniform(0, 20, 5000)), _f32(-_RNG.uniform(0.01, 3, 5000))
    np.testing.assert_array_equal(fm.div_rounded(a, b).numpy(), (a / b).numpy())


# ---- The generated text ----------------------------------------------------

LIBM = re.compile(r"(?<![\w.])(logf|log1pf|expf|powf|tanf|sinf|cosf|sqrtf|expm1f|log2f|exp2f)\(")


def _bodies(text):
    """{function name: body} of the ``__device__`` functions of a header,
    comments stripped."""
    text = re.sub(r"//[^\n]*", "", text)
    out = {}
    for m in re.finditer(r"__device__ __forceinline__ [\w ]+? (\w+)\(", text):
        start = text.index("{", m.end())
        depth, i = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        out[m.group(1)] = text[start:i + 1]
    return out


def _ieee_divisions(body):
    """The ``a / b`` of a body whose operands are not both literals."""
    literal = r"\d[\d.]*(?:e-?\d+)?f?"
    return [m.group(0) for m in re.finditer(r"([\w.)\]]+)\s*/\s*([\w.(]+)", body)
            if not (re.fullmatch(literal, m.group(1)) and re.fullmatch(literal, m.group(2)))]


def test_the_rewritten_bodies_call_no_libm_and_divide_by_the_reciprocal():
    assert "fast_math.cuh" in cuda_exec._HEADERS
    assert cuda_exec._HEADERS.index("fast_math.cuh") < cuda_exec._HEADERS.index("ppf_ops.cuh")
    fast = _bodies((CSRC / "fast_math.cuh").read_text())
    ops = _bodies((CSRC / "ppf_ops.cuh").read_text())
    for name, body in {**fast, **ops}.items():
        if name in {f"ppf_{f}" for f in UNCHANGED}:
            continue
        if name == "ppf_geom":  # libm's rounding of log1pf decides its steps
            body = body.replace("log1pf(", "")
        assert not LIBM.search(body), (name, LIBM.search(body).group(0))
        assert not _ieee_divisions(body), (name, _ieee_divisions(body))
    assert {f"ppf_{f}" for f in REWRITTEN} <= set(ops)
    # The Newton tier keeps special_ops' wide quantile and log-gamma.
    newton = (CSRC / "newton_ops.cuh").read_text()
    assert "using special_ops::ndtri_fast_wide;" in newton and "fast_math" not in newton


@pytest.mark.parametrize("label", [f"closed_form_{i}" for i in range(4)])
def test_closed_form_tapes_family_rows_call_no_libm(label):
    sink, nodes = benchmarks.family_graphs()[label]
    tape = cuda_exec.lower(tcompile.get_plan(sink), [sink._id])
    rows = [line for line in tape.source.splitlines() if "= ppf_" in line]
    assert len(rows) == cuda_exec.LANES * len(nodes)
    assert not any(LIBM.search(line) for line in rows)
    # The tape holds family, AFFINE and ADD rows only: no transform's libm.
    names = {cuda_exec.OPCODES[row[0]] for row in tape.program}
    assert names <= {"DRAW", "LOADK", "STORE", "AFFINE", "ADD",
                     *(cuda_exec._FAMILY_OPS[f] for f, _ in nodes)}
    kernel = tape.source[tape.source.index("__global__"):]
    assert not LIBM.search(kernel)
