"""The CUDA megakernel against its plain twin, on the card.

Every test here needs an sm_90 card and skips without one; the decision
is made inside a fixture.  The file imports only the port, so on the
machine with the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: per kept node, max |kernel - twin| <= 1e-4 * max |twin|.  The
two differ only where nvcc contracts a*b+c into FMAs and where CUDA's
libm rounds differently from PyTorch's.
"""

import pytest
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks, graph as tg
from probabilit_tpu_torch.models.distributions import Distribution

REL_TOL = 1e-4
N = 1 << 20


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available() or cuda_exec.environment_issue("cuda") is not None:
        pytest.skip("needs an sm_90 CUDA card")
    config.set_device("cuda")
    try:
        yield
    finally:
        config.set_device("cpu")


def _composite():
    a = Distribution("uniform", loc=1.0, scale=2.0)
    b = Distribution("norm", loc=a, scale=a * 0.5)
    c = Distribution("lognorm", s=0.2, scale=b * b + 1)
    return tg.Avg(a, b, c) + Distribution("triang", c=0.3, loc=b, scale=2)


def _many_ops():
    """Every transform the tape has, on float operands."""
    x = Distribution("uniform", loc=0.1, scale=0.8)
    y = Distribution("norm")
    z = Distribution("expon", scale=2.0)
    return tg.Add(
        tg.Max(x, y, 0.2), tg.Min(x, y), tg.FloorDivide(y, x), tg.Mod(y, -x),
        tg.Power(x, y), tg.Arctan2(y, x), tg.Sign(y) * tg.Abs(y),
        tg.Floor(y) + tg.Ceil(x), tg.IsClose(x, x * 1.000001) * 1.0,
        tg.All(x > 0.5, y > 0) * 2.0, tg.Any(x > 0.5, y < -1) * 3.0,
        tg.Equal(x, x) * 1.0 + tg.NotEqual(x, y) * 2.0 + (x <= y) * 3.0 - (x >= y),
        tg.Log(x) + tg.Log10(x) + tg.Log1p(z) + tg.Sqrt(z) + tg.Square(y),
        tg.Sin(y) + tg.Cos(y) + tg.Tan(x) + tg.Arcsin(x) + tg.Arccos(x) + tg.Arctan(y),
        tg.Sinh(x) + tg.Cosh(x) + tg.Tanh(y) + tg.Arcsinh(y) + tg.Arccosh(z + 1),
        tg.Arctanh(x) + tg.Expm1(x) + tg.Exp(-z) - (x / (z + 1)) + (-y),
        tg.Avg(x, y, z),
    )


GRAPHS = {
    "mixed_dag_20": benchmarks.mixed_dag_20,
    "height_model": benchmarks.height_model,
    "composite": _composite,
    "many_ops": _many_ops,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kernel_matches_twin(cuda_card, name):
    sink = GRAPHS[name]()
    plan = tcompile.get_plan(sink)
    others = [node._id for node in plan.topo if node is not sink][-15:]
    order = cuda_exec.keep_order(plan, frozenset(others + [sink._id]))
    tape = cuda_exec.lower(plan, order).to("cuda")
    launches = cuda_exec.LAUNCHES
    got, nonfinite = cuda_exec.run(tape, (3, 4), N)
    ref = cuda_exec.run_reference(tape, (3, 4), N)
    assert cuda_exec.LAUNCHES == launches + 1
    assert int(nonfinite) == int((~torch.isfinite(ref)).any())
    for k in range(tape.n_keep):
        scale = ref[k].abs().max().item()
        assert (got[k] - ref[k]).abs().max().item() <= REL_TOL * scale, order[k]


@pytest.mark.cuda
def test_sample_through_the_kernel(cuda_card):
    sink = benchmarks.mixed_dag_20()
    launches = cuda_exec.LAUNCHES
    a = sink.sample(N, random_state=5, gc_strategy=[], executor="cuda")
    b = sink.sample(N, random_state=5, gc_strategy=[], executor="cuda")
    assert cuda_exec.LAUNCHES == launches + 2
    assert a.device.type == "cuda" and a.shape == (N,) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # deterministic per seed


@pytest.mark.cuda
def test_kernel_flags_non_finite_values(cuda_card):
    sink = tg.Log(Distribution("norm"))
    with pytest.raises(ValueError, match="non-finite"):
        sink.sample(N, random_state=0, gc_strategy=[], executor="cuda")
