"""The device mesh and the profile hook on the card.

Every test needs an sm_90 card and skips without one (decided in a
fixture, as in ``test_torch_cuda.py``).  The file imports only the port,
so on the machine with the card it runs without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py

A mesh of four shards on ``cuda:0`` samples ``mixed_dag_20`` bitwise as
without a mesh, iid and Sobol; ``executor="cuda"`` refuses the mesh; with
``PROBABILIT_TPU_PROFILE=1`` the kernel path prints its three phases.
"""

import pytest
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.parallel import make_mesh, set_mesh, use_mesh

N = 1 << 20


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available() or cuda_exec.environment_issue("cuda") is not None:
        pytest.skip("needs an sm_90 CUDA card")
    previous = config.device()
    config.set_device("cuda")
    try:
        yield
    finally:
        config.set_device(previous)
        set_mesh(None)


@pytest.mark.cuda
@pytest.mark.parametrize("method", [None, "sobol"])
def test_four_shards_on_one_card_are_bitwise(cuda_card, method):
    sink = benchmarks.mixed_dag_20()
    base = sink.sample(N, random_state=0, method=method, gc_strategy=[])
    with use_mesh(make_mesh([torch.device("cuda:0")] * 4)):
        sharded = sink.sample(N, random_state=0, method=method, gc_strategy=[])
    assert sharded.device.type == "cuda"
    assert torch.equal(base, sharded)


@pytest.mark.cuda
def test_cuda_executor_refuses_a_mesh(cuda_card):
    sink = benchmarks.mixed_dag_20()
    launches = cuda_exec.LAUNCHES
    with use_mesh(make_mesh()):
        with pytest.raises(ValueError, match="does not run under a device mesh"):
            sink.sample(N, random_state=0, executor="cuda", gc_strategy=[])
    assert cuda_exec.LAUNCHES == launches


@pytest.mark.cuda
def test_profile_hook_on_the_kernel_path(cuda_card, capfd, monkeypatch):
    monkeypatch.setenv("PROBABILIT_TPU_PROFILE", "1")
    benchmarks.mixed_dag_20().sample(N, random_state=0, executor="cuda", gc_strategy=[])
    err = capfd.readouterr().err
    assert "[probabilit-tpu profile]" in err
    for phase in ("build+compile", "execute", "host"):
        assert phase in err
