"""The port's device mesh (``probabilit_tpu_torch/parallel/mesh.py``) on
the CPU: the counterpart of the JAX package's ``tests/test_parallel.py``.

A mesh of ``[cpu] * n_dev`` (n_dev = 1, 2, 4, 8) is n_dev shards on the
CPU, the port's counterpart of conftest's 8 virtual CPU devices.  Under
it the uncorrelated ``sample`` (iid and Sobol) and ``sample_from_quantiles``
equal the port without a mesh bitwise, at an even and an uneven split;
correlated sampling within the JAX test's 1e-3; the column-sharded
Iman-Conover bitwise where the shard count divides the columns and within
``rtol=1e-4, atol=1e-5`` with exact marginals where they are padded.

Against the JAX package under its own 8-device CPU mesh, where the input
fixes the result: ``generate_sharded`` for Sobol, Halton and LHS bitwise
in float32 (the port given the JAX package's randomisation) and
``sample_from_quantiles`` of ``mixed_dag_20`` within 1e-4 of each node's
largest magnitude; the column-sharded Iman-Conover against the JAX
package's is in ``test_torch_parallel_jax.py``.  Then the refusals: ``executor="cuda"``
under a mesh, ``make_mesh()`` without a card, an uneven ``shard_samples``
(as ``jax.device_put`` refuses it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilit_tpu.models import benchmarks as jax_benchmarks
from probabilit_tpu.models import graph as jg
from probabilit_tpu.ops import qmc as jax_qmc
from probabilit_tpu.parallel import make_mesh as jax_make_mesh
from probabilit_tpu.parallel import shard_samples as jax_shard_samples
from probabilit_tpu.parallel import use_mesh as jax_use_mesh
import probabilit_tpu_torch as pt
from probabilit_tpu_torch import config, interop
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models import graph as tg
from probabilit_tpu_torch.ops import qmc
from probabilit_tpu_torch.ops.correlation import ImanConover
from probabilit_tpu_torch.parallel import (
    SAMPLE_AXIS,
    Mesh,
    current_mesh,
    make_mesh,
    sample_sharding,
    set_mesh,
    shard_samples,
    use_mesh,
)
from probabilit_tpu_torch.parallel import mesh as tmesh
from test_torch_graph import one_torch_thread, vector_math_initialised  # noqa: F401  (autouse)

CPU = torch.device("cpu")
REL_TOL = 1e-4
N_DEVS = [1, 2, 4, 8]

needs_devices = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)
        set_mesh(None)


def cpu_mesh(n_dev):
    return make_mesh([CPU] * n_dev)


def _under(n_dev, fn):
    with use_mesh(cpu_mesh(n_dev)):
        return fn()


class TestMeshRecord:
    def test_api_names_and_record(self):
        mesh = cpu_mesh(4)
        assert SAMPLE_AXIS == "samples"
        assert isinstance(mesh, Mesh) and mesh.axis_names == ("samples",)
        assert mesh.size == 4 and mesh.devices == (CPU,) * 4 and mesh.device_set == {CPU}
        assert current_mesh() is None
        with use_mesh(mesh) as m:
            assert m is mesh and current_mesh() is mesh
            with use_mesh(None):
                assert current_mesh() is None
            assert current_mesh() is mesh
        assert current_mesh() is None
        assert set_mesh(mesh) is mesh and current_mesh() is mesh
        set_mesh(None)

    def test_make_mesh_takes_cards_only(self):
        # config.device() is the CPU here: no fallback to a CPU mesh.
        with pytest.raises(ValueError, match="every CUDA card"):
            make_mesh()

    def test_sample_sharding_is_none_without_mesh_or_axis(self):
        assert sample_sharding(ndim=2) is None
        with use_mesh(cpu_mesh(8)):
            assert sample_sharding(ndim=0) is None
            sharding = sample_sharding(ndim=2)
        assert sharding.mesh.size == 8 and sharding.ndim == 2
        assert sharding.bounds(64) == [(8 * s, 8 * s + 8) for s in range(8)]

    def test_uneven_split_is_xla_ceil_layout(self):
        assert tmesh.row_bounds(10, 8) == [
            (0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 10), (10, 10), (10, 10)
        ]
        assert tmesh.row_bounds(4097, 4) == [(0, 1025), (1025, 2050), (2050, 3075), (3075, 4097)]

    def test_active_mesh_key(self):
        assert tcompile._active_mesh_key() is None
        with use_mesh(cpu_mesh(4)):
            assert tcompile._active_mesh_key() == (("samples",), 4, "cpu")


class TestMeshInvariance:
    @pytest.mark.parametrize("n_dev", N_DEVS)
    def test_identical_results_any_mesh(self, n_dev):
        expr = pt.Distribution("norm", loc=1, scale=2) * tg.Exp(pt.Distribution("expon"))
        baseline = expr.sample(4096, random_state=3).numpy()
        sharded = _under(n_dev, lambda: expr.sample(4096, random_state=3))
        assert sharded.device == CPU
        np.testing.assert_array_equal(baseline, sharded.numpy())

    @pytest.mark.parametrize("n_dev", N_DEVS)
    @pytest.mark.parametrize("size", [4096, 1000])
    @pytest.mark.parametrize("method", [None, "sobol", "lhs"])
    def test_mixed_dag_any_mesh(self, n_dev, size, method):
        sink = benchmarks.mixed_dag_20()
        base = sink.sample(size, random_state=5, method=method).numpy()
        sharded = _under(n_dev, lambda: sink.sample(size, random_state=5, method=method))
        np.testing.assert_array_equal(base, sharded.numpy())

    @pytest.mark.parametrize("n_dev", N_DEVS)
    def test_sample_method_under_mesh(self, n_dev):
        # test_streaming_checkpoint.py's TestShardedQMCGeneration case.
        expr = pt.Distribution("gamma", a=3.0) + 1
        base = expr.sample(4096, random_state=2, method="sobol").numpy()
        sharded = _under(n_dev, lambda: expr.sample(4096, random_state=2, method="sobol"))
        np.testing.assert_array_equal(base, sharded.numpy())

    @pytest.mark.parametrize("n_dev", N_DEVS)
    def test_sample_from_quantiles_any_mesh(self, n_dev):
        sink = benchmarks.mixed_dag_20()
        d = tcompile.get_plan(sink).d
        q = np.random.default_rng(0).random((4096, d))
        sink.sample_from_quantiles(q)
        plan = tcompile.get_plan(sink)
        base = {n._id: n.samples_.clone() for n in plan.topo}
        _under(n_dev, lambda: sink.sample_from_quantiles(q))
        for node in plan.topo:
            np.testing.assert_array_equal(base[node._id].numpy(), node.samples_.numpy())

    @pytest.mark.parametrize("n_dev", N_DEVS)
    def test_generate_sharded_blocks_are_slices(self, n_dev):
        for method in ("sobol", "halton", "lhs", "antithetic", None):
            whole = qmc.generate(method, 11, 1000, 3)
            blocks = _under(n_dev, lambda: qmc.generate_sharded(method, 11, 1000, 3))
            assert len(blocks) == n_dev
            assert [b.shape[0] for b in blocks] == [hi - lo for lo, hi in tmesh.row_bounds(1000, n_dev)]
            np.testing.assert_array_equal(torch.cat(blocks).numpy(), whole.numpy())
        assert qmc.generate_sharded("sobol", 11, 64, 3).shape == (64, 3)  # no mesh: one tensor

    def test_quantile_matrix_is_sharded(self):
        with use_mesh(cpu_mesh(8)):
            sharding = sample_sharding(ndim=2)
            assert sharding is not None
            blocks = shard_samples(np.zeros((64, 2), np.float32))
        # Samples axis split into 8 row blocks, each on its shard's device.
        assert len(blocks) == 8
        assert all(b.shape == (8, 2) and b.device == CPU for b in blocks)

    def test_shard_samples_scalar_is_noop(self):
        with use_mesh(cpu_mesh(8)):
            out = shard_samples(np.float32(1.5))
        assert float(np.asarray(out)) == 1.5
        assert shard_samples(np.ones(3)) is not None  # no mesh: unchanged

    @needs_devices
    def test_shard_samples_refuses_uneven_axis_as_jax_does(self):
        with jax_use_mesh(jax_make_mesh()):
            with pytest.raises(ValueError, match="divisible by 8"):
                jax_shard_samples(np.zeros((10, 2), np.float32))
        with use_mesh(cpu_mesh(8)):
            with pytest.raises(ValueError, match="divisible by 8"):
                shard_samples(np.zeros((10, 2), np.float32))

    def test_correlated_sampling_under_mesh(self):
        a, b = pt.Distribution("uniform"), pt.Distribution("expon")
        corr = np.array([[1, 0.6], [0.6, 1]])
        expr = (a + b).correlate(a, b, corr_mat=corr)
        with use_mesh(cpu_mesh(8)):
            expr.sample(4096, random_state=0)
            achieved = np.corrcoef(a.samples_.numpy(), b.samples_.numpy())[0, 1]
        assert np.isclose(achieved, 0.6, atol=0.1)

    @pytest.mark.parametrize("n_dev", N_DEVS)
    @pytest.mark.parametrize("method", [None, "sobol"])
    def test_correlated_mesh_matches_unsharded_closely(self, n_dev, method):
        # The JAX test's contract: within 1e-3, never a rank swap.  The
        # sort-free branch (method=None) runs on the first device; a
        # method's matrix takes the column-sharded Iman-Conover.
        a, b = pt.Distribution("norm"), pt.Distribution("norm")
        corr = np.array([[1, 0.7], [0.7, 1]])
        expr = (a + b).correlate(a, b, corr_mat=corr)
        base = expr.sample(4096, random_state=7, method=method).numpy()
        sharded = _under(n_dev, lambda: expr.sample(4096, random_state=7, method=method)).numpy()
        np.testing.assert_allclose(base, sharded, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("method", [None, "sobol"])
    def test_each_shard_runs_its_own_rows(self, method, monkeypatch):
        # The body sees each shard's rows when the plan allows it, and the
        # gathered rows once when it does not (a correlated plan).
        seen = []
        build = tcompile.build_body

        def logged(*args, **kwargs):
            body = build(*args, **kwargs)
            return lambda q: (seen.append(q.shape[0]), body(q))[1]

        monkeypatch.setattr(tcompile, "build_body", logged)
        sink = benchmarks.mixed_dag_20()
        _under(4, lambda: sink.sample(4096, random_state=0, method=method))
        assert seen == [1024] * 4
        seen.clear()
        a, b = pt.Distribution("norm"), pt.Distribution("norm")
        expr = (a + b).correlate(a, b, corr_mat=np.array([[1, 0.5], [0.5, 1]]))
        _under(4, lambda: expr.sample(4096, random_state=0, method=method))
        assert seen == [4096]

    @pytest.mark.parametrize("method", [None, "sobol"])
    def test_student_t_copula_runs_on_the_first_device(self, method, monkeypatch):
        # Its mixing draw is one stream, so its transform is not split.
        from probabilit_tpu_torch.ops.correlation import StudentTCopula

        def refuse(*args, **kwargs):
            raise AssertionError("the t copula was column-sharded")

        monkeypatch.setattr(StudentTCopula, "_apply_rows_sharded", refuse)
        a, b = pt.Distribution("norm"), pt.Distribution("expon")
        expr = (a + b).correlate(a, b, corr_mat=np.array([[1, 0.6], [0.6, 1]]))
        kw = dict(random_state=3, method=method, correlator="tcopula")
        base = expr.sample(2048, **kw).numpy()
        np.testing.assert_array_equal(base, _under(4, lambda: expr.sample(2048, **kw)).numpy())

    def test_streaming_under_mesh(self):
        model = pt.Distribution("norm", loc=4)
        with use_mesh(cpu_mesh(8)):
            stats = pt.estimate(model, 100_000, block_size=8192, random_state=0)
        assert np.isclose(stats["mean"], 4.0, atol=0.05)


class TestCudaExecutorUnderMesh:
    def test_cuda_executor_refused_with_the_mesh_message(self):
        sink = benchmarks.mixed_dag_20()
        with use_mesh(cpu_mesh(4)):
            assert cuda_exec.environment_issue() == (
                "executor='cuda' does not run under a device mesh; use the default "
                "executor for sharded sampling."
            )
            with pytest.raises(ValueError, match="does not run under a device mesh"):
                sink.sample(1024, random_state=0, executor="cuda", gc_strategy=[])
            with pytest.raises(ValueError, match="does not run under a device mesh"):
                pt.estimate(sink, 4096, block_size=1024, random_state=0, executor="cuda")

    def test_auto_takes_the_plain_executor_under_mesh(self):
        sink = benchmarks.mixed_dag_20()
        launches = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
        base = pt.estimate(sink, 4096, block_size=1024, random_state=0, executor=None)
        with use_mesh(cpu_mesh(4)):
            got = pt.estimate(sink, 4096, block_size=1024, random_state=0, executor="auto")
        assert (cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES) == launches
        assert repr(got) == repr(base)


class TestColumnShardedImanConover:
    """The statistical columns shard over the mesh: each shard sorts,
    scores, recolours and places its own rows; only the K x K Gram is
    formed on the first device."""

    @staticmethod
    def _divisible():
        rng = np.random.default_rng(1)
        X = rng.normal(size=(2000, 16))
        return X, np.eye(16) * 0.7 + 0.3

    @staticmethod
    def _padded():
        rng = np.random.default_rng(2)
        X = rng.normal(size=(1500, 5))
        return X, np.eye(5) * 0.5 + 0.5

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_matches_unsharded_divisible(self, n_dev):
        X, C = self._divisible()
        ic = ImanConover().set_target(C)
        base = np.asarray(ic(X))
        sharded = np.asarray(_under(n_dev, lambda: ic(X)))
        # 16 rows over 2, 4 or 8 shards: no padding, the same products.
        np.testing.assert_array_equal(base, sharded)

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_matches_unsharded_padded(self, n_dev):
        X, C = self._padded()
        ic = ImanConover().set_target(C)
        base = np.asarray(ic(X))
        sharded = np.asarray(_under(n_dev, lambda: ic(X)))
        np.testing.assert_allclose(base, sharded, rtol=1e-4, atol=1e-5)
        for k in range(5):
            np.testing.assert_array_equal(
                np.sort(sharded[:, k]), np.sort(X[:, k].astype(np.float32))
            )

    def test_filler_rows_are_the_jax_hash(self):
        # The JAX package's filler (correlation.py, _apply_rows_sharded),
        # written out in jnp on uint32 words.
        rows, n = 3, 1000
        idx = jnp.arange(rows * n, dtype=jnp.uint32).reshape(rows, n) + jnp.uint32(0x9E3779B9)
        h = idx * jnp.uint32(0x85EBCA6B)
        h = (h ^ (h >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
        h = h ^ (h >> jnp.uint32(16))
        ref = (h >> jnp.uint32(8)).astype(jnp.float32) * (2.0**-24) + 2.0**-25
        from probabilit_tpu_torch.ops.correlation import _filler_rows

        got = _filler_rows(rows, n, torch.float32, CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@needs_devices
class TestAgainstJaxUnderMesh:
    """Each package under its own 8-shard CPU mesh, where the input fixes
    the result."""

    @pytest.mark.parametrize("method", ["sobol", "halton", "lhs"])
    def test_generate_sharded_matches_jax(self, method, monkeypatch):
        from test_torch_qmc import _owen_seeds, _round_keys

        key = jax.random.PRNGKey(3)
        n, d = 4096, 5
        with jax_use_mesh(jax_make_mesh()):
            ref = jax_qmc.generate_sharded(method, key, n, d)
            assert len(ref.sharding.device_set) == 8
        ref = np.asarray(ref)
        randomisation = {
            "sobol": lambda: _owen_seeds(key, d),
            "halton": lambda: np.asarray(jax.random.uniform(key, (d,), dtype=jnp.float32)),
            "lhs": lambda: _round_keys(key, d),
        }[method]()
        monkeypatch.setattr(qmc, "randomisation", lambda *a, **k: randomisation)
        blocks = _under(8, lambda: qmc.generate_sharded(method, 0, n, d, dtype=torch.float32))
        assert len(blocks) == 8 and all(b.shape == (n // 8, d) for b in blocks)
        np.testing.assert_array_equal(torch.cat(blocks).numpy(), ref)

    def test_sample_from_quantiles_matches_jax(self):
        jax_sink = jax_benchmarks.mixed_dag_20()
        mapping = interop.from_reference(jax_sink)
        sink = mapping[jax_sink._id]
        q = np.random.default_rng(4).random((4096, tcompile.get_plan(sink).d))
        with jax_use_mesh(jax_make_mesh()):
            jax_sink.sample_from_quantiles(q)
        _under(8, lambda: sink.sample_from_quantiles(q))
        for ref_node in jg.topological_sort(jax_sink):
            ref = np.asarray(ref_node.samples_)
            got = mapping[ref_node._id].samples_.numpy()
            assert got.shape == ref.shape
            scale = max(np.abs(ref).max(), 1e-30)
            assert np.abs(got.astype(np.float64) - ref).max() <= REL_TOL * scale
