"""The regime the claims register ``mcbench/configs/sii_nonlife12.json``
holds K1's table branch in.

Twelve correlated Poisson claim counts, each a ``TABLE_CDF`` row after
``NDTR`` on one tape at K = 12; tables small enough that shared memory
leaves every guide at the cells it would get with unlimited room; and
the twin of that tape against the plain executor's recolouring branch,
at the tolerances of ``test_torch_table_kernel.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mcbench import spec
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)

CONFIG = Path(__file__).resolve().parents[1] / "mcbench" / "configs" / "sii_nonlife12.json"
REL_TOL = 1e-4  # test_torch_table_kernel's
COUNT_SHARE_MAX = 1e-3  # test_correlated_table_twin_matches_the_generated_branch's


@pytest.fixture(autouse=True)
def on_the_cpu():
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


def _register():
    cfg, nodes = json.loads(CONFIG.read_text()), {}
    sink = spec.build_graph(cfg, nodes)
    counts = {node["name"]: nodes[node["name"]] for node in cfg["nodes"] if "family" in node}
    return cfg, sink, counts, tcompile.get_plan(sink)


def test_k1_takes_the_register():
    _, sink, counts, plan = _register()
    assert len(counts) == len(plan.corr_vars) == 12
    assert cuda_exec.supports(plan, frozenset({sink._id}))
    tape = cuda_exec.lower(plan, [sink._id])
    ops = [cuda_exec.OPCODES[row[0]] for row in tape.program]
    assert tape.n_corr == 12 and ops.count("RECOLOR") == 12
    assert ops.count("TABLE_CDF") == ops.count("NDTR") == 12


def test_the_repair_keeps_its_target():
    cfg, _, _, plan = _register()
    target = np.asarray(cfg["correlation"]["matrix"])
    np.testing.assert_allclose(plan.corr_matrix, target, atol=1e-12)


def test_shared_memory_leaves_its_guides_whole():
    _, sink, _, plan = _register()
    tape = cuda_exec.lower(plan, [sink._id])
    assert tape.shared_bytes <= cuda_exec.SM_SHARED_BYTES // 4 - 1024
    boundaries = {row[1]: row[4] for row in tape.program
                  if cuda_exec.OPCODES[row[0]] == "TABLE_CDF"}
    assert len(tape.guides) == 12
    for dst, _, cells, _ in tape.guides:
        assert cells == cuda_exec.guide_cells([boundaries[dst]], float("inf"))[0]


@pytest.mark.parametrize("words", [(7, 8), (2**32 - 5, 123456789)])
def test_its_twin_matches_the_plain_executor(words):
    _, sink, counts, plan = _register()
    keep = frozenset([sink._id] + [node._id for node in counts.values()])
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep))
    n = 1 << 14
    ab = cuda_exec.recolor_transform(plan, words, n, device="cpu")
    U = cuda_exec.philox_uniforms(words, n, plan.d)
    twin = cuda_exec.run_tape(tape, U, ab)
    out, flag = cuda_exec.run(tape.to("cpu"), words, n, ab)
    assert torch.equal(out, twin) and int(flag) == 0
    ref = tcompile.build_body(plan, keep, generated=True)(U)
    same = torch.ones(n, dtype=torch.bool)
    count_ids = {node._id for node in counts.values()}
    for k, nid in enumerate(tape.keep_order):
        if nid in count_ids:
            # A count: the recoloured quantile may cross a CDF step one
            # rounding of (A, b) apart.
            err = (twin[k] - ref[nid].float()).abs()
            assert err.max() <= 1 and (err > 0).float().mean() <= COUNT_SHARE_MAX, k
            same &= err == 0
    k = tape.keep_order.index(sink._id)
    want = ref[sink._id].float()
    assert (twin[k] - want).abs()[same].max() <= REL_TOL * want.abs().max()
