"""K1's guide-indexed table search (``csrc/table_ops.cuh``) on the CPU.

``ops/table_search.py`` transcribes the device lookup: the word of cell
``floor(q M)`` of a table's guide (``cuda_exec.table_guide``), then a
branch-free search of the window of W boundaries that holds the cell, or
of the whole table for a cell of more than W.  Its counts are held to
``torch.searchsorted`` and to the JAX package's select tree
(``pallas_exec._select_tree``), and its values to the twin's rows
(``cuda_exec._table_row``), bitwise, on every table of ``large_table``,
``table_risk`` and ``table_risk_correlated``: at each boundary and its
float32 neighbours, at each cell edge j / M, at 0, 1 and NaN, on seeded
uniforms, at the tape's own M, at M = 1 (the full search) and at M = 4 and
2048 with windows of 1 to 8 (crowded and empty cells).  Then duplicate boundaries, a table of one
entry, the guide's words, and the shared-memory budget: guides shrink to
what a tape leaves (``guide_cells``), never change what ``supports``
decides or the Newton tier's groups, and are a function of the structure.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_table_kernel import _row

from probabilit_tpu.engine import pallas_exec
from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as tcompile
from probabilit_tpu_torch.engine import cuda_exec
from probabilit_tpu_torch.models import benchmarks
from probabilit_tpu_torch.models import graph as tg
from probabilit_tpu_torch.models.distributions import (
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
)
from probabilit_tpu_torch.ops import table_search
from test_torch_graph import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    previous = config.device()
    config.set_device("cpu")
    try:
        yield
    finally:
        config.set_device(previous)


_SIDE = {"TABLE_CDF": "left", "TABLE_DISCRETE": "right", "TABLE_INTERP": "right"}
_GRAPHS = {
    "large_table": lambda: benchmarks.large_table(),
    "table_risk": lambda: benchmarks.table_risk()[0],
    "table_risk_correlated": lambda: benchmarks.table_risk_correlated()[0],
}


def _tape(sink):
    plan = tcompile.get_plan(sink)
    return cuda_exec.lower(plan, [sink._id])


def _table_rows(tape):
    """(name, offset, boundaries, guide or None) of each table row."""
    guides = {dst: tuple(guide) for dst, *guide in tape.guides}
    return [
        (cuda_exec.OPCODES[op], b, c, guides.get(dst))
        for op, dst, a, b, c, d in tape.program
        if cuda_exec.OPCODES[op] in cuda_exec._TABLE_OPS
    ]


def _quantiles(bounds, cells, seed):
    """Each boundary and its float32 neighbours, each cell edge j / M and
    its neighbours, 0, 1, NaN and seeded uniforms (float32)."""
    b = bounds.numpy()
    edges = (np.arange(cells + 1) / cells).astype(np.float32)
    hits = np.concatenate([b, edges])
    up = np.nextafter(hits, np.float32(2.0))
    down = np.nextafter(hits, np.float32(-1.0))
    uniform = np.random.default_rng(seed).uniform(size=2048).astype(np.float32)
    q = np.concatenate([hits, up, down, [0.0, 1.0, np.nan], uniform]).astype(np.float32)
    return torch.from_numpy(q)


def _select_tree_count(q, bounds, strict):
    count = pallas_exec._select_tree(
        jnp.asarray(q.numpy()), [float(x) for x in bounds.numpy()],
        lambda i: jnp.full(q.shape, i, jnp.int32), strict)
    return torch.from_numpy(np.asarray(count).astype(np.int64))


def _held(name, tables, off, nb, q, guides, tree=True):
    """The transcription's counts through each of ``guides`` (None: the
    full search) against searchsorted and, with ``tree``, the select tree
    where q is a normal number or zero; its values against the twin's row.
    Returns each guide's loads a lane."""
    bounds = tables[off : off + nb]
    strict = name == "TABLE_CDF"
    number = ~torch.isnan(q)
    want = torch.searchsorted(bounds, q.contiguous(), side=_SIDE[name])
    # XLA's CPU code compares with denormals as zero (the neighbours of a
    # 0.0 boundary); the card and searchsorted do not.
    normal = number & ((q == 0) | (q.abs() >= torch.finfo(torch.float32).tiny))
    if tree:
        assert torch.equal(want[normal], _select_tree_count(q[normal], bounds, strict))
    twin = torch.from_numpy(_row(name, nb, tables[off:].numpy(), q.numpy()))
    loads = []
    for guide in guides:
        if guide is None:
            count, lane_loads = table_search.full_count(bounds, q, strict)
        else:
            start, cells, window = guide
            words = tables[start : start + cells].view(torch.int32).to(torch.int64)
            count, lane_loads = table_search.guided_count(bounds, words, cells, window, q, strict)
            lane_loads = lane_loads + 1  # the guide's word
        assert torch.equal(count[number], want[number])
        value, _ = table_search.lookup(name, tables, off, nb, q, guide)
        assert torch.equal(value.isnan(), twin.isnan())
        assert torch.equal(value[number], twin[number])
        loads.append(lane_loads)
    return loads


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_every_table_row_equals_searchsorted_the_select_tree_and_the_twin(graph):
    tape = _tape(_GRAPHS[graph]())
    rows = _table_rows(tape)
    assert rows and all(
        (guide is None) == (nb <= cuda_exec.GUIDE_WINDOW or nb < cuda_exec.GUIDE_MIN_BOUNDARIES)
        for _, _, nb, guide in rows)
    for i, (name, off, nb, guide) in enumerate(rows):
        q = _quantiles(tape.tables[off : off + nb], guide[1] if guide else 16, seed=i)
        *loads, full = _held(name, tape.tables, off, nb, q, [guide, None] if guide else [None])
        assert bool((full == (nb - 1).bit_length() + 1).all())  # M = 1: the full search
        # The guide: fewer loads than the full search on the uniforms for a
        # table of more than 8 boundaries.
        uniform = slice(len(q) - 2048, None)
        if nb > 8:
            assert loads[0][uniform].double().mean() < full[uniform].double().mean() - 2


def _occupancy(bounds, cells):
    edges = (np.arange(1, cells) / cells).astype(np.float32)
    return np.diff(np.concatenate([[0], np.searchsorted(bounds, edges), [len(bounds)]]))


@pytest.mark.parametrize("cells", [4, 2048])
def test_crowded_and_empty_cells(cells):
    # M = 4 crowds the cells of table_risk's tables; M = 2048 leaves most
    # empty: the count is the full search's for every window either way.
    tape = _tape(_GRAPHS["table_risk"]())
    held = set()
    for i, (name, off, nb, _) in enumerate(_table_rows(tape)):
        bounds = tape.tables[off : off + nb]
        held |= {"empty" if k == 0 else "one" if k == 1 else "many" if k > 16 else "few"
                 for k in _occupancy(bounds.numpy(), cells).tolist()}
        windows = [w for w in (1, 2, 4, 8) if w < nb]
        words = [torch.from_numpy(cuda_exec.table_guide(bounds.numpy(), cells, w)) for w in windows]
        tables = torch.cat([tape.tables, *words])
        starts = tape.tables.numel() + cells * np.arange(len(windows))
        q = _quantiles(bounds, cells, seed=10 + i)
        _held(name, tables, off, nb, q, [(int(a), cells, w) for a, w in zip(starts, windows)],
              tree=False)
    assert held >= ({"many"} if cells == 4 else {"empty", "one", "few"})


def test_duplicate_boundaries_and_a_single_entry():
    # A Discrete with zero probabilities has equal boundaries; the
    # right-hand value at a repeated boundary, as the select tree gives it.
    p = np.array([0.2, 0.0, 0.0, 0.3, 0.0, 0.5])
    values = np.arange(6.0) * 10
    nb, data = cuda_exec.discrete_layout(np.cumsum(p), values)
    bounds = torch.from_numpy(data[:nb])
    for cells, window in ((4, 1), (4, 2), (16, 1), (2048, 4)):
        guide = cuda_exec.table_guide(data[:nb], cells, window)
        tables = torch.from_numpy(np.concatenate([data, guide]))
        q = _quantiles(bounds, cells, seed=cells)
        _held("TABLE_DISCRETE", tables, 0, nb, q, [(len(data), cells, window)])
        got, _ = table_search.lookup("TABLE_DISCRETE", tables, 0, nb, q,
                                     (len(data), cells, window))
        number = ~torch.isnan(q)
        ref = np.asarray(pallas_exec._kernel_discrete(jnp.asarray(q.numpy()[number.numpy()]),
                                                      np.cumsum(p), values))
        np.testing.assert_array_equal(got[number].numpy(), ref)
    # One entry: no boundary, no guide, the value alone.
    node = DiscreteDistribution([7.0], [1.0])
    tape = _tape(node + 1.0)
    assert tape.guides == () and cuda_exec.guide_cells([0], 1 << 20) == [1]
    q = torch.tensor([0.0, 0.3, 1.0, float("nan")])
    value, loads = table_search.lookup("TABLE_DISCRETE", tape.tables, 0, 0, q)
    assert value[:3].tolist() == [7.0] * 3 and value[3].isnan() and loads.tolist() == [0] * 4


@pytest.mark.parametrize("nb", [2, 9, 64, 470, 511])
def test_the_layouts_give_one_guide_for_equal_boundaries(nb):
    bounds = np.sort(np.random.default_rng(nb).uniform(size=nb)).astype(np.float32)
    layouts = [
        cuda_exec.cdf_layout(np.append(bounds, np.float32(1.0))),
        cuda_exec.discrete_layout(np.append(bounds, 1.0), np.arange(nb + 1.0)),
        cuda_exec.interp_layout(np.append(bounds, 1.0), np.arange(nb + 1.0)),
    ]
    assert all(n == nb for n, _ in layouts)
    for window in (1, 2):
        cells = cuda_exec.guide_cells([nb], 1 << 20, window)[0]
        if nb <= window or nb < cuda_exec.GUIDE_MIN_BOUNDARIES:  # a full search of few loads
            assert cells == 1
            continue
        assert cells == min(2048, 1 << (cuda_exec.GUIDE_SPREAD * (nb + 1) - 1).bit_length())
        guides = [cuda_exec.table_guide(data[:n], cells, window) for n, data in layouts]
        for guide in guides[1:]:
            np.testing.assert_array_equal(guide.view(np.uint32), guides[0].view(np.uint32))
        # A cell of at most `window` boundaries starts its window at its
        # first boundary, or where the window ends at the table's end.
        words = guides[0].view(np.int32)
        edges = (np.arange(cells) / cells).astype(np.float32)
        lo = np.searchsorted(bounds, edges, side="left")
        occupancy = _occupancy(bounds, cells)
        np.testing.assert_array_equal(words < 0, occupancy > window)
        np.testing.assert_array_equal(words[words >= 0],
                                      np.minimum(lo, nb - window)[occupancy <= window])
        np.testing.assert_array_equal(words[words < 0] & 0xFFFF, lo[occupancy > window])


def test_guides_follow_the_structure_not_the_values():
    a, b = (_tape(benchmarks.table_risk(seed)[0]) for seed in (1, 2))
    assert a.guides == b.guides and a.source == b.source
    assert not torch.equal(a.tables, b.tables)
    spread = cuda_exec.GUIDE_SPREAD
    cells = cuda_exec.guide_cells([470, 511, 40, 8, 0], 1 << 20, window=4)
    assert cells == [min(2048, 1 << (spread * 471 - 1).bit_length()), 2048,
                     1 << (spread * 41 - 1).bit_length(), 1, 1]  # none for a small table
    # Shrinking halves the first of the largest; a guide of 4 cells goes.
    half = [cells[0] // 2, cells[1], cells[2]]
    assert cuda_exec.guide_cells([470, 511, 40], 4 * sum(half), 4) == half
    assert cuda_exec.guide_cells([470, 511, 40], 4 * 9, 4) == [1, 4, 4]
    assert cuda_exec.guide_cells([9], 4 * 4, 1) == [4]


def _empirical_sum(k, rng, corr=0):
    """k 512-point Empirical tables summed, beside ``corr`` correlated
    normals."""
    parts = [EmpiricalDistribution(rng.lognormal(size=512)) for _ in range(k)]
    sink = tg.Add(*parts)
    if corr:
        drivers = [Distribution("norm") for _ in range(corr)]
        sink = sink + tg.Add(*drivers)
        sink.correlate(*drivers, corr_mat=np.eye(corr) * 0.5 + 0.5)
    return sink


def test_a_tape_at_the_shared_memory_cap_keeps_k1_with_its_guides_shrunk():
    rng = np.random.default_rng(3)
    sink = _empirical_sum(22, rng, corr=16)
    plan = tcompile.get_plan(sink)
    assert cuda_exec.supports(plan, frozenset({sink._id}))
    tape = cuda_exec.lower(plan, [sink._id])
    base = tape.shared_bytes - 4 * tape.guide_floats
    assert base > cuda_exec.MAX_SHARED_BYTES - 8 * 1024  # within 8 KB of the cap
    cells = [c for _, _, c, _ in tape.guides]
    assert 0 < len(cells) < 22 or max(cells) < 1024  # shrunk
    assert tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES
    assert f"kTableFloats = {tape.tables.numel()};" in tape.source
    # One more table does not fit: refused as before, guides or not.
    over = _empirical_sum(23, rng, corr=16)
    assert not cuda_exec.supports(tcompile.get_plan(over), frozenset({over._id}))


def test_seven_tables_beside_a_correlated_group_keep_full_guides():
    sink = _empirical_sum(7, np.random.default_rng(4), corr=16)
    tape = _tape(sink)
    assert [c for _, _, c, _ in tape.guides] == cuda_exec.guide_cells([511] * 7, 1 << 20)
    assert tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES


def test_guides_take_no_shared_memory_from_the_newton_tier():
    rng = np.random.default_rng(5)
    sink = _empirical_sum(14, rng) + Distribution("gamma", 2.5) + Distribution("beta", 2.0, 3.0)
    tape = _tape(sink)
    bare = cuda_exec.Tape(tape.code, tape.imm, tape.n_slots, tape.d, tape.keep_order,
                          tape.n_corr, tape.program, tape.consts,
                          tape.tables[: tape.tables.numel() - tape.guide_floats])
    assert len(tape.newton_rows) == 2 and tape.newton_groups == bare.newton_groups == 6
    assert 0 < tape.guide_floats < 14 * 1024  # shrunk into what is left
    assert bare.shared_bytes < tape.shared_bytes <= cuda_exec.MAX_SHARED_BYTES
    assert "s_guide + " in tape.source and "newton_ops::solve" in tape.source


def test_four_blocks_an_sm_are_kept():
    # table_risk without guides lets four blocks share an SM; with them it
    # still does (the guides stay within a quarter of the SM's 228 KB).
    tape = _tape(_GRAPHS["table_risk"]())
    four = cuda_exec.SM_SHARED_BYTES // 4 - 1024
    assert tape.shared_bytes - 4 * tape.guide_floats <= four
    assert tape.shared_bytes <= four
    nbs = [nb for _, _, nb, _ in _table_rows(tape)]
    assert [c for _, _, c, _ in tape.guides] == [
        c for c in cuda_exec.guide_cells(nbs, 1 << 20) if c > 1]
    # A row with its guide prints its offset, cells and window, never a value.
    dst, offset, cells, window = tape.guides[0]
    assert (f"table_cdf<470>(s_tab + 0, v0_0, s_guide + {offset}, {cells}, {window})"
            in tape.source)


def test_transcription_matches_the_twin_on_a_lowered_tape():
    # table_risk's tape with every node kept: each Discrete and Empirical or
    # Cumulative row through the transcription equals the twin's output, on
    # the kernel's own draws.
    sink, nodes = benchmarks.table_risk()
    plan = tcompile.get_plan(sink)
    keep = frozenset([sink._id] + [n._id for n in nodes.values()])
    tape = cuda_exec.lower(plan, cuda_exec.keep_order(plan, keep))
    U = cuda_exec.philox_uniforms((5, 6), 1 << 12, plan.d)
    twin = cuda_exec.run_tape(tape, U)
    column = {dst: a for op, dst, a, *_ in tape.program if cuda_exec.OPCODES[op] == "DRAW"}
    stored = {a: k for op, k, a, *_ in tape.program if cuda_exec.OPCODES[op] == "STORE"}
    guides = {dst: tuple(guide) for dst, *guide in tape.guides}
    held = 0
    for op, dst, a, b, c, d in tape.program:
        name = cuda_exec.OPCODES[op]
        if name in ("TABLE_DISCRETE", "TABLE_INTERP") and dst in stored:
            value, _ = table_search.lookup(name, tape.tables, b, c, U[:, column[a]],
                                                guides.get(dst))
            assert torch.equal(value, twin[stored[dst]])
            held += 1
    assert held == 3
