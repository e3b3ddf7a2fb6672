"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main paths through the hand-written CUDA kernels and
checks them: sampling, correlated sampling, the bitonic row sort,
streamed estimation, the distribution families and the table nodes.  The flagship path, ``mixed_dag_20().sample(1e8,
gc_strategy=[], executor="cuda")``, runs the graph megakernel, which
``engine/cuda_exec.py::generate`` writes per graph structure from the
hand-written headers in ``probabilit_tpu_torch/csrc``:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels with nvcc, one process per source, all started
   together: ``csrc/corr_stats.cu``, ``csrc/bitonic_sort.cu``,
   ``csrc/block_fold.cu`` and the generated megakernel of every graph and keep set the script runs
   (``generated_tapes``); prints each build's seconds and ptxas's registers and
   spill-store bytes per kernel instance;
3. samples the flagship graph at n = 1e8 and asserts that the kernel was
   launched, that the sink is finite, of shape (1e8,), and on the card;
4. holds the kernel against its plain PyTorch twin (``run_reference``:
   the same Philox bits, the same tape) at the main path's shape, and per
   node at n = 2^22;
5. KS-tests a normal through ``executor="cuda"`` against scipy's CDF, and
   compares the sink's mean and std with ``executor=None`` at 1e7;
6. times the kernel, its twin and both executors at 1e8 with CUDA events
   (median of 5 after one warm-up).

The correlated path, ``mixed_correlated_50().sample(1e8, gc_strategy=[],
executor="cuda")`` (NCM repair, then sort-free Iman-Conover), runs the
correlation-statistics kernel and the megakernel's recolour branch:

7. samples it at n = 1e8 and asserts that both kernels were launched and
   the sink is finite, of shape (1e8,), and on the card;
8. holds the statistics kernel against its twin (each sum within 1e-5 * n)
   and the recoloured megakernel against its twin given the same
   recolour transform (1e-4 of max |twin| per kept node), at 1e8 and per
   node at 2^22;
9. checks at 1e7 that the three normal drivers' sample correlation is the
   repaired target within 2e-3 (their values are linear in the
   recoloured scores), and that the sink's mean and std through
   ``executor="cuda"`` and ``executor=None`` agree within 5 standard errors;
10. times both kernels, their twins, both executors and the host share at
    1e8, and the recolour transform with its K x K solve on the host
    (what ``sample`` does) and on the card; then the statistics kernel
    alone at every K from 1 to 16 (columns 3 j + 1) at 1e8: its sums
    within 1e-5 * n of the twin and bitwise equal on a repeat, its time
    beside the ``OP_COST`` bound and the bound re-priced with the cross
    products on the tensor cores (three TF32 products at the dense TF32
    rate), the blocks an SM holds, and one 2^24 block at start 2^24.

The sort path, ``ops/bitonic_sort.bitonic_sort_rows`` (kernels K3, K4 and
K5 of ``csrc/bitonic_sort.cu``):

11. sorts (50, 1e7) float32 keys carrying an int32 payload, the shape of
    the JAX package's Iman-Conover timing, and asserts each kernel was
    launched as often as the plan says (K3 once for stages 1..14, then
    per stage 15..24 the K4 passes and the K5 tail of ``_merge_plan``: 1,
    15 and 10 times), that the keys equal ``torch.sort``'s and the
    payloads are a permutation, each pointing at its key; runs the kernels
    and their twin side by side on the same padded inputs, through the
    same step groups (K3's through ``sort_tiles_reference``), and holds
    every one of the 26 launches against the twin bitwise (keys and
    payloads), and the call's output against the twin's; then the whole
    call bitwise at the ``SORT_CHECKS`` shapes (8+8-byte keys and
    payloads, whose tile is 2^13, and rows of two blocks, 2^14, sorted by
    K3 alone, among them), and ``sort_runs`` (64 and an odd 63 runs) and
    a whole and a partial ``merge_stage`` alone; times the sort, each
    kernel's share, ``torch.sort`` plus a gather of the payload for the
    call and for K3's work (every 2^14 tile of the padded rows), and a
    copy of the padded keys and payloads (what one tail reads and writes)
    at (50, 1e7) and at the streamed estimator's (128, 2^17), checked
    launch by launch too; and times K3 alone for each width of keys and
    payloads (``K3_TYPES``) at both shapes: at a 2^14 tile where it fits
    and at 2^13 followed by K5's stage 14, the same stages 1..14, held
    equal bitwise and timed in turns.

The streamed path, ``estimate`` and ``sample_streaming``:

13. (run before phase 11) holds both kernels at a ``start`` and an ``n``
    that are no multiples of 4 against their twins (the tolerances of
    phases 4 and 8; the Newton family graph's as phase 14 holds them) and
    K1's rows bitwise against the rows of a longer run from sample 0 (the
    float4 path), down to n = 1, for ``mixed_dag_20``,
    ``mixed_correlated_50`` and the Newton family graph; and runs two
    graphs that differ only in their constants, which must share one
    library and each match its own twin.

12. ``mixed_dag_20().estimate(1e9, quantiles, cvar, histogram)`` with
    ``executor="auto"`` must launch K1 once per 2^24-block (60 times), its
    mean and std must agree with a single-shot ``sample(1e8)`` within 5
    standard errors and its histogram must count n; K1 (and K2) on block
    1 (``start`` = 2^24) must match their twins at the tolerances of
    phases 4 and 8; ``sample_streaming(2^26, executor="cuda")`` must equal
    ``sample(2^26)`` bitwise; the same estimate of ``mixed_correlated_50``
    must launch K2 and K1 60 times each, and its three normal drivers,
    streamed at 1e7 (the block program of ``sample_streaming`` with the
    drivers kept), must carry the repaired target within 2e-3.  Both
    estimates must launch the fold kernel (``csrc/block_fold.cu``) once
    a block; on block 1's sink the kernel must match its twin
    (``streaming._block_moments`` and ``_merge``: every float64 field
    within 1e-10 of its scale, the count, min, max and finite flag
    equal), from an empty carry and from one holding K1's block 0, and a
    repeat must be bitwise equal, with moments off and on, a float32
    control and a float32 and a bool ``where=`` condition; each case is
    timed (on four copies of the block in turn, so the L2 holds none of
    the next) beside the twin and the bytes it reads at 3.35 TB/s, and
    ``torch.sum`` of the block beside them.  Each estimate is timed at
    1e9 with quantiles on and off, with its host share (wall - kernel
    time) / wall, the kernel time counting K1, K2 and the fold a block;
    the correlated one with each block's recolour system solved on the
    card and on the host.

The parametric families (K1's family branches, ``csrc/ppf_ops.cuh`` and
``csrc/special_ops.cuh``):

14. ``benchmarks.family_graphs()``: the 72 family branches beside the
    first five, in five graphs of at most 15 family nodes (four of closed
    forms, one of the incomplete gamma/beta Newton families), each summed
    into its sink, at the parameters of the JAX package's family sweep.
    Each is sampled at 1e8 through ``sample(executor="cuda")`` (K1 must
    launch; the sink finite); each kept node is held against the twin at
    n = 2^22 within 1e-4 of its largest value (a Newton node on the samples
    whose uniforms lie in [0.001, 0.999], the sink of the Newton graph
    there within the sum of its terms' tolerances; the whole range is
    printed); each family's column at 2^20 (one keep-all sample) is
    KS-tested against ``scipy.stats`` (a chi-square test for bernoulli,
    geom and randint), p > 1e-4 each; K1 of each graph is timed at 1e8
    with its bound (``OP_COST``: a Newton op at the twin's mean trip count
    on the phase's draws times one trip's floating-point operations), the
    twin at 2^22.  The Newton graph adds ``sample_streaming`` against
    ``sample`` (2 blocks of 2^24 and a partial one) bitwise, and a second
    bound re-priced at the Newton tier's own counts (the series terms and
    fraction pairs its stopping rule takes on the same draws, counted by
    ``engine/newton_tier.py``); each of the 15 Newton families alone (one
    node a graph) is timed at 1e8 with both bounds and its counts.  The
    closed forms (``csrc/fast_math.cuh`` under ``csrc/ppf_ops.cuh``): every
    rewritten family node of the four closed-form graphs is held at 2^22
    against its PyTorch transcription (``ops/fast_math.py``) as against
    the twin; the four graphs' kernels (sink only and all nodes) must hold
    no ``CALL`` and no ``STL``/``LDL`` in their SASS (``cuobjdump -sass``,
    counted with ``MUFU`` and printed with ptxas's registers, beside
    ``mixed_dag_20``'s and the portfolio's); and each of the eleven
    families that ``torch.distributions`` inverts (``LIBRARY_FAMILIES``)
    alone: K1 at 1e8 with its bound beside the library's ``icdf`` plus loc
    on the same uniforms (drawn beforehand; the largest difference is
    printed, not checked: the library computes its own formula), K1
    against the twin and the transcription at 2^22.  The plain path's
    float32 incomplete beta on the card: ``special.betainc(15, 0.5, 1 -
    2^-24)`` must equal the CPU's within 1e-6 (x clamped at the last float
    below 1, not at the kernel's 1 - 1e-7, which gives 1 - 0.0014964), and
    ``ppf.call("t", band, 30.0)`` on 4,001 uniforms in [0.499, 0.501]
    must be 0 on as many of them as on the CPU (1,917).
15. ``benchmarks.portfolio_var()``, the correlated portfolio of
    ``examples/03_portfolio_var.py`` (a t(df = 4), a lognormal and a
    normal; the analyst's guess repaired by ``nearest_correlation_matrix``):
    ``sample(1e8, executor="cuda")`` must launch K2 and K1; K2's sums and
    K1's rows (t branch included) are held against their twins; the three
    drivers' normal scores (the t's through scipy's CDF on the host, then
    ``ndtri``) must carry the repaired target within 2e-3 at 1e7; the
    sink's mean and std through ``cuda`` and ``None`` must agree within 5
    standard errors; K1 launched block by block as ``estimate`` launches
    it (3 blocks of 2^24 and a partial one) must equal one launch over the
    same rows bitwise, given one recolour transform; ``estimate(1e9,
    quantiles=(0.01, 0.05, 0.5), executor="auto")`` must launch K1 and K2
    60 times each and agree with the one-shot run within 5 standard
    errors; both calls are timed, with the host share, and K1 with both
    bounds (phase 14's).

The table branch (K1's ``TABLE_CDF``, ``TABLE_DISCRETE`` and
``TABLE_INTERP`` rows, ``csrc/table_ops.cuh``) and the plain path's table
tiers:

16. ``benchmarks.large_table()`` (bench.py's 471-knot
    ``poisson(mu=2000) + 0.0``) through ``sample(executor="cuda")`` at 1e8
    and 4e8, each timed (median of 5) with the slope in ns/sample between
    the two; K1 bitwise against its twin at 2^22; the column chi-squared
    against ``scipy.stats.poisson(2000)`` at 2^20; K1 at 1e8 with its
    bound and, as the library call, ``torch.searchsorted`` of 1e8
    uniforms drawn beforehand plus loc.  ``benchmarks.table_risk()`` (a
    Poisson, a binomial, a negative binomial, the generic hypergeom
    table, a 512-value Discrete, a 512-point Empirical and an elicited
    Cumulative on one tape) at 1e8: every table node bitwise against the
    twin at 2^22, the sink within 1e-4; each column against its exact law
    at 2^20 (chi-square, or KS against the piecewise-linear CDF), p >
    1e-4; ``cuda`` against ``None`` within 5 standard errors at 1e7; K1
    timed with its bound, registers, spills and shared-memory bytes.
    Each table graph's K1 also beside the bound re-priced for the
    guide-indexed search (``table_prices``: its shared-memory wavefronts
    as ``ops/table_search.py`` counts them on the twin's quantiles at
    2^22, held bitwise to the twin's rows).
    ``benchmarks.table_risk_correlated()`` (an Empirical, a Cumulative and
    a Poisson driver correlated with a normal one): K2 and K1's recolour
    branch into the table rows against their twins (the count within 1 on
    at most 1e-3 of the samples, its quantile having gone through the
    hardware's ``ndtr_fast``; the rest within 1e-4 where the counts
    agree), its three tables drawn directly (``correlated_tables_drawn``)
    bitwise against the twin at 2^22, the drivers' normal scores (through
    their exact CDFs; the count's correlation with them scaled by
    corr(F^-1(Phi(Y)), Y)) on the
    repaired target within 2e-3 at 1e7, ``cuda`` against ``None`` and
    streamed ``estimate(1e9)`` against one-shot within 5 standard errors,
    each timed with its host share.  The plain path on the card at 1e7:
    ``bird_survival()``'s mean 1.2 within 5 standard errors (and
    ``executor="cuda"`` refuses its composite binomial), ``skewnorm(3)``
    through its PCHIP table KS-tested against scipy's CDF, a string
    ``DiscreteDistribution`` through ``sample`` and ``sample_streaming``
    (its values' shares within 5 standard errors), and ``estimate`` on it
    refused.

The typed path (K1's int32 and bool values) and the sequential and
checkpointed estimates:

17. ``benchmarks.typed_ops()`` (every int32 and bool operation at the
    int32 extremes, 49 exact leaves, run 15 at a time beside the sink): K1
    bitwise against its twin at 2^22 on every kept node.
    ``benchmarks.breach_count()`` and ``breach_count_correlated()``:
    ``sample(1e8, executor="cuda")`` must launch K1 (and K2) with a finite
    sink; K1 against the twin at 2^22 on the kept nodes (overruns, late,
    tier, loss; severe on its own graph): each int and bool node equal but
    on at most 1e-4 of the samples and off by at most 1 there (a cost
    within K1's rounding of its budget), the float nodes within 1e-4 of
    their largest value where every int and bool node agrees.  Then
    ``breach_count`` at 1e8, sink only: ``sample`` and K1 alone (CUDA
    events, median of 5) beside the bound (``OP_COST``, the int32 ops
    priced by the SASS instructions nvcc emits for them, counted in this
    run by ``int_op_sass``), the twin at 2^22, registers and spills.  The
    streamed estimates: ``estimate(severe)`` and ``estimate(overruns,
    histogram)`` at 2^26 through ``executor="cuda"`` and ``None``, against
    each other within 5 standard errors and, uncorrelated, against the
    exact law (a sum of ten independent Bernoullis: P(severe) and the
    histogram's chi-square, p > 1e-4);
    ``estimate(severe, 2^24, target_rel_sem=2e-4, executor="auto")``
    (wall time, rounds, converged; ``cuda`` against ``None`` within 5
    standard errors); the two calls of ``examples/03_portfolio_var.py`` on
    ``portfolio_var()`` at the example's sizes (the sequential
    ``target_rel_sem=0.005`` estimate and the checkpointed 2^24 one), each
    timed, ``cuda`` against ``None`` within 5 standard errors; and a
    checkpointed ``estimate(loss, 1e9, quantiles=(0.5, 0.99),
    checkpoint_every=2^26)`` interrupted after its first two segments (by
    wrapping ``streaming._estimate_carry`` from here), resumed, and held
    bitwise to an uninterrupted run, both timed.

The quantile layer beyond iid uniforms (plain PyTorch on the card: the
megakernel refuses ``method=`` and the copula nodes, as the TPU kernel
does):

18. ``mixed_dag_20().sample(1e8, gc_strategy=[], method=m)`` for sobol,
    halton, lhs and antithetic: the sink finite, of shape (1e8,), on the
    card; each call timed (CUDA events, median of 5) and
    ``ops/qmc.generate`` alone beside it (median of 3).  ``generate`` on the card bitwise against the same call
    on the CPU at 2^22 rows from an offset of 2^31 + 3 (Halton, int32
    indexed, from 2^31 - 2^22 - 5), ``sample_streaming(2^26, method=m)``
    bitwise against ``sample(2^26, method=m)``'s sink; ``estimate(2^28,
    method="sobol", replicates=8)`` against ``method=None`` within 5
    standard errors, its between-replicate sem below the iid sem, and
    ``estimate(1e9, method="sobol")`` in blocks of 2^24 timed; a
    checkpointed ``estimate(2^26, method="lhs")`` interrupted after its
    first segment, resumed, and held bitwise to an uninterrupted run.  The
    copulas at 1e7 (Clayton(2, d=3), Gumbel(2), Frank(20), Frank(-5),
    Gaussian, t(df=4), empirical), each marginal shaped by a
    ``QuantileTransform`` and summed: Kendall's tau of the first two
    uniforms at 2^16 within 0.02 of the closed form, each uniform marginal
    KS-tested against U(0, 1) at 2^20 (p > 1e-4), each graph timed with the
    column-keyed generator's host read.  The Dirichlet and multinomial
    marginals' means within 5 standard errors at 1e7, and
    ``executor="cuda"`` refusing each of these graphs.

Joint estimates of several nodes (``estimate_many``: the plain executor
on the card, as the JAX package runs XLA there: the kernels refuse its
``NoOp`` sink, so K1 must not be launched by it):

19. ``estimate_many`` of ``mixed_dag_20``'s sink and the seven
    non-constant nodes nearest it at 1e9 in blocks of 2^24, with
    quantiles, CVaR, a histogram, moments and covariance: each node's
    mean within 5 standard errors of its own ``estimate(node, 1e9)``, each
    histogram counting n, ``cov`` symmetric, ``corr``'s diagonal 1, the
    carries on the card; ``estimate_many(2^26, method="sobol")`` against
    float64 statistics of one ``NoOp(*nodes).sample(2^26,
    method="sobol")`` (n equal, min and max bitwise, mean, var and each
    ``cov`` entry within 1e-9 relative, the histograms equal to the bin
    rule on the draws); ``portfolio_model(d=10)``'s assets and total,
    recoloured per block (at 1e9 if a call's forecast from 2^26 is under
    20 s, else at 2^28): the total's mean within 1e-6 relative of the
    assets' means' sum, its variance within 1e-5 of the sum of their
    covariance block, the assets' correlations within 2e-3 of the repaired
    target's image under the lognormal map; ``target_rel_sem=1e-4`` on
    ``mixed_dag_20``'s nodes (every node meets it); a checkpointed
    ``estimate_many(1e9)`` interrupted after two segments (by wrapping
    ``streaming._many_carry``), resumed, equal key by key to an
    uninterrupted run; ``executor="cuda"`` refusing ``estimate_many`` and
    a scalar transform; ``scalar_transform(x * y + 1)`` at 1e8 within 1
    float32 ulp of the operators' graph, an untraceable function at 1e4
    through the host loop, its warning and its result on the card.
    Timings (host clock, median of 3): ``estimate_many`` at 1e9 beside the
    sum of the separate ``estimate`` calls, and both scalar transform
    rates.

The path processes (plain PyTorch on the card: neither package's kernel
takes a path node, so neither K1 nor K2 may be launched here):

20. ``bench.py::bench_paths`` in the port: the up-and-out barrier call at
    130 on ``GeometricBrownianMotion(s0=100, mu=0.03, sigma=0.2,
    steps=252)``, 2^21 paths streamed in blocks of 2^16 through
    ``estimate(executor="auto")`` (host clock, median of 3 after one warm
    call; G path-elements/s): the terminal's mean within 5 SE of
    100 e^0.03, the discounted vanilla call within 5 SE of Black-Scholes,
    ``examples/06``'s Asian call with the vanilla as control tighter than
    without; ``examples/09``'s three-desk ``CorrelatedMerton`` book (64
    steps, the common jump stream, 704 slab columns) through
    ``estimate_many`` of the three losses and the total at 2^22 in blocks
    of 2^19, ``method="sobol"``, ``replicates=8`` (timed after one warm
    call): each desk's mean loss
    within 5 SE of its closed form, the total's mean the desks' sum to
    1e-9 relative; each of the 15 factories (``benchmarks.path_families``,
    252 steps) sampled one-shot at 2^20 paths (2^18 for the joint and
    stochastic-volatility ones): the terminal's mean, and its variance
    where a closed form exists, within 5 SE; one slab of 2^10 rows on the
    card and on the CPU, every path within 1e-4 of its largest magnitude;
    the time-axis scan (``processes.time_cumsum``) and the bridge's
    product giving a row the same bits in 2^18-row calls as in 2^16-row
    blocks (``torch.cumsum`` along the last axis beside them, reported,
    with each op's ms a block); streamed Sobol runs of a GBM and a
    Merton functional bitwise against one shot; ``executor="cuda"`` refusing a path graph; and
    ``torch.profiler`` over one 2^16-path block of GBM, OU, CIR, Heston,
    the Milstein SDE and the Markov chain, and one 2^19-path block of the
    book: device ms, kernel launches, the idle share and the top kernels.
21. ``sensitivity`` and ``sobol_indices`` (``engine/sensitivity.py``:
    ``torch.autograd`` through the plain executor, no kernel) on
    ``mixed_dag_20``'s sink with respect to its 8 distributions' 16
    parameters: one shot at 2^24 (wall and device ms, idle share, peak
    memory), and at 2^20 the card against the CPU on one quantile matrix
    (each gradient within 1e-4 of max(1, |gradient|)) and against central
    differences of ``sample_from_quantiles`` in float64 on that matrix
    (within 1e-4, a step of 1e-6 of max(1, |parameter|)); one shot of
    q0.95 at 2^25, past ``torch.quantile``'s 2^24 (finite); the Sobol
    sequence's gradients streamed in 2^16 blocks against one shot at 2^20
    (within 1e-4 of max(1, |gradient|), the JAX package's tolerance,
    float32 sums in other orders); streamed at
    2^28 in blocks of 2^24 for the mean (its value against
    ``estimate(executor=None)`` on the same blocks, within 1e-6) and for
    cvar0.95, their peak memory within twice one block's; a
    checkpointed run cut after its first segment and resumed, bitwise
    against the uninterrupted checkpointed run; ``bench_paths``' GBM
    Greeks (delta and d/dmu of the terminal mean, 2^20 paths of 252 steps
    in 2^16 blocks, 8 replicates) within 5 replicate SEs of e^{mu T} and
    s0 T e^{mu T}; Sobol' indices at 2^20 under ``method="sobol"`` (wall
    ms, peak memory), the card against the CPU on the same A and B at
    2^16 (the moments within 1e-5 relative, each index within 1e-4), and
    the Ishigami function's indices within 0.01 of their closed forms at
    2^15; K1 and K2 launched 0 times in the phase.
22. ``sweep``, ``tilted`` and ``mlmc_estimate`` (``engine/sweep.py``,
    ``importance.py``, ``mlmc.py``: the plain executor, no kernel takes
    their graphs), each result with its wall and device ms, kernel
    launches, idle share and peak memory over the call's start: a
    64-point common-random-numbers ladder of ``mixed_dag_20``'s price
    scale at 2^20 draws (mean, q0.95, cvar0.95; the mean monotone; one
    batched evaluation, as ``sweep._batchable`` decides), an 8 x 8
    meshgrid of its shape and scale and 8 of the ladder's scales on
    independent streams (the loop), the card against the CPU on one
    quantile matrix for four scenarios (within 1e-4 of max(1, |value|)),
    beside one scenario's evaluation; the ladder streamed at 2^24 draws a
    scenario in 2^20 blocks, scenarios 0 and 63 against
    ``estimate(executor=None)`` with the scale set by hand (within 1e-6);
    ``examples/04``'s three ``sweep`` calls on ``build_project_cost`` (the
    ladders monotone, the sequential one converged); ``examples/08``'s
    P(Z < -6) by a lower tilt at 10^6 and 2^24 draws, within 4 SE of
    ``norm.cdf(-6)``; ``examples/07``'s Milstein ``mlmc_estimate`` at eps
    0.02 and the README's Euler call at eps 0.01, within 3 eps of
    e^{rT} x Black-Scholes, with their levels, samples a level, cost
    against plain MC and one block's launches a level; K1 and K2
    launched 0 times in the phase.
23. ``american_price``/``american_greeks``, the Student-t copula and the
    permutation correlator (``engine/american.py``,
    ``ops/correlation.StudentTCopula``, ``ops/permutation.py``: the plain
    path, no kernel), each result with its wall ms and peak memory, and
    launches, device ms and idle share from ``torch.profiler`` (for the t
    copula one 2^24 block, for the permutation climb 10 iterations): the
    Longstaff-Schwartz 2001 table 1 puts (GBM, K = 40, r = 0.06, 50
    dates, s0 = 36 / 40 / 44) at 2^20 paths, each within 0.04 of 4.478 /
    2.314 / 1.110 and below it + 3 SE, and one fit alone for its launches
    a date; Ikonen-Toivanen's Heston put (s0 = 9, K = 10, r = 0.1, T =
    0.25, 50 dates) at 2^18, the joint basis more than 3 SE above the
    asset basis and within [0.985 x 1.1080, 1.1080 + 3 SE];
    Andersen-Broadie's two-asset Bermudan max-call (degree 5, Sobol) at
    2^17 within [13.902 - 4 SE, 13.934 + 2 SE]; the ATM put's Greeks at
    2^18 (16 dates) against central differences of ``american_price`` on
    common seeds (delta within 0.02, vega within 5%, rho negative); one
    2^14-path fit and evaluation on the card and on the CPU from the same
    increments (the first solve's weights within 1e-3 of its largest; the
    card's policy applied on both, at most 1e-3 of the paths moved and the
    price over the rest within 1e-4 relative; the two whole prices within
    0.5 SE: one flipped decision moves every earlier date's carry);
    ``mixed_correlated_50`` under
    ``correlator="tcopula"`` one-shot at 1e8 (and 1e7 when 1e8 peaks
    over 40 GB), Kendall's tau of two drivers within 0.01 of (2/pi)
    arcsin(rho), the sink's 99.9% quantile above the Gaussian copula's on
    the same seed, and streamed at 2^28 in 2^24 blocks; the permutation
    correlator on a (10^5, 10) matrix, 1,000 iterations, columns still
    permutations, its error reported; K1 and K2 launched 0 times in the
    phase.
24. The sample-axis mesh and the profiling utilities
    (``parallel/mesh.py``, ``utils/profiling.py``), run after phase 19,
    before the profiler sessions of phases 20-23 (after phase 23's, a
    short session has recorded no kernel on the H100 machines the script
    was run on): (a) under
    ``make_mesh()`` (every card; the device count is printed) and under
    four shards on ``cuda:0``, each against the same call without a mesh,
    with both wall ms (reported, not a claim): ``mixed_dag_20``'s
    ``sample(2^24)`` iid and Sobol bitwise, ``mixed_correlated_50``'s iid
    and Sobol within 1e-3, ``estimate(2^26)`` with quantiles and CVaR
    bitwise (``executor="auto"`` under the mesh, the plain executor
    without), the README's Euler ``mlmc_estimate`` at eps 0.01 (the same
    samples a level, the mean within 1e-4), a Longstaff-Schwartz put at
    2^16 paths (within 3 SE), the 16 gradients of ``mixed_dag_20`` at 2^20
    (within 1e-5 relative) and an 8-point ladder at 2^20 bitwise;
    ``executor="cuda"`` must raise the mesh message; K1 and K2 launched 0
    times there.  (b) ``trace()`` around one ``sample(1e8,
    executor="cuda")``: the trace file is written under
    ``build/chip_smoke_trace_<attempt>`` and names K1 (up to three
    traces: a short session's kernel records are sometimes lost, each
    attempt's kernel events are printed); ``PROBABILIT_TPU_PROFILE=1``
    on both executors prints the header and the build+compile, execute
    and host phases, their sum within the call's wall time;
    ``compiled_stats`` of the plain body at 2^20 (flops, bytes, peak
    bytes).

Every line but the last is one JSON object; the line before the last
holds the kernels' record, with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over the card's rates (integer
instructions at 132 SMs x 64 lanes x 1.98 GHz; float32 operations, an FMA
counting two, at 67 TFLOP/s), counted per sample by ``OP_COST`` below; a
draw costs a quarter of a Philox call, whatever implements it.
The sort kernels' entries are per call of ``bitonic_sort_rows`` at
(50, 1e7), summed over each kernel's launches: its time, its twin's for
the same steps, and its bound: for K3 one read of the padded keys and
payloads and one write of each slot it changes (it works in place); for
each merge stage one read and a write of each slot the stage changes,
shared between K4 and K5 by the bytes their launches move in it; the
library call is ``torch.sort`` plus a gather, of every tile for K3, of
the whole rows for K4 and K5.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero.  It needs the repository beside it and a CUDA card.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_MAIN = 100_000_000
N_NODES = 1 << 22
N_KS = 500_000
N_MOMENTS = 10_000_000
REL_TOL = 1e-4  # per kept node: max |kernel - twin| <= REL_TOL * max |twin|
STATS_TOL = 1e-5  # per sum of n terms of magnitude ~1: |kernel - twin| <= STATS_TOL * n
FOLD_TOL = 1e-10  # the fold kernel's float64 fields against the twin's, each of its scale
CORR_TOL = 2e-3
KS_P_MIN = 0.01
SE_MAX = 5.0
SOURCES = ("corr_stats", "bitonic_sort", "block_fold")  # csrc/<name>.cu; K1 is generated per graph
N_UNALIGNED = (5, (1 << 22) + 3)  # a start and an n that are no multiples of 4
SORT_MAIN = (50, 10_000_000)  # the JAX package's Iman-Conover timing shape
SORT_ROWS = (128, 1 << 17)  # one 2^24 block of the streamed quantile estimator
SORT_CHECKS = (  # (K, N, key dtype, payload dtype)
    (3, 100_000, "float32", "int32"),
    (4, 10_000_000, "float32", "int32"),
    (4, 3_000_000, "float64", "int64"),  # 8+8 bytes: the tail's tile is 2^13
    (5, 12_000, "float32", "int32"),  # n_blocks = 2: stage 14 is a lone tail
    (5, 12_000, "float64", "int64"),
)
K3_TYPES = (  # (key dtype, payload dtype): K3 timed alone for every pair width
    ("float32", "int32"),
    ("float32", "int64"),
    ("float64", "int32"),
    ("float64", "int64"),
)
N_STREAM = 1_000_000_000
BLOCK = 1 << 24
N_FAMILY_KS = 1 << 20
FAMILY_P_MIN = 1e-4
# The eleven families torch.distributions inverts (its icdf), each alone at
# these parameters (FAMILY_SWEEP's where it has the family): phase 14 times
# K1 of each beside the library call on the same uniforms.
LIBRARY_FAMILIES = {
    "norm": ((), {"loc": 1.0, "scale": 2.0}),
    "lognorm": ((0.5,), {"scale": 2.0}),
    "uniform": ((), {"loc": 1.0, "scale": 2.0}),
    "expon": ((), {"scale": 2.0}),
    "cauchy": ((), {"loc": 1, "scale": 2}),
    "laplace": ((), {"loc": 0, "scale": 1.5}),
    "gumbel_r": ((), {"loc": 1, "scale": 2}),
    "pareto": ((2.5,), {}),
    "weibull_min": ((1.7,), {"scale": 2}),
    "halfnorm": ((), {"scale": 1.5}),
    "halfcauchy": ((), {}),
}
CLOSED_FORM_GRAPHS = tuple(f"closed_form_{i}" for i in range(4))
T_BAND_ZEROS = 1917  # the plain float32 t(30) ppf's zeros on 4,001 uniforms in [0.499, 0.501]
NEWTON_CENTRAL = (0.001, 0.999)  # the uniforms on which a Newton node is held to its twin
PORTFOLIO_QUANTILES = (0.01, 0.05, 0.5)
TYPED_SHARE_MAX = 1e-4  # int and bool nodes of K1 and the twin may differ on this share
N_TYPED_STREAM = 1 << 26
CHECKPOINT_EVERY = 1 << 26
QMC_METHODS = ("sobol", "halton", "lhs", "antithetic")
QMC_OFFSET = (1 << 31) + 3  # generate on the card against the CPU from here
HALTON_OFFSET = (1 << 31) - (1 << 22) - 5  # Halton's float32 indices are int32
LHS_TOTAL = QMC_OFFSET + (1 << 22) + 12345  # strata of no power of two: the walk runs
N_QMC_STREAM = 1 << 26
N_QMC_ESTIMATE = 1 << 28
N_COPULA = 10_000_000
MANY_QUANTILES = (0.05, 0.5, 0.95)
MANY_CVAR = (0.95, 0.99)
MANY_HISTOGRAM = (-2e4, 1.5e5, 100)  # mixed_dag_20's nodes, under- and overflow beside
N_MANY_EXACT = 1 << 26
MANY_EXACT_TOL = 1e-9  # relative: float64 folds of float32 draws against float64 statistics
PORTFOLIO_S = 0.2  # portfolio_model's lognormal shape (benchmarks.py)
PORTFOLIO_MEAN_TOL = 1e-6  # the total's mean against the assets' means' sum, relative
PORTFOLIO_VAR_TOL = 1e-5  # the total's variance against the covariance block's sum, relative
PORTFOLIO_SECONDS_MAX = 20.0  # the portfolio runs at 1e9 if a call's forecast is under this
N_PORTFOLIO_SMALL = 1 << 28
MANY_REL_SEM = 1e-4
N_SCALAR = 100_000_000
N_HOST_LOOP = 10_000
N_TAU = 1 << 16
N_UNIFORM_KS = 1 << 20
TAU_TOL = 0.02
N_PATHS = 1 << 21  # bench.py::bench_paths
PATHS_BLOCK = 1 << 16  # 2^16 paths x 252 steps x 4 bytes: 66 MB of path matrix a block
N_BOOK = 1 << 22  # examples/09's desk book
BOOK_BLOCK = 1 << 19
N_FAMILY_PATHS = 1 << 20
N_FAMILY_PATHS_SMALL = 1 << 18  # the joint and stochastic-volatility families
SMALL_PATH_FAMILIES = ("correlated_gbm", "correlated_merton", "correlated_heston", "heston",
                       "cox_ingersoll_ross")
N_PATH_SLAB = 1 << 10  # rows of the slab held on the card against the CPU
PATH_TOL = 1e-4  # of each path's largest magnitude (the CPU parity tolerance)
N_PATH_STREAM = 1 << 18
BOOK_TOTAL_TOL = 1e-9  # the total's mean against the desks' means' sum, relative
PROFILED_PATHS = ("gbm", "ou", "cox_ingersoll_ross", "heston", "sde_milstein", "markov_chain")
N_SENS = 1 << 24  # the one-shot gradient's size (one streamed block)
N_SENS_CHECK = 1 << 20  # card against the CPU and central differences
N_SENS_STREAM = 1 << 28
SENS_CHECKPOINT_EVERY = 1 << 26  # four segments of four blocks
SENS_TOL = 1e-4  # card against CPU: of max(1, |gradient|)
SENS_FD_TOL = 1e-4  # autograd (float32) against float64 central differences, likewise
SENS_FD_STEP = 1e-6  # the central difference's step, of max(1, |parameter|)
SENS_VALUE_TOL = 1e-6  # the streamed mean against estimate(executor=None), relative
N_SENS_QUANTILE = 1 << 25  # a one-shot q<level> past torch.quantile's 2^24 elements
SENS_SOBOL_BLOCK = 1 << 16
SENS_SOBOL_TOL = 1e-4  # streamed Sobol-sequence gradients against one shot
N_GREEK_PATHS = 1 << 20
GREEK_BLOCK = 1 << 16
GREEK_REPLICATES = 8
N_SOBOL = 1 << 20
N_SOBOL_CHECK = 1 << 16
SOBOL_MOMENT_TOL = 1e-5
SOBOL_INDEX_TOL = 1e-4
N_ISHIGAMI = 1 << 15
ISHIGAMI_TOL = 0.01  # the JAX package's (tests/test_sensitivity.py:459)
N_LADDER = 1 << 20
LADDER_POINTS = 64  # also the 8 x 8 meshgrid's scenarios
LADDER_STATISTICS = ("mean", "q0.95", "cvar0.95")
LADDER_LOOP_POINTS = 8  # the ladder's first scenarios on independent streams: the loop
N_LADDER_CHECK = 1 << 16
LADDER_CHECK_SCENARIOS = 4
LADDER_TOL = 1e-4  # card against the CPU on one matrix: of max(1, |statistic|)
N_LADDER_STREAM = 1 << 24
LADDER_BLOCK = 1 << 20  # 64 scenarios x 2^20 float32: 256 MB of samples a block
LADDER_STREAM_TOL = 1e-6  # a streamed scenario against estimate(executor=None), likewise
N_RARE = 10**6
RARE_BLOCK = 1 << 17
N_RARE_LARGE = 1 << 24
RARE_LARGE_BLOCK = 1 << 20
RARE_SE = 4.0
MLMC_CASES = (("milstein", 0.02), ("euler", 0.01))  # examples/07's mlmc_demo, the README's call
MLMC_SE = 3.0  # the estimate within 3 eps of e^{rT} x Black-Scholes
N_LSMC = 1 << 20
LSMC_TABLE = ((36.0, 4.478), (40.0, 2.314), (44.0, 1.110))  # Longstaff-Schwartz 2001, table 1
LSMC_TOL = 0.04  # |price - FD| (the JAX package's tests/test_american.py)
N_HESTON_LSMC = 1 << 18
HESTON_FD = 1.1080  # Ikonen-Toivanen 2007: the American put at s0 = 9
N_MAX_CALL = 1 << 17
MAX_CALL_BOUNDS = (13.902, 13.934)  # Andersen-Broadie 2004, table 2: value and upper bound
N_LSMC_GREEKS = 1 << 18
LSMC_DELTA_TOL = 0.02  # against the central difference (the JAX package's test)
LSMC_VEGA_REL_TOL = 0.05
N_LSMC_CHECK = 1 << 14
LSMC_PRICE_TOL = 1e-4  # card against the CPU under one policy, relative
LSMC_WEIGHT_TOL = 1e-3  # the first solve, card against the CPU, of its largest |weight|
LSMC_MOVED_SHARE = 1e-3  # paths whose value moves under one policy
LSMC_SE_SHARE = 0.5  # the two devices' whole prices, in standard errors
N_TCOPULA = 10**8
N_TCOPULA_SMALL = 10**7  # run as well when 10^8 holds more than TCOPULA_PEAK_MB
TCOPULA_PEAK_MB = 40 * 1024
N_TCOPULA_STREAM = 1 << 28
TCOPULA_BLOCK = 1 << 24
N_TAU = 100_000  # the rows Kendall's tau is computed on
TAU_TOL = 0.01
PERMUTATION_SHAPE = (10**5, 10)
PERMUTATION_PROFILED_ITERATIONS = 10  # the profiler's trace costs about 0.5 ms a launch
N_MESH = 1 << 24  # phase 24's one-shot samples
N_MESH_ESTIMATE = 1 << 26
MESH_SHARDS_ONE_CARD = 4  # the repeated-device mesh: four shards on cuda:0
MESH_CORR_TOL = 1e-3  # rtol and atol, tests/test_parallel.py's correlated case
MESH_MLMC_TOL = 1e-4  # relative, tests/test_mlmc.py's mesh case
MESH_GRAD_TOL = (1e-5, 1e-6)  # rtol, atol: tests/test_torch_mesh_estimators.py
N_MESH_LSMC = 1 << 16
N_MESH_GRADIENTS = 1 << 20
MESH_LADDER_POINTS = 8
N_PROFILE_STATS = 1 << 20
TRACE_ATTEMPTS = 3

# The card's rates for the bound (NVIDIA H100 SXM, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 64 INT32 lanes per SM at the 1980 MHz max clock
FP32_FLOPS = 67e12  # an FMA counts two
TF32_FLOPS = 495e12  # dense tensor-core rate

# Per-sample work of one tape row: (32-bit integer instructions, float32
# flops).  A Philox4x32-10 call is 10 rounds of two IMAD.WIDE and two
# 3-input XORs, plus the counter, 43 integer instructions, and yields four
# draws, so a draw is a quarter of it, plus the bits-to-uniform map;
# ndtri_fast is about 50 flops (two 9-term Horner polynomials, a log, a
# sqrt); ndtr_fast about 25 (a 5-term polynomial, a division, an exp).
# Transcendentals count 4 flops.  This is a floor for the function, not a
# model of any kernel's instruction stream.
_NDTRI, _NDTR = 50, 25
_DRAW_INTS = 43 / 4
OP_COST = {
    "DRAW": (_DRAW_INTS, 3), "LOADK": (0, 0), "STORE": (0, 0),
    "SCORE": (0, _NDTRI), "NDTR": (0, _NDTR + 2),
    "PPF_UNIFORM": (0, 0), "PPF_NORM": (0, _NDTRI), "PPF_EXPON": (0, 4),
    "PPF_LOGNORM": (0, _NDTRI + 5), "PPF_TRIANG": (0, 12),
    "SCORE_NORM": (0, 2), "SCORE_LOGNORM": (0, 7),
    "DIV": (0, 4), "POW": (0, 8), "EXP": (0, 4), "LOG": (0, 4), "SQRT": (0, 4),
    "AFFINE": (0, 2),
}
# The family branches' standard variates, float32 operations per sample:
# a transcendental or a division counts 4, a power 8 (a log, a multiply,
# an exp), expm1_safe 14 (its Taylor branch), ndtri_fast_wide 100 (two
# logs and the Giles branch, or the asymptotic series).
_WIDE, _EXPM1 = 100, 14
FAMILY_FLOPS = {
    "truncnorm": 2 * _NDTR + _WIDE + 6, "cauchy": 6, "laplace": 7, "logistic": 9,
    "gumbel_r": 9, "gumbel_l": 9, "rayleigh": 9, "halfnorm": _WIDE + 2, "pareto": 13,
    "weibull_min": 16, "weibull_max": 16, "powerlaw": 12, "loguniform": 19, "arcsine": 6,
    "hypsecant": 11, "fisk": 16, "genpareto": 10 + _EXPM1, "genextreme": 12 + _EXPM1,
    "bernoulli": 2, "geom": 13, "randint": 6, "alpha": _NDTR + _WIDE + 6,
    "bradford": 9 + _EXPM1, "burr": 20 + _EXPM1, "burr12": 20 + _EXPM1, "dweibull": 19,
    "exponpow": 20, "exponweib": 24 + _EXPM1, "fatiguelife": _NDTRI + 10,
    "genhalflogistic": 18, "genlogistic": 12 + _EXPM1, "gibrat": _NDTRI + 4, "gompertz": 12,
    "halfcauchy": 10, "halflogistic": 9, "invweibull": 16, "johnsonsb": _NDTRI + 14,
    "johnsonsu": _NDTRI + 15, "kappa3": 26 + _EXPM1, "laplace_asymmetric": 16,
    "levy": _WIDE + 5, "levy_l": _WIDE + 6, "loglaplace": 14, "lomax": 8 + _EXPM1,
    "mielke": 28 + _EXPM1, "moyal": _WIDE + 6, "powerlognorm": 16 + _EXPM1 + _WIDE,
    "powernorm": 12 + _EXPM1 + _WIDE, "trapezoid": 22, "truncexpon": 5 + _EXPM1,
    "truncpareto": 24, "truncweibull_min": 40, "tukeylambda": 22, "reciprocal": 19,
    "skewcauchy": 16, "kappa4": 16 + 2 * _EXPM1, "crystalball": _NDTR + _WIDE + 45,
}
OP_COST.update({f"PPF_{name.upper()}": (0, flops) for name, flops in FAMILY_FLOPS.items()})
# The Newton families: a guess (ndtri_fast_wide and Lanczos log-gammas,
# about 40 operations each), then per trip one incomplete function and a
# step.  A gamma trip is priced at the series branch (48 terms of a
# multiply, a division and an add; the continued fraction costs more), a
# beta trip at 40 pairs of the continued fraction (29 operations a half:
# the partial numerator with its division, two guarded reciprocals).
GAMMA_GUESS, GAMMA_TRIP = _WIDE + 2 * 40 + 20, 48 * 7 + 20
BETA_GUESS, BETA_TRIP = _WIDE + 3 * 40 + 30, 40 * 58 + 40
# The re-priced bound (the Newton tier's stopped fractions): a trip's own
# work (20 gamma, 40 beta) and each series term (7) or fraction pair (58)
# that the tier's stopping rule takes on the same draws, counted per lane
# by engine/newton_tier.py.
GAMMA_TRIP_OWN, GAMMA_TERM = 20, 7
BETA_TRIP_OWN, BETA_PAIR = 40, 58
# The table rows, per sample: a search over nb boundaries takes
# ceil(log2(nb + 1)) steps of a shared load, a compare and a select (3
# operations); TABLE_CDF then converts the count (1), TABLE_DISCRETE loads
# the value (1), TABLE_INTERP loads its interval (3 loads), subtracts,
# multiplies, adds and selects the right end (4).
TABLE_STEP = 3
TABLE_TAIL = {"TABLE_CDF": 1, "TABLE_DISCRETE": 1, "TABLE_INTERP": 7}
# The guide-indexed search (csrc/table_ops.cuh), re-priced: the shared-
# memory wavefronts a lookup takes (its guide's word, each step of its
# window or of the full search, the gather after it), each path once for
# a warp whose lanes take it, as ops/table_search.py counts them on this
# run's draws, at one wavefront a clock per SM; and TABLE_STEP operations
# a load.
SHARED_WAVEFRONTS_PER_S = 132 * 1.98e9


def table_flops(name, nb):
    return TABLE_STEP * max(int(nb), 0).bit_length() + TABLE_TAIL[name]


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def tape_cost(tape, cuda_exec, newton=None, int_cost=None, tables=None):
    """(integer instructions, float32 flops) per sample of ``tape``;
    ``newton`` prices this run's Newton ops (``newton_cost``), ``int_cost``
    the rows that compute in int32 or bool and the conversions of their
    operands, in SASS instructions (``int_op_sass``; without it, one
    each), ``tables`` a table row's flops by its value number (without it,
    ``table_flops``: the full search).  A constant's conversion is
    loop-invariant and costs nothing."""
    int_cost = int_cost or {}
    ints = flops = 0
    kind_of, consts = {}, set()
    for (op, dst, a, b, nb, d), kind in zip(tape.program, tape.kinds):
        name = cuda_exec.OPCODES[op]
        if name == "LOADK":
            kind_of[dst] = kind
            consts.add(dst)
            continue
        fields = (() if name in ("DRAW", "RECOLOR") else (a,) if name in TABLE_TAIL
                  else (a, b, nb, d))
        operands = [v for v in fields if v in kind_of]
        compute = (cuda_exec._compute_kind(name, [kind_of[v] for v in operands], kind)
                   if name in cuda_exec._TRANSFORM_FN else "f")
        ints += sum(int_cost.get("I2F", 1) if kind_of[v] == "i" and compute == "f" else 1
                    for v in operands if kind_of[v] != compute and v not in consts)
        if kind is not None:
            kind_of[dst] = kind
        if compute != "f":
            ints += (int_cost.get(name, int_cost.get("LT", 1)) if compute == "i"
                     else int_cost.get("AND", 1))
            continue
        if name == "RECOLOR":
            i, f = 0, 2 * tape.n_corr
        elif name in TABLE_TAIL:
            i, f = 0, (tables or {}).get(dst, table_flops(name, nb))
        elif newton and name in newton:
            i, f = 0, newton[name]
        else:
            i, f = OP_COST.get(name, (0, 1))
        ints, flops = ints + i, flops + f
    return ints, flops


def newton_cost(torch, name, args, q):
    """A Newton family's op on the quantiles ``q``, priced two ways:
    ``{"trips": the twin's mean trips, "flops": its float32 operations per
    sample at those trips with fixed-length fractions, "tier_trips",
    "tier_inner": the Newton tier's mean trips and series terms or
    fraction pairs per sample (engine/newton_tier.py), "tier_flops": the
    operations per sample at those counts}``, each plus the guess."""
    from probabilit_tpu_torch.engine import newton_tier
    from probabilit_tpu_torch.ops import special

    kind, a, b, p = newton_tier.family_args(name, q, args)
    n = q.numel()
    with special.kernel_safe_special():
        if kind == "gamma":
            trips = special.newton_gammaincinv(a, p)[1] / n
            _, tier_trips, inner = newton_tier.gammaincinv(a, p)
        else:
            trips = special.newton_betaincinv(a, b, p)[1] / n
            _, tier_trips, inner = newton_tier.betaincinv(a, b, p)
    tier_trips = tier_trips.double().mean().item()
    inner = inner.double().mean().item()
    if kind == "gamma":
        flops = GAMMA_GUESS + trips * GAMMA_TRIP
        tier_flops = GAMMA_GUESS + tier_trips * GAMMA_TRIP_OWN + inner * GAMMA_TERM
    else:
        flops = BETA_GUESS + trips * BETA_TRIP
        tier_flops = BETA_GUESS + tier_trips * BETA_TRIP_OWN + inner * BETA_PAIR
    return {"trips": trips, "flops": flops, "tier_trips": tier_trips, "tier_inner": inner,
            "tier_flops": tier_flops}


def stats_cost(k):
    """(integer instructions, float32 flops) per sample of the statistics
    kernel with k columns: k draws and scores, then k + k(k+1)/2 sums."""
    return _DRAW_INTS * k, k * (3 + _NDTRI + 1) + 2 * (k * (k + 1) // 2)


def stats_tensor_bound(n, nbytes, k):
    """The statistics kernel's bound with its cross products re-priced on
    the tensor cores: (ms, what binds).  The draws and scores keep
    ``stats_cost``'s price on the integer and FP32 pipes; the k(k+1)/2
    products a sample (two flops each) count three times (the hi.hi,
    hi.lo and lo.hi TF32 products) at the dense TF32 rate; the pipes run
    side by side, so the slowest binds."""
    ints, flops = stats_cost(k)
    cross = 2 * (k * (k + 1) // 2)
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": max(n * ints / INT32_OPS_PER_S, n * (flops - cross) / FP32_FLOPS,
                               n * 3 * cross / TF32_FLOPS)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def bound(n, nbytes, cost):
    """The least time, ms, for n samples: bytes or operations, whichever binds."""
    ints, flops = cost
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": max(n * ints / INT32_OPS_PER_S, n * flops / FP32_FLOPS)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


# The int32 and bool bodies whose SASS ``int_op_sass`` counts: one kernel
# each on two ints a and b loaded from memory, beside a baseline that
# stores a as it is.  LT stands for every int32 comparison, AND for every
# bool row, I2F for an int operand read as a float.
INT_OP_EXPR = {
    "ADD": "add_i32(a, b)", "SUB": "sub_i32(a, b)", "MUL": "mul_i32(a, b)",
    "MAX": "max_i32(a, b)", "MIN": "min_i32(a, b)", "NEG": "neg_i32(a)", "ABS": "abs_i32(a)",
    "SIGN": "sign_i32(a)", "SQUARE": "mul_i32(a, a)", "FLOOR": "a", "CEIL": "a",
    "FLOORDIV": "floor_divide_i32(a, b)", "MOD": "floor_mod_i32(a, b)", "POW": "pow_i32(a, b)",
    "LT": "static_cast<int>(a < b)", "AND": "static_cast<int>((a != 0) && (b != 0))",
    "I2F": "__float_as_int(__int2float_rn(a))",
}


def int_op_sass(_build):
    """{op: SASS instructions} of each ``INT_OP_EXPR`` body on sm_90a, less
    the baseline's (``nvcc -cubin``, then ``cuobjdump -sass``; NOPs left
    out).  POW counts its loop body once."""
    out_dir = _build.BUILD_DIR / "int_op_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = ['#include "graph_ops.cuh"', "using namespace graph_ops;"]
    for name, expr in {"BASE": "a", **INT_OP_EXPR}.items():
        # a reads both loads, so every kernel keeps them.
        lines.append(f'extern "C" __global__ void op_{name}(const int* x, const int* y, int* out) '
                     f"{{ const int b = y[threadIdx.x], a = x[threadIdx.x] ^ b; "
                     f"out[threadIdx.x] = {expr}; }}")
    (out_dir / "int_ops.cu").write_text("\n".join(lines) + "\n")
    nvcc = _build.nvcc_path()
    subprocess.run([str(nvcc), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-I", str(_build.CSRC), "-o", str(out_dir / "int_ops.cubin"),
                    str(out_dir / "int_ops.cu")], check=True, capture_output=True, text=True)
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(out_dir / "int_ops.cubin")],
                          check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : op_(\w+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
            continue
        instr = re.search(r"/\*[0-9a-f]{4}\*/\s+([^;]+);", line)
        if name and instr and not instr.group(1).strip().startswith("NOP"):
            counts[name] += 1
    base = counts.pop("BASE")
    return {op: count - base for op, count in counts.items()}


def ptxas_instances(log):
    """{kernel instance: [registers, spill-store bytes]} from ``-Xptxas=-v``
    output.  An instance is ``name<mangled template arguments>``: f, i, d,
    l for float, int32, float64, int64 keys; j, m for 4- and 8-byte
    payloads; Li14 for the integer 14."""
    kernels = ("sort_tiles_kernel|block_exchange_kernel|tail_kernel|corr_stats|graph_megakernel"
               "|block_fold_kernel")
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        # Greedy: the mangled name also carries the source file's name.
        found = re.search(rf"Function properties for \S*\d({kernels})(?:I(\w*?)EE)?", line)
        if found:
            name, spill = found.group(1) + (f"<{found.group(2)}>" if found.group(2) else ""), 0
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            out[name] = [int(re.search(r"Used (\d+) registers", line).group(1)), spill]
            name = None
    return out


def sass_counts(_build, library):
    """The SASS of the generated kernel in ``library`` (``cuobjdump
    -sass``): its instructions and its ``CALL``, ``STL``/``LDL`` (local
    memory) and ``MUFU`` instructions."""
    cuobjdump = _build.nvcc_path().parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    ops = [re.sub(r"^@!?U?P[T0-9]\s+", "", m.group(1).strip()).split()[0].split(".")[0]
           for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", sass)]
    return {"instructions": len(ops), **{op: ops.count(op) for op in ("CALL", "STL", "LDL", "MUFU")}}


def library_icdf(torch, name, args, kwargs):
    """``(icdf, class name)``: the ``torch.distributions`` inverse CDF of the
    scipy family ``name`` at ``args``, ``kwargs``, plus the loc its class
    lacks, as a function of float32 uniforms on the card."""
    D = torch.distributions
    loc, scale = float(kwargs.get("loc", 0.0)), float(kwargs.get("scale", 1.0))
    loc_t, scale_t = (torch.tensor(v, device="cuda") for v in (loc, scale))
    shape = torch.tensor(float(args[0]), device="cuda") if args else None
    if name in ("norm", "cauchy", "laplace", "gumbel_r"):
        classes = {"norm": D.Normal, "cauchy": D.Cauchy, "laplace": D.Laplace,
                   "gumbel_r": D.Gumbel}
        dist, loc = classes[name](loc_t, scale_t), 0.0
    elif name == "uniform":
        dist, loc = D.Uniform(loc_t, loc_t + scale_t), 0.0
    elif name == "lognorm":
        dist = D.LogNormal(torch.log(scale_t), shape)
    elif name == "expon":
        dist = D.Exponential(1.0 / scale_t)
    elif name == "pareto":
        dist = D.Pareto(scale_t, shape)
    elif name == "weibull_min":
        dist = D.Weibull(scale_t, shape)
    else:
        dist = {"halfnorm": D.HalfNormal, "halfcauchy": D.HalfCauchy}[name](scale_t)
    return (lambda u: loc + dist.icdf(u)), type(dist).__name__


def cuda_time_ms(fn, repeats=5, warm=True):
    """Median wall time of ``fn`` on the card, by CUDA events, after one
    warm-up call (``warm=False``: the caller has just run it)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def rotating_ms(fn, items, launches, repeats=5):
    """Median ms of one call of ``fn`` over ``launches`` calls on
    ``items`` in turn (``cuda_time_ms`` of the batch)."""
    return cuda_time_ms(
        lambda: [fn(items[i % len(items)]) for i in range(launches)], repeats
    ) / launches


def fold_gap(got, want):
    """The largest gap of the fold kernel's packed float64 fields from
    the twin's, each against its scale (the means against their standard
    deviations, M3 against n sd^3, Cxy against sqrt(M2 M2y), M2, M2y and
    M4 relative), and whether n, min, max and finite are equal."""
    n, _, m2, _, _, _, _, m2y, _, _, m4 = want
    sd = (m2 / n) ** 0.5 if n else 0.0
    sd_y = (m2y / n) ** 0.5 if n else 0.0
    scales = {1: sd, 2: m2, 6: sd_y, 7: m2y, 8: (m2 * m2y) ** 0.5, 9: n * sd**3, 10: m4}
    gap = max(abs(got[i] - want[i]) / (scale or 1.0) for i, scale in scales.items())
    return gap, got[0] == want[0] and got[3:6] == want[3:6]


def fold_cases(torch, cuda_exec, streaming, x, prior):
    """The fold kernel on one streamed block ``x`` (float32) against its
    twin and timed (phase 12), with moments off and on, a float32 control
    and a float32 and a bool condition that accepts half the block;
    ``prior`` is a block of the same length folded into the carry first
    in the second check."""
    n = x.numel()
    gen = torch.Generator(device=x.device).manual_seed(12)
    control = (x - x.mean()) / x.std() + torch.randn(n, device=x.device, generator=gen)
    accept = x > x.median()
    cases = {
        "moments_off": (None, False, False), "moments_on": (None, False, True),
        "control_f32": (control, False, True), "where_f32": (accept.float(), True, True),
        "where_bool": (accept, True, True),
    }
    scratch = cuda_exec.fold_scratch(x.device)
    empty = streaming._initial_carry(0, 0, x.device)
    xs = [x] + [x.clone() for _ in range(3)]  # 256 MiB at 2^24: the L2 holds none of the next
    records = {}
    for case, (y, where_mode, moments) in cases.items():
        ys = [y] * 4 if y is None else [y] + [y.clone() for _ in range(3)]

        def twin(carry, xb, yb):
            stats = streaming._block_moments(xb, yb, n, where_mode, moments)
            return streaming._merge(carry, (*stats, carry[6], carry[10]), where_mode, moments)

        gap, exact, repeat = 0.0, True, True
        for start in (empty, twin(empty, prior, y)):
            folded = []
            for _ in range(2):
                packed = cuda_exec.pack_moments(start)
                cuda_exec.block_fold(packed, x, y, n, where_mode, moments, scratch)
                folded.append(packed)
            repeat &= torch.equal(folded[0], folded[1])
            want = cuda_exec.pack_moments(twin(start, x, y))
            g, e = fold_gap(folded[0].tolist(), want.tolist())
            gap, exact = max(gap, g), exact and e
        check(gap <= FOLD_TOL and exact and repeat,
              f"fold kernel {case} vs twin: gap {gap}, exact {exact}, repeat bitwise {repeat}")
        packed = cuda_exec.pack_moments(empty)
        pairs = list(zip(xs, ys))
        records[case] = {
            "kernel_ms": rotating_ms(
                lambda p: cuda_exec.block_fold(packed, *p, n, where_mode, moments, scratch),
                pairs, 100),
            "plain_ms": rotating_ms(lambda p: twin(empty, *p), pairs, 8),
            "bound_ms": (4 * n + (0 if y is None else y.element_size() * n))
            / HBM_BYTES_PER_S * 1e3,
            "max_rel_err": gap, "n_min_max_finite_equal": exact, "repeat_bitwise": repeat,
        }
    records["sum_ms"] = rotating_ms(lambda xb: xb.sum(), xs, 100)  # a read of the block alone
    return records


def priced(loc, scale):
    """A small graph whose structure is fixed and whose constants are not."""
    from probabilit_tpu_torch.models import graph as tg
    from probabilit_tpu_torch.models.distributions import Distribution

    x = Distribution("norm", loc=loc, scale=scale)
    return tg.Exp(x * 0.5) + Distribution("expon", scale=scale)


def node_keep(plan, corr_first=False):
    """The sink and up to 15 more nodes that are no constants: a correlated
    plan's drivers first, then the nodes nearest the sink."""
    keep = {plan.sink._id} | ({v._id for v in plan.corr_vars} if corr_first else set())
    others = [n._id for n in plan.topo if n._id not in keep and not hasattr(n, "value")]
    return frozenset(keep | set(others[len(others) - (16 - len(keep)):]))


def normal_drivers(plan):
    return [v for v in plan.corr_vars if v.distr == "norm"]


def family_keep(nodes):
    return lambda plan: {plan.sink._id} | {node._id for _, node in nodes}


def portfolio_keep(plan):
    return {plan.sink._id} | {v._id for v in plan.corr_vars}


def generated_tapes(cuda_exec, _compile):
    """{label: tape} for every graph and keep set the phases run, built on
    fresh graphs: the kernels' text depends on structure alone, so the
    phases' own graphs find these builds."""
    from probabilit_tpu_torch.models.benchmarks import (
        breach_count,
        breach_count_correlated,
        family_graphs,
        large_table,
        mixed_correlated_50,
        mixed_dag_20,
        portfolio_model,
        portfolio_var,
        table_risk,
        table_risk_correlated,
        typed_ops,
    )
    from probabilit_tpu_torch.models.distributions import Distribution

    def tape(sink, keep=lambda plan: {plan.sink._id}):
        plan = _compile.get_plan(sink)
        return cuda_exec.lower(plan, cuda_exec.keep_order(plan, frozenset(keep(plan))))

    families = {}
    for label, (sink, nodes) in family_graphs().items():
        families[label] = tape(sink)
        families[f"{label}, all nodes"] = tape(sink, family_keep(nodes))
    for name in cuda_exec.INCOMPLETE_FAMILY_CAPS:
        families[f"newton family {name}"] = tape(newton_family(name))
    for name in LIBRARY_FAMILIES:
        families[f"single {name}"] = tape(single_family(name))
    typed = {}
    sink, leaves, _ = typed_ops()
    for label, group in typed_ops_groups(leaves).items():
        typed[label] = tape(sink, lambda plan, group=group: group_keep(plan, leaves, group))
    for name, build in (("breach_count", breach_count),
                        ("breach_count_correlated", breach_count_correlated)):
        loss, nodes = build()
        typed[name] = tape(loss)
        typed[f"{name}, typed nodes"] = tape(loss, lambda plan, nodes=nodes: breach_keep(plan, nodes))
        typed[f"{name}, severe"] = tape(nodes["severe"])
    typed["breach_count, overruns"] = tape(breach_count()[1]["overruns"])
    # Phase 19's separate estimates: each watched node of mixed_dag_20 as
    # its own sink, a portfolio asset alone and the correlated total.
    joint = {f"estimate_many node {k}": tape(node)
             for k, node in enumerate(joint_nodes(_compile.get_plan(mixed_dag_20()))[:-1])}
    total = portfolio_model(d=10)
    joint["portfolio_model asset"] = tape(_compile.get_plan(total).corr_vars[0])
    joint["portfolio_model"] = tape(total)
    return {
        "mixed_dag_20": tape(mixed_dag_20()),
        "mixed_dag_20, 16 rows": tape(mixed_dag_20(), node_keep),
        "norm": tape(Distribution("norm", loc=3.0, scale=2.0)),
        "mixed_correlated_50": tape(mixed_correlated_50()),
        "mixed_correlated_50, 16 rows": tape(
            mixed_correlated_50(), lambda plan: node_keep(plan, corr_first=True)),
        "mixed_correlated_50, normal drivers": tape(
            mixed_correlated_50(),
            lambda plan: {plan.sink._id} | {v._id for v in normal_drivers(plan)}),
        "priced(1, 2)": tape(priced(1.0, 2.0)),
        "priced(-3.5, 0.25)": tape(priced(-3.5, 0.25)),
        **families,
        "portfolio_var": tape(portfolio_var()[0]),
        "portfolio_var, drivers": tape(portfolio_var()[0], portfolio_keep),
        "large_table": tape(large_table()),
        "large_table, 2 rows": tape(
            large_table(), lambda plan: {plan.sink._id, plan.dist_nodes[0]._id}),
        "table_risk": tape(table_risk()[0]),
        "table_risk, all nodes": tape(
            table_risk()[0], lambda plan: {plan.sink._id} | {n._id for n in plan.dist_nodes}),
        "table_risk_correlated": tape(table_risk_correlated()[0]),
        "table_risk_correlated, drivers": tape(table_risk_correlated()[0], portfolio_keep),
        "table_risk_correlated, drawn": tape(correlated_tables_drawn()[0], dist_keep),
        **typed,
        **joint,
    }


def joint_nodes(plan):
    """Phase 19's watched nodes: the sink and the seven non-constant nodes
    nearest it in the plan's topological order."""
    from probabilit_tpu_torch.models.graph import Constant

    return [node for node in plan.topo if not isinstance(node, Constant)][-8:]


def single_family(name):
    """A graph of one node of ``name`` at its LIBRARY_FAMILIES parameters."""
    from probabilit_tpu_torch.models.distributions import Distribution

    args, kwargs = LIBRARY_FAMILIES[name]
    return Distribution(name, *args, **kwargs)


def typed_ops_groups(leaves):
    """typed_ops' leaf labels, 15 to a group (a tape keeps 16 rows)."""
    labels = list(leaves)
    return {f"typed_ops, leaves {i}-{min(i + 15, len(labels)) - 1}": labels[i:i + 15]
            for i in range(0, len(labels), 15)}


def group_keep(plan, leaves, labels):
    """The sink and the typed_ops leaves ``labels``."""
    return {plan.sink._id} | {leaves[label]._id for label in labels}


BREACH_TYPED = ("overruns", "tier", "late")  # the int32 and bool nodes loss reads


def breach_keep(plan, nodes):
    """The sink (loss) and the int32 and bool nodes it reads."""
    return {plan.sink._id} | {nodes[name]._id for name in BREACH_TYPED}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False.")
    import probabilit_tpu_torch
    here = Path(__file__).resolve().parent
    if Path(probabilit_tpu_torch.__file__).resolve().parent.parent != here:
        raise SystemExit("chip_smoke.py must run from the repository that holds it.")
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}; see the docstring.")

    import numpy as np
    import scipy.stats

    from probabilit_tpu_torch import _build, config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import cuda_exec
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
    from probabilit_tpu_torch.models.distributions import Distribution
    from probabilit_tpu_torch.ops import bitonic_sort as bs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # Phase 2: build, one nvcc per source, all started together: the three
    # sources of csrc/ and the generated megakernel of every graph structure
    # and keep set the phases below run.
    generated = generated_tapes(cuda_exec, _compile)
    texts = {}  # one build per distinct text
    for label, tape in generated.items():
        texts.setdefault(tape.source, []).append(label)

    def build_one(item):
        t = time.perf_counter()
        if item in SOURCES:
            lib_path, log = _build.build(item)
        else:
            lib_path, log = _build.build_generated("graph_megakernel", item, cuda_exec._HEADERS)
        return lib_path, log, time.perf_counter() - t

    t0 = time.perf_counter()
    jobs = [*SOURCES, *texts]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        sass = pool.submit(int_op_sass, _build)
        built = dict(zip(jobs, pool.map(build_one, jobs)))
        int_cost = sass.result()
    build_s = time.perf_counter() - t0
    emit({"phase": "int_op_sass", "instructions_over_a_load_and_store": int_cost})
    registers = {}  # label: [registers, spill bytes] of its generated kernel
    for job, (lib_path, log, seconds) in built.items():
        record = {"phase": "build", "kernel": job if job in SOURCES else "graph_megakernel",
                  "seconds": seconds, "all_builds_seconds": build_s, "library": lib_path.name,
                  "registers_and_spill_bytes": ptxas_instances(log)}
        if job == "corr_stats":  # every K's instance, without local memory
            spills = {kernel: regs for kernel, regs in record["registers_and_spill_bytes"].items()
                      if regs[1]}
            check(len(record["registers_and_spill_bytes"]) == 16 and not spills,
                  f"corr_stats: 16 instances without spills expected: {record['registers_and_spill_bytes']}")
        if job == "bitonic_sort":  # K3 and K5 hold a padded 2^tile_log tile
            record["dynamic_smem_bytes_k3_k5"] = {
                f"{k}-byte keys, {p}-byte payload": (k + p) * (33 << bs._tile_log(k, p)) // 32
                for k in (4, 8) for p in (4, 8)}
        if job not in SOURCES:
            tape = generated[texts[job][0]]
            record.update(graphs=texts[job], rows=tape.n_instr, constants=len(tape.consts),
                          kept_rows=tape.n_keep, correlated=tape.n_corr,
                          text_lines=job.count("\n"))
            check(list(record["registers_and_spill_bytes"]) == ["graph_megakernel"],
                  f"ptxas reported no graph_megakernel for {texts[job]}")
            record["shared_bytes"] = tape.shared_bytes
            for label in texts[job]:
                registers[label] = record["registers_and_spill_bytes"]["graph_megakernel"]
        emit(record)
    check(len(texts) < len(generated), "graphs that differ only in constants gave two texts")
    # The closed-form family kernels run on fast_math.cuh alone: no call
    # (libm's slow paths, IEEE division) and no local memory in their SASS.
    sass = {label: sass_counts(_build, built[generated[label].source][0])
            for label in (*CLOSED_FORM_GRAPHS, *(f"{g}, all nodes" for g in CLOSED_FORM_GRAPHS),
                          "mixed_dag_20", "portfolio_var",
                          *(f"single {name}" for name in LIBRARY_FAMILIES))}
    emit({"phase": "closed_form_sass", "kernels": {
        label: {**counts, "registers_and_spill_bytes": registers[label]}
        for label, counts in sass.items()}})
    for label in (*CLOSED_FORM_GRAPHS, *(f"{g}, all nodes" for g in CLOSED_FORM_GRAPHS)):
        check(sass[label]["CALL"] == sass[label]["STL"] == sass[label]["LDL"] == 0,
              f"{label}: a call or local memory in the closed-form kernel: {sass[label]}")

    config.set_device("cuda")
    config.set_dtype(torch.float32)

    # Phase 3: the main path, through the entry point a user calls.
    sink = mixed_dag_20()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    launches = cuda_exec.LAUNCHES
    check(launches >= 1, "the main path launched no kernel")
    check(cuda_exec.STATS_LAUNCHES == 0, "an uncorrelated graph ran the statistics kernel")
    check(out.device.type == "cuda", f"sink lies on {out.device}")
    check(tuple(out.shape) == (N_MAIN,), f"sink shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite sink values")
    emit({"phase": "main_path", "n": N_MAIN, "launches": launches,
          "sink_mean": out.double().mean().item(), "sink_std": out.double().std().item()})

    # Phase 4: kernel against its plain twin on identical Philox bits.
    plan = _compile.get_plan(sink)
    words = cuda_exec.seed_words(0)
    main_tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, {sink._id}), "cuda")
    twin = cuda_exec.run_reference(main_tape, words, N_MAIN)[0]
    main_err = (out - twin).abs().max().item()
    main_scale = twin.abs().max().item()
    check(main_err <= REL_TOL * main_scale,
          f"main path: kernel vs twin {main_err} > {REL_TOL} * {main_scale}")
    emit({"phase": "kernel_vs_twin_main", "n": N_MAIN, "max_abs_err": main_err,
          "max_abs_twin": main_scale, "tolerance": REL_TOL * main_scale})
    del twin

    keep_ids = node_keep(plan)
    node_tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep_ids), "cuda")
    got, _ = cuda_exec.run(node_tape, words, N_NODES)
    U = cuda_exec.philox_uniforms(words, N_NODES, plan.d, device="cuda")
    ref = cuda_exec.run_tape(node_tape, U)
    central = ((U >= 0.01) & (U <= 0.99)).all(dim=1)
    by_id = {node._id: node for node in plan.topo}
    per_node = []
    for k, nid in enumerate(node_tape.keep_order):
        err = (got[k] - ref[k]).abs()
        scale = ref[k].abs().max().item()
        row = {"node": f"{type(by_id[nid]).__name__}#{k}", "max_abs_err": err.max().item(),
               "central_max_abs_err": err[central].max().item(), "max_abs_twin": scale,
               "rel_err": err.max().item() / max(scale, 1e-30)}
        per_node.append(row)
        check(row["max_abs_err"] <= REL_TOL * scale, f"kernel vs twin per node: {row}")
    emit({"phase": "kernel_vs_twin_nodes", "n": N_NODES, "rel_tolerance": REL_TOL,
          "central": "all 8 uniforms in [0.01, 0.99]", "nodes": per_node})
    del U, ref, got

    # Phase 5: statistics of the kernel's stream.
    s = Distribution("norm", loc=3.0, scale=2.0).sample(
        N_KS, random_state=7, gc_strategy=[], executor="cuda"
    ).double().cpu().numpy()
    ks = scipy.stats.kstest(s, scipy.stats.norm(loc=3.0, scale=2.0).cdf)
    check(ks.pvalue > KS_P_MIN, f"KS p-value {ks.pvalue}")
    emit({"phase": "statistics", "ks_n": N_KS, "ks_pvalue": ks.pvalue,
          "ks_mean_err": abs(s.mean() - 3.0), "ks_std_err": abs(s.std() - 2.0),
          "moments_n": N_MOMENTS, **executors_agree(np, sink, "sink")})

    # Phase 6: timings at the main path's shape, on this card.
    kernel_ms = cuda_time_ms(lambda: cuda_exec.run(main_tape, words, N_MAIN))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(main_tape, words, N_MAIN), repeats=3)
    cuda_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    plain_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor=None))
    emit({"phase": "timing", "card": smi, "n": N_MAIN,
          "kernel_ms": kernel_ms, "twin_ms": twin_ms,
          "sample_cuda_ms": cuda_ms, "sample_plain_ms": plain_ms,
          "samples_per_sec_cuda": N_MAIN / (cuda_ms * 1e-3),
          "samples_per_sec_plain": N_MAIN / (plain_ms * 1e-3)})

    main_ints, main_flops = tape_cost(main_tape, cuda_exec)
    main_bound, main_by = bound(N_MAIN, 4 * N_MAIN, (main_ints, main_flops))
    emit({"phase": "bound", "graph": "mixed_dag_20", "n": N_MAIN,
          "int_instr_per_sample": main_ints, "flops_per_sample": main_flops,
          "bytes": 4 * N_MAIN, "bound_ms": main_bound, "bound_by": main_by})
    del out

    corr = correlated_path(torch, np, cuda_exec, _compile, smi)
    odd = unaligned_and_shared_path(torch, cuda_exec, _compile, _build)
    sort = sort_path(torch, np, smi)
    stream = streamed_path(torch, np, cuda_exec, _compile, smi)
    families = family_path(torch, np, scipy.stats, cuda_exec, _compile, smi)
    portfolio = portfolio_path(torch, np, scipy, cuda_exec, _compile, smi)
    tables = table_path(torch, np, scipy, cuda_exec, _compile, smi, registers)
    typed = typed_path(torch, np, scipy, cuda_exec, _compile, smi, registers, int_cost, here)
    quantile_layer_path(torch, np, scipy, smi, here)
    joint = estimate_many_path(torch, np, cuda_exec, _compile, smi, here)
    # Phase 24 runs here, before phases 20-23 open their profiler sessions:
    # after those, a short profiler session has recorded no kernel on the
    # H100 machines this script was run on.
    mesh = mesh_profiling_path(torch, np, cuda_exec, _compile, smi, here)
    path_processes_path(torch, np, scipy, cuda_exec, _compile, smi)
    sensitivity_path(torch, np, cuda_exec, _compile, smi, here)
    estimators_path(torch, np, scipy, cuda_exec, _compile, smi)
    american_copula_path(torch, np, scipy, cuda_exec, _compile, smi)

    emit({"kernels": [
        {
            "name": "graph_megakernel",
            "route": "cuda",
            # Generated per graph by cuda_exec.generate from csrc/graph_ops.cuh
            # and csrc/sampling_math.cuh.
            "source": "probabilit_tpu_torch/engine/cuda_exec.py",
            "replaces": "probabilit_tpu/engine/pallas_exec.py:515",
            "launches": launches + corr["k1_launches"] + stream["k1_launches"]
            + families["k1_launches"] + portfolio["k1_launches"] + tables["k1_launches"]
            + typed["k1_launches"] + joint["k1_launches"] + mesh["k1_launches"],
            "max_abs_err": max(main_err, corr["k1_err"], stream["k1_err"], odd["k1_err"],
                               portfolio["k1_err"], typed["k1_abs_err"]),
            "ms": kernel_ms,
            "plain_ms": twin_ms,
            "bound_ms": main_bound,
            "bound_by": main_by,
            "library_ms": None,
            # The family branches: per graph at 1e8, the twin at 2^22, and
            # the largest error relative to each node's largest value.
            "family_graphs": families["graphs"],
            # The closed forms on fast_math.cuh: their kernels' SASS counts,
            # and the eleven torch.distributions families alone, K1 beside
            # the library's icdf on the same uniforms.
            "closed_form_sass": sass,
            "closed_form_library": families["library"],
            "portfolio_var": portfolio["record"],
            # The Newton tier (csrc/newton_ops.cuh): K1 at 1e8 beside the
            # bound at the twin's trips with fixed-length fractions and the
            # bound re-priced at the tier's own counts.
            "newton_tier": {
                label: {key: record[key] for key in ("ms", "bound_ms", "tier_bound_ms")}
                for label, record in (("newton_graph", families["graphs"]["newton"]),
                                      ("portfolio_var", portfolio["record"]))
            },
            # The table branch: large_table's K1 with its twin, bound and
            # library call (torch.searchsorted + loc on drawn uniforms), the
            # other table graphs' records, and the largest error relative
            # to each node's largest value (table nodes are bitwise).
            "table_branch": {**tables["main"], "max_rel_err": tables["k1_err"],
                             "graphs": tables["records"]},
            # The int32 and bool values: typed_ops bitwise, the breach
            # graphs' checks (the largest error relative to a float node's
            # largest value where the typed nodes agree), their timings and
            # the sequential and checkpointed estimates.
            "typed_graphs": {**typed["records"], "max_rel_err": typed["k1_err"]},
        },
        {
            "name": "corr_stats",
            "route": "cuda",
            "source": "probabilit_tpu_torch/csrc/corr_stats.cu",
            "replaces": "probabilit_tpu/engine/pallas_exec.py:577",
            "launches": corr["k2_launches"] + stream["k2_launches"] + portfolio["k2_launches"]
            + tables["k2_launches"] + typed["k2_launches"] + joint["k2_launches"],
            "max_abs_err": max(corr["k2_err"], stream["k2_err"], odd["k2_err"],
                               portfolio["k2_err"], tables["k2_err"]),
            "ms": corr["k2_ms"],
            "plain_ms": corr["k2_twin_ms"],
            "bound_ms": corr["k2_bound_ms"],
            "bound_by": corr["k2_bound_by"],
            "library_ms": None,
            # The cross products re-priced on the tensor cores, and every K
            # from 1 to 16 at 1e8 (columns 3 j + 1).
            "tensor_bound_ms": corr["k2_tensor_bound_ms"],
            "by_k": {k: {key: row[key] for key in ("ms", "bound_ms", "tensor_bound_ms",
                                                    "blocks_per_sm", "max_abs_err")}
                     for k, row in corr["k2_by_k"].items()},
        },
        *sort["kernels"],
        {
            "name": "block_fold",
            "route": "cuda",
            "source": "probabilit_tpu_torch/csrc/block_fold.cu",
            # None: XLA fused the JAX package's fold under jit.
            "replaces": None,
            "launches": stream["fold_launches"],
            "max_rel_err": max(case["max_rel_err"] for graph in stream["folds"].values()
                               for key, case in graph.items() if key != "sum_ms"),
            "ms": stream["folds"]["mixed_dag_20"]["moments_off"]["kernel_ms"],
            "plain_ms": stream["folds"]["mixed_dag_20"]["moments_off"]["plain_ms"],
            "bound_ms": 4 * BLOCK / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            # torch.sum of the block: a read alone, no float64 moments.
            "sum_ms": stream["folds"]["mixed_dag_20"]["sum_ms"],
            # Per graph, block 1's sink at 2^24: moments off and on, a
            # float32 control, a float32 and a bool condition.
            "cases": stream["folds"],
        },
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def correlated_path(torch, np, cuda_exec, _compile, smi):
    """Phases 7-10: ``mixed_correlated_50`` through both kernels."""
    from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50

    # Phase 7: the correlated main path, through the entry point a user calls.
    sink = mixed_correlated_50()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    k1_launches, k2_launches = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    check(k1_launches >= 1, "the correlated path launched no megakernel")
    check(k2_launches >= 1, "the correlated path launched no statistics kernel")
    check(out.device.type == "cuda", f"sink lies on {out.device}")
    check(tuple(out.shape) == (N_MAIN,), f"sink shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite sink values")
    emit({"phase": "correlated_main_path", "n": N_MAIN, "megakernel_launches": k1_launches,
          "stats_launches": k2_launches, "sink_mean": out.double().mean().item(),
          "sink_std": out.double().std().item()})

    # Phase 8: both kernels against their twins on identical Philox bits.
    plan = _compile.get_plan(sink)
    K = len(plan.corr_vars)
    words = cuda_exec.seed_words(0)
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    sums = cuda_exec.corr_stats(words, N_MAIN, columns, "cuda")
    sums_twin = cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda")
    k2_err = (sums - sums_twin).abs().max().item()
    check(k2_err <= STATS_TOL * N_MAIN, f"statistics kernel vs twin {k2_err} > {STATS_TOL} * n")
    emit({"phase": "stats_vs_twin", "n": N_MAIN, "k": K, "sums": sums.numel(),
          "max_abs_err": k2_err, "tolerance": STATS_TOL * N_MAIN,
          "max_rel_err": ((sums - sums_twin).abs() / sums_twin.abs().clamp(min=1.0)).max().item()})

    ab = cuda_exec.recolor_transform(plan, words, N_MAIN, device="cuda")
    main_tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, {sink._id}), "cuda")
    twin = cuda_exec.run_reference(main_tape, words, N_MAIN, ab)[0]
    k1_err = (out - twin).abs().max().item()
    scale = twin.abs().max().item()
    check(k1_err <= REL_TOL * scale, f"recoloured kernel vs twin {k1_err} > {REL_TOL} * {scale}")
    emit({"phase": "recoloured_kernel_vs_twin_main", "n": N_MAIN, "max_abs_err": k1_err,
          "max_abs_twin": scale, "tolerance": REL_TOL * scale})
    del twin

    keep_ids = node_keep(plan, corr_first=True)
    node_tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep_ids), "cuda")
    ab_nodes = cuda_exec.recolor_transform(plan, words, N_NODES, device="cuda")
    got, _ = cuda_exec.run(node_tape, words, N_NODES, ab_nodes)
    ref = cuda_exec.run_reference(node_tape, words, N_NODES, ab_nodes)
    by_id = {node._id: node for node in plan.topo}
    per_node = []
    for k, nid in enumerate(node_tape.keep_order):
        err = (got[k] - ref[k]).abs().max().item()
        node_scale = ref[k].abs().max().item()
        row = {"node": f"{type(by_id[nid]).__name__}#{k}", "max_abs_err": err,
               "max_abs_twin": node_scale, "rel_err": err / max(node_scale, 1e-30)}
        per_node.append(row)
        check(err <= REL_TOL * node_scale, f"recoloured kernel vs twin per node: {row}")
    emit({"phase": "recoloured_kernel_vs_twin_nodes", "n": N_NODES, "rel_tolerance": REL_TOL,
          "nodes": per_node})
    del got, ref

    # Phase 9: the induced correlation and the executors' moments at 1e7.
    normals = normal_drivers(plan)
    idx = [plan.corr_vars.index(v) for v in normals]
    sink.sample(N_MOMENTS, random_state=2, gc_strategy=normals, executor="cuda")
    got_corr = torch.corrcoef(torch.stack([v.samples_ for v in normals]).double()).cpu().numpy()
    target = plan.corr_matrix[np.ix_(idx, idx)]
    corr_err = float(np.abs(got_corr - target).max())
    check(corr_err <= CORR_TOL, f"normal drivers' correlation off the target by {corr_err}")
    emit({"phase": "correlated_statistics", "n": N_MOMENTS, "normal_drivers": len(normals),
          "corr_max_abs_err": corr_err, "corr_tolerance": CORR_TOL,
          **executors_agree(np, sink, "correlated sink")})

    # Phase 10: timings at the main path's shape, on this card.
    k2_ms = cuda_time_ms(lambda: cuda_exec.corr_stats(words, N_MAIN, columns, "cuda"))
    k2_twin_ms = cuda_time_ms(
        lambda: cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda"), repeats=3)
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(main_tape, words, N_MAIN, ab))
    k1_twin_ms = cuda_time_ms(
        lambda: cuda_exec.run_reference(main_tape, words, N_MAIN, ab), repeats=3)
    transform_ms, oneshot_ms = {}, {}
    for solve in ("host", "device"):  # sample() solves on the host
        transform_ms[solve] = cuda_time_ms(
            lambda: cuda_exec.recolor_transform(plan, words, N_MAIN, "cuda", solve=solve))
        oneshot_ms[solve] = cuda_time_ms(lambda: cuda_exec.run(
            main_tape, words, N_MAIN,
            cuda_exec.recolor_transform(plan, words, N_MAIN, "cuda", solve=solve))[1].item())
    cuda_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    plain_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor=None), repeats=3)
    host_ms = cuda_ms - k1_ms - k2_ms
    k2_bytes = 8 * sums.numel() * cuda_exec.stats_grid(K, N_MAIN)  # the float64 partials written
    k2_bound_ms, k2_bound_by = bound(N_MAIN, k2_bytes, stats_cost(K))
    k1_cost = tape_cost(main_tape, cuda_exec)
    k1_bound_ms, k1_bound_by = bound(N_MAIN, 4 * N_MAIN, k1_cost)
    emit({"phase": "correlated_timing", "card": smi, "n": N_MAIN, "k": K,
          "stats_kernel_ms": k2_ms, "stats_twin_ms": k2_twin_ms,
          "recolor_transform_ms": transform_ms["host"],
          "solve_and_sync_ms": transform_ms["host"] - k2_ms,
          "recolor_transform_device_solve_ms": transform_ms["device"],
          "transform_and_megakernel_ms": oneshot_ms["host"],
          "transform_and_megakernel_device_solve_ms": oneshot_ms["device"],
          "megakernel_ms": k1_ms, "megakernel_twin_ms": k1_twin_ms,
          "sample_cuda_ms": cuda_ms, "sample_plain_ms": plain_ms,
          "host_ms": host_ms, "host_share": host_ms / cuda_ms,
          "samples_per_sec_cuda": N_MAIN / (cuda_ms * 1e-3),
          "samples_per_sec_plain": N_MAIN / (plain_ms * 1e-3),
          "stats_bound_ms": k2_bound_ms, "stats_bound_by": k2_bound_by,
          "stats_tensor_bound_ms": stats_tensor_bound(N_MAIN, k2_bytes, K)[0],
          "stats_int_instr_per_sample": stats_cost(K)[0],
          "stats_flops_per_sample": stats_cost(K)[1],
          "megakernel_bound_ms": k1_bound_ms, "megakernel_bound_by": k1_bound_by,
          "megakernel_int_instr_per_sample": k1_cost[0],
          "megakernel_flops_per_sample": k1_cost[1], "tape_instructions": main_tape.n_instr})
    by_k = stats_by_k(torch, cuda_exec, smi)
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k1_err": k1_err,
            "k2_err": max(k2_err, by_k["max_abs_err"]), "k2_ms": k2_ms, "k2_twin_ms": k2_twin_ms,
            "k2_bound_ms": k2_bound_ms, "k2_bound_by": k2_bound_by,
            "k2_tensor_bound_ms": stats_tensor_bound(N_MAIN, k2_bytes, K)[0],
            "k2_by_k": by_k["rows"]}


def stats_by_k(torch, cuda_exec, smi):
    """Phase 10, continued: the statistics kernel alone at every K."""
    words = cuda_exec.seed_words(0)
    rows, worst = {}, 0.0
    for k in range(1, cuda_exec.MAX_CORR_K + 1):
        columns = [3 * j + 1 for j in range(k)]
        sums = cuda_exec.corr_stats(words, N_MAIN, columns, "cuda")
        again = cuda_exec.corr_stats(words, N_MAIN, columns, "cuda")
        twin = cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda")
        err = (sums - twin).abs().max().item()
        check(err <= STATS_TOL * N_MAIN, f"K = {k}: statistics kernel vs twin {err} > {STATS_TOL} * n")
        check(bool(torch.equal(sums, again)), f"K = {k}: statistics kernel differs on a repeat")
        worst = max(worst, err)
        del twin
        ms = cuda_time_ms(lambda: cuda_exec.corr_stats(words, N_MAIN, columns, "cuda"))
        block_ms = cuda_time_ms(
            lambda: cuda_exec.corr_stats(words, BLOCK, columns, "cuda", start=BLOCK))
        grid = cuda_exec.stats_grid(k, N_MAIN)
        nbytes = 8 * cuda_exec._stats_width(k) * grid
        bound_ms, bound_by = bound(N_MAIN, nbytes, stats_cost(k))
        tensor_ms, tensor_by = stats_tensor_bound(N_MAIN, nbytes, k)
        rows[k] = {"ms": ms, "block_ms": block_ms, "max_abs_err": err,
                   "tolerance": STATS_TOL * N_MAIN, "bitwise_repeat": True,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "tensor_bound_ms": tensor_ms, "tensor_bound_by": tensor_by,
                   "grid": grid, "blocks_per_sm": cuda_exec.stats_blocks_per_sm(k)}
    emit({"phase": "stats_by_k", "card": smi, "n": N_MAIN, "columns": "3 j + 1",
          "block": {"n": BLOCK, "start": BLOCK}, "k": rows})
    return {"rows": rows, "max_abs_err": worst}


def unaligned_and_shared_path(torch, cuda_exec, _compile, _build):
    """Phase 13: a ``start`` and an ``n`` that are no multiples of 4 (the
    main graphs and the Newton family graph), and one library for two
    graphs that differ only in their constants."""
    from probabilit_tpu_torch.models.benchmarks import family_graphs, mixed_correlated_50, mixed_dag_20

    start, n = N_UNALIGNED
    words = cuda_exec.seed_words(9)
    errs = {"k1": 0.0, "k2": 0.0}
    for name, build in (("mixed_dag_20", mixed_dag_20), ("mixed_correlated_50", mixed_correlated_50)):
        sink = build()
        plan = _compile.get_plan(sink)
        tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, {sink._id}), "cuda")
        record = {"phase": "unaligned_vs_twin", "graph": name, "start": start, "n": n}
        ab = None
        if plan.corr_vars:
            columns = [plan.col_of[v._id] for v in plan.corr_vars]
            sums = cuda_exec.corr_stats(words, n, columns, "cuda", start=start)
            sums_twin = cuda_exec.corr_stats_reference(words, n, columns, "cuda", start=start)
            k2_err = (sums - sums_twin).abs().max().item()
            check(k2_err <= STATS_TOL * n, f"{name}: statistics kernel at start {start}, n {n}: "
                                           f"{k2_err} > {STATS_TOL} * n")
            for tiny in (1, 2, 3, 6):  # launches of one or two partial groups
                a = cuda_exec.corr_stats(words, tiny, columns, "cuda", start=3)
                b = cuda_exec.corr_stats_reference(words, tiny, columns, "cuda", start=3)
                check((a - b).abs().max().item() <= 1e-4, f"{name}: statistics of {tiny} samples")
            record.update(k2_max_abs_err=k2_err, k2_tolerance=STATS_TOL * n)
            errs["k2"] = max(errs["k2"], k2_err)
            ab = cuda_exec.recolor_transform(plan, words, n, start=start)
        got, flag = cuda_exec.run(tape, words, n, ab, start=start)
        # A run from sample 0 over a multiple of 4 takes the float4 path.
        whole, _ = cuda_exec.run(tape, words, -(-(start + n) // 4) * 4, ab)
        twin = cuda_exec.run_reference(tape, words, n, ab, start=start)
        bitwise = bool(torch.equal(got, whole[:, start:start + n]))
        check(bitwise, f"{name}: rows {start}..{start + n} differ from the aligned run's")
        check(int(flag) == 0, f"{name}: the unaligned run flagged non-finite values")
        k1_err = (got - twin).abs().max().item()
        scale = twin.abs().max().item()
        check(k1_err <= REL_TOL * scale, f"{name}: unaligned kernel vs twin {k1_err}")
        for tiny in (1, 2, 3, 6):
            part, _ = cuda_exec.run(tape, words, tiny, ab, start=start - 2)
            check(bool(torch.equal(part, whole[:, start - 2:start - 2 + tiny])),
                  f"{name}: {tiny} samples from {start - 2} differ from the aligned run's")
        record.update(k1_bitwise_rows_of_aligned_run=bitwise, k1_max_abs_err=k1_err,
                      k1_max_abs_twin=scale, k1_tolerance=REL_TOL * scale,
                      tiny_n_checked=[1, 2, 3, 6])
        errs["k1"] = max(errs["k1"], k1_err)
        emit(record)
        del got, whole, twin

    # The Newton tier at the same start and n: a block's solve covers the
    # partial first and last groups, and every row equals the aligned run's.
    sink, nodes = family_graphs()["newton"]
    plan = _compile.get_plan(sink)
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, family_keep(nodes)(plan)), "cuda")
    got, flag = cuda_exec.run(tape, words, n, start=start)
    whole, _ = cuda_exec.run(tape, words, -(-(start + n) // 4) * 4)
    bitwise = bool(torch.equal(got, whole[:, start:start + n]))
    check(bitwise, f"newton: rows {start}..{start + n} differ from the aligned run's")
    check(int(flag) == 0, "newton: the unaligned run flagged non-finite values")
    for tiny in (1, 2, 3, 6):
        part, _ = cuda_exec.run(tape, words, tiny, start=start - 2)
        check(bool(torch.equal(part, whole[:, start - 2:start - 2 + tiny])),
              f"newton: {tiny} samples from {start - 2} differ from the aligned run's")
    del whole
    U = cuda_exec.philox_uniforms(words, n, plan.d, device="cuda", start=start)
    ref = cuda_exec.run_tape(tape, U)
    rows, worst = nodes_held(plan, tape, sink, nodes, got, ref, U, newton=True)
    for row in rows:
        check(row["held_err"] <= row["tolerance"], f"newton: unaligned kernel vs twin: {row}")
        errs["k1"] = max(errs["k1"], row["held_err"])
    emit({"phase": "unaligned_vs_twin", "graph": "newton", "start": start, "n": n,
          "k1_bitwise_rows_of_aligned_run": bitwise, "tiny_n_checked": [1, 2, 3, 6],
          "held_on": f"uniforms in {list(NEWTON_CENTRAL)}", "max_rel_err": worst,
          "nodes": rows})
    del got, ref, U

    # Two graphs that differ only in their constants: one text, one library.
    libraries = len(_build._LIBS)
    tapes, outs = [], []
    for params in ((1.0, 2.0), (-3.5, 0.25)):
        sink = priced(*params)
        plan = _compile.get_plan(sink)
        tape = cuda_exec.lowered(plan, [sink._id], "cuda")
        got, _ = cuda_exec.run(tape, words, N_NODES)
        twin = cuda_exec.run_reference(tape, words, N_NODES)
        err, scale = (got - twin).abs().max().item(), twin.abs().max().item()
        check(err <= REL_TOL * scale, f"priced{params}: kernel vs twin {err} > {REL_TOL} * {scale}")
        errs["k1"] = max(errs["k1"], err)
        tapes.append(tape)
        outs.append(got)
    keys = [_build.generated_key(t.source, cuda_exec._HEADERS) for t in tapes]
    check(keys[0] == keys[1] and tapes[0].consts != tapes[1].consts,
          "two constant sets of one structure gave two cache keys")
    check(len(_build._LIBS) == libraries + 1, "two constant sets loaded two libraries")
    check(not torch.equal(outs[0], outs[1]), "the constants did not reach the kernel")
    emit({"phase": "shared_build", "graphs": ["priced(1, 2)", "priced(-3.5, 0.25)"],
          "cache_key": keys[0], "libraries_loaded": len(_build._LIBS) - libraries,
          "constants": [list(t.consts) for t in tapes]})
    return {"k1_err": errs["k1"], "k2_err": errs["k2"]}


def cuda_events(torch, n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def sorted_pairs_ok(torch, keys, payload, got):
    """Keys equal torch.sort's, each int32 payload (the column) points at
    its key, and the payloads are a permutation of the input's."""
    sk, sp = got
    return (bool(torch.equal(sk, torch.sort(keys, dim=1).values))
            and bool(torch.equal(torch.gather(keys, 1, sp.long()), sk))
            and bool(torch.equal(torch.sort(sp, dim=1).values, torch.sort(payload, dim=1).values)))


def sort_plan(bs, K, n_blocks, k, p):
    """The launches of one ``bitonic_sort_rows`` call after its padding, in
    order: (kernel, stage, steps, launch) with ``launch()`` running it on
    the padded buffers ``k`` and ``p`` (for K3: stage None, steps the
    stages 1..T it runs inside each 2^T tile)."""
    tile = bs._tile_log(k.element_size(), p.element_size())
    n_pad_log = bs._pad_log(n_blocks)
    plan = [("sort_runs", None, tuple(range(1, tile + 1)),
             lambda: bs._sort_tiles_(k, p, n_pad_log, tile))]
    for stage in bs._merge_stages(n_pad_log, tile):
        *passes, tail = bs._merge_plan(stage, tile)
        for js in passes:
            plan.append(("block_exchange", stage, js,
                         lambda stage=stage, js=js: bs._exchange_(k, p, K, n_blocks, stage, js)))
        plan.append(("tail", stage, tail,
                     lambda stage=stage, js=tail: bs._tail_(k, p, K, n_blocks, stage, js)))
    return plan


def sort_call_ms(torch, bs, keys, payload, repeats=5):
    """Median per-kernel device ms of one ``bitonic_sort_rows`` call, from
    CUDA events around each launch, after one warm-up call."""
    K, N = keys.shape
    per_kernel = {"sort_runs": [], "block_exchange": [], "tail": []}
    for rep in range(repeats + 1):
        kp, pp = bs._pad(keys, payload)
        marks = []  # (kernel, start event, stop event)
        for name, _, _, launch in sort_plan(bs, K, kp.shape[1] // bs.RUN, kp, pp):
            start, stop = cuda_events(torch, 2)
            start.record()
            launch()
            stop.record()
            marks.append((name, start, stop))
        torch.cuda.synchronize()
        if rep:
            sums = dict.fromkeys(per_kernel, 0.0)
            for name, start, stop in marks:
                sums[name] += start.elapsed_time(stop)
            for name, value in sums.items():
                per_kernel[name].append(value)
        del kp, pp
    return {name: statistics.median(v) for name, v in per_kernel.items()}


def sort_lockstep(torch, bs, keys, payload, got):
    """Run the kernels and their plain twin side by side on the padded
    inputs of one ``bitonic_sort_rows`` call, through the same step groups,
    and hold the buffers after every launch against the twin's bitwise
    (keys and payloads), and the twin's final rows against ``got``, that
    call's output.

    Returns per kernel: the twin's ms for the same steps (CUDA events),
    the max |kernel - twin| over its launches, ``pass_bytes``, what its
    launches move as designed (each reads the padded keys and payloads
    once and writes the slots it changes; these kernels work in place),
    and ``bound_bytes``, the least any schedule must move: K3 as its pass;
    each merge stage one read of the padded buffers and one write of each
    slot the stage changes, shared between K4 and K5 in proportion to
    their ``pass_bytes`` in that stage.
    """
    K, N = keys.shape
    kp, pp = bs._pad(keys, payload)  # the kernels' buffers
    tk, tp = kp.clone(), pp.clone()  # the twin's
    n_blocks = kp.shape[1] // bs.RUN
    length = n_blocks * bs.RUN
    slot = kp.element_size() + pp.element_size()
    read = kp.numel() * slot
    out = {name: {"twin_ms": 0.0, "max_abs_err": 0.0, "pass_bytes": 0, "bound_bytes": 0.0}
           for name in ("sort_runs", "block_exchange", "tail")}

    def runs_twin(k, p):  # K3: stages 1..T inside each tile
        tile = bs._tile_log(k.element_size(), p.element_size())
        return bs.sort_tiles_reference(k, p, tile, bs._pad_log(n_blocks))

    def steps_twin(stage, js):
        def twin(k, p):
            for j in js:
                k, p = bs._step(k, p, j, bs._desc_bits(length, stage, j, k.device))
            return k, p
        return twin

    def changed(k0, p0):
        return int(((tk != k0) | (tp != p0)).sum())

    stage_start, moved = None, {}
    for name, stage, js, kernel in sort_plan(bs, K, n_blocks, kp, pp):
        if name != "sort_runs" and stage_start is None:
            stage_start, moved = (tk, tp), {"block_exchange": 0, "tail": 0}
        before_k, before_p = tk, tp
        start, stop = cuda_events(torch, 2)
        start.record()
        tk, tp = runs_twin(tk, tp) if name == "sort_runs" else steps_twin(stage, js)(tk, tp)
        stop.record()
        kernel()
        torch.cuda.synchronize()
        record = out[name]
        record["twin_ms"] += start.elapsed_time(stop)
        same = torch.equal(kp, tk) and torch.equal(pp, tp)
        check(same, f"{name} at ({K}, {N}), stage {stage}, steps {js}: kernel differs from "
                    f"its twin, {int((kp != tk).sum())} keys and {int((pp != tp).sum())} payloads")
        moves = read + changed(before_k, before_p) * slot
        record["pass_bytes"] += moves
        del before_k, before_p
        if name == "sort_runs":
            record["bound_bytes"] += moves
            continue
        moved[name] += moves
        if name == "tail":  # the stage ends: share its bound
            stage_bytes = read + changed(*stage_start) * slot
            for kernel_name, share in moved.items():
                out[kernel_name]["bound_bytes"] += stage_bytes * share / sum(moved.values())
            stage_start = None
    check(torch.equal(tk[:, :N], got[0]) and torch.equal(tp[:, :N], got[1]),
          f"({K}, {N}): bitonic_sort_rows differs from its twin")
    del kp, pp, tk, tp, stage_start
    return out


def sort_inputs(torch, gen, K, N, key_dtype=None, payload_dtype=None):
    """(K, N) normal keys with duplicates, each row's column index as payload."""
    keys = torch.randn((K, N), generator=gen, device="cuda", dtype=key_dtype or torch.float32)
    keys[:, ::7] = torch.floor(keys[:, ::7] * 4)  # duplicate keys (no -0.0)
    payload = torch.arange(N, dtype=payload_dtype or torch.int32, device="cuda")
    return keys, payload.expand(K, N).contiguous()


def k3_by_type(torch, bs, smi, library, shape, keys, payload):
    """K3 alone on the padded ``keys`` and ``payload`` of one row sort: at a
    2^14 tile where it fits, and at 2^13 followed by K5's stage 14 (the same
    stages 1..14); for 8-byte keys with 8-byte payloads at 2^13 alone.  The
    results are held equal bitwise; the times are taken in turns, each
    twice, beside one read and write of the padded buffers at the card's
    rate and ``torch.sort`` plus a gather of every tile of the row sort."""
    K = shape[0]
    kp, pp = bs._pad(keys, payload)
    del keys, payload
    n_blocks = kp.shape[1] // bs.RUN
    n_pad_log = bs._pad_log(n_blocks)
    tile = bs._tile_log(kp.element_size(), pp.element_size())
    runs = {"k3_t13": lambda k, p: bs._sort_tiles_(k, p, n_pad_log, 13)}
    if tile == 14:
        runs = {"k3_t14": lambda k, p: bs._sort_tiles_(k, p, n_pad_log, 14),
                "k3_t13_k5_stage14": lambda k, p: (
                    bs._sort_tiles_(k, p, n_pad_log, 13),
                    bs._tail_(k, p, K, n_blocks, 14, tuple(range(13, -1, -1))))}
    outs = []
    for run in runs.values():
        k, p = kp.clone(), pp.clone()
        run(k, p)
        outs.append((k, p))
    torch.cuda.synchronize()
    equal = all(torch.equal(k, outs[0][0]) and torch.equal(p, outs[0][1]) for k, p in outs)
    check(equal, f"{shape} {kp.dtype}/{pp.dtype}: K3 at 2^14 differs from 2^13 and K5's stage 14")
    del outs, k, p
    k, p = kp.clone(), pp.clone()
    times = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(cuda_time_ms(lambda: runs[name](k, p)))
    del k, p
    tile_library_ms = cuda_time_ms(
        lambda: library(kp.view(-1, 1 << tile), pp.view(-1, 1 << tile)))
    slot = kp.element_size() + pp.element_size()
    emit({"phase": "sort_k3_by_type", "card": smi, "shape": list(shape), "keys": str(kp.dtype),
          "payload": str(pp.dtype), "row_sort_tile_log": tile,
          "ms": {name: statistics.mean(v) for name, v in times.items()}, "ms_each_turn": times,
          "bitwise_equal": equal, "read_write_ms": 2 * kp.numel() * slot / HBM_BYTES_PER_S * 1e3,
          "tile_library_ms": tile_library_ms})
    del kp, pp
    torch.cuda.empty_cache()


def sort_path(torch, np, smi):
    """Phase 11: the sort kernels K3-K5 through ``bitonic_sort_rows``."""
    from probabilit_tpu_torch.ops import bitonic_sort as bs

    gen = torch.Generator(device="cuda").manual_seed(11)

    def inputs(K, N, key_dtype=torch.float32, payload_dtype=torch.int32):
        return sort_inputs(torch, gen, K, N, key_dtype, payload_dtype)

    def expected_launches(N, key_dtype=torch.float32, payload_dtype=torch.int32):
        tile = bs._tile_log(key_dtype.itemsize, payload_dtype.itemsize)
        stages = bs._merge_stages(bs._pad_log(bs.padded_blocks(N)), tile)
        return {"sort_runs": 1, "tail": len(stages),
                "block_exchange": sum(len(bs._merge_plan(s, tile)) - 1 for s in stages)}

    # The main path: the Iman-Conover shape, through the entry point.
    keys, payload = inputs(*SORT_MAIN)
    bs.RUNS_LAUNCHES = bs.EXCHANGE_LAUNCHES = bs.TAIL_LAUNCHES = 0
    got = bs.bitonic_sort_rows(keys, payload)
    torch.cuda.synchronize()
    launches = {"sort_runs": bs.RUNS_LAUNCHES, "block_exchange": bs.EXCHANGE_LAUNCHES,
                "tail": bs.TAIL_LAUNCHES}
    check(launches == expected_launches(SORT_MAIN[1]), f"sort launches per call: {launches}")
    check(sorted_pairs_ok(torch, keys, payload, got),
          "(50, 1e7): keys unsorted, payloads off their keys or not a permutation")
    emit({"phase": "sort_main_path", "shape": SORT_MAIN, "launches": launches})

    # Each kernel against its twin, bitwise, launch by launch on the main
    # inputs; then the same whole call at the check shapes, and alone.
    main = sort_lockstep(torch, bs, keys, payload, got)
    del got
    torch.cuda.empty_cache()
    emit({"phase": "sort_vs_twin_main", "shape": SORT_MAIN, "bitwise_equal": True,
          **{f"{name}_{key}": value for name, record in main.items()
             for key, value in record.items()}})
    for K, N, key_name, payload_name in SORT_CHECKS:
        key_dtype, payload_dtype = getattr(torch, key_name), getattr(torch, payload_name)
        k, p = inputs(K, N, key_dtype, payload_dtype)
        bs.RUNS_LAUNCHES = bs.EXCHANGE_LAUNCHES = bs.TAIL_LAUNCHES = 0
        got = bs.bitonic_sort_rows(k, p)
        counts = {"sort_runs": bs.RUNS_LAUNCHES, "block_exchange": bs.EXCHANGE_LAUNCHES,
                  "tail": bs.TAIL_LAUNCHES}
        ref = bs.bitonic_sort_rows_reference(k, p)
        key_err = (got[0] - ref[0]).abs().max().item()
        payload_diff = int((got[1] != ref[1]).sum())
        check(counts == expected_launches(N, key_dtype, payload_dtype),
              f"({K}, {N}) {key_dtype}/{payload_dtype}: launches {counts}")
        check(torch.equal(got[0], ref[0]) and payload_diff == 0,
              f"({K}, {N}) {key_dtype}/{payload_dtype}: kernels vs twin, key err {key_err}, "
              f"{payload_diff} payloads differ")
        check(sorted_pairs_ok(torch, k, p, got), f"({K}, {N}): keys unsorted or payloads off")
        emit({"phase": "sort_vs_twin", "shape": [K, N], "keys": str(key_dtype),
              "payload": str(payload_dtype), "n_blocks": bs.padded_blocks(N),
              "tile_log": bs._tile_log(k.element_size(), p.element_size()), "launches": counts,
              "max_abs_err": key_err, "payloads_differing": payload_diff})
        del got, ref, k, p
    k, p = (t.reshape(64, bs.SUB, bs.LANES) for t in inputs(64, 8192))
    runs = bs.sort_runs(k, p)  # K3 at T = 13
    outs, refs = [*runs, *bs.sort_runs(k[:63], p[:63])], [
        *bs.sort_runs_reference(k, p), *bs.sort_runs_reference(k[:63], p[:63])]  # odd R
    blocks = [t.reshape(2, 32, bs.SUB, bs.LANES) for t in runs]
    for stage in (18, 16):  # a whole-row stage and a partial one
        outs += bs.merge_stage(*blocks, stage)
        refs += bs.merge_stage_reference(*blocks, stage)
    alone = all(torch.equal(a, b) for a, b in zip(outs, refs))
    check(alone, "sort_runs or merge_stage alone differs from its twin")
    emit({"phase": "sort_kernels_alone", "sort_runs_runs": [64, 63], "merge_stages": [18, 16],
          "merge_shape": [2, 32, bs.SUB, bs.LANES], "bitwise_equal": alone})

    # Timings on this card, each beside torch.sort (unstable) and a gather.
    def library(k, p):
        values, idx = torch.sort(k, dim=1, stable=False)
        return values, torch.gather(p, 1, idx)

    timing = {}
    for shape in (SORT_MAIN, SORT_ROWS):
        if shape != SORT_MAIN:
            keys, payload = inputs(*shape)
            record = sort_lockstep(torch, bs, keys, payload, bs.bitonic_sort_rows(keys, payload))
        else:
            record = main
        K, N = shape
        bs.RUNS_LAUNCHES = bs.EXCHANGE_LAUNCHES = bs.TAIL_LAUNCHES = 0
        bs.bitonic_sort_rows(keys, payload)
        per_call = [bs.RUNS_LAUNCHES, bs.EXCHANGE_LAUNCHES, bs.TAIL_LAUNCHES]
        call_ms = cuda_time_ms(lambda: bs.bitonic_sort_rows(keys, payload))
        library_ms = cuda_time_ms(lambda: library(keys, payload))
        kp, pp = bs._pad(keys, payload)  # a copy moves what one K5 tail must
        kc, pc = torch.empty_like(kp), torch.empty_like(pp)
        copy_ms = cuda_time_ms(lambda: (kc.copy_(kp), pc.copy_(pp)))
        tile = bs._tile_log(kp.element_size(), pp.element_size())
        k3_library_ms = cuda_time_ms(lambda: library(kp.view(-1, 1 << tile), pp.view(-1, 1 << tile)))
        del kp, pp, kc, pc
        timing[shape] = {
            "shape": [K, N], "card": smi, "call_ms": call_ms, "library_ms": library_ms,
            "k3_library_ms": k3_library_ms,
            "launches_per_call_k3_k4_k5": per_call, "padded_copy_ms": copy_ms,
            "kernel_ms": sort_call_ms(torch, bs, keys, payload),
            "read_write_bound_ms": 2 * K * N * 8 / HBM_BYTES_PER_S * 1e3,
            "bound_ms": {name: r["bound_bytes"] / HBM_BYTES_PER_S * 1e3
                         for name, r in record.items()},
            "design_floor_ms": {name: r["pass_bytes"] / HBM_BYTES_PER_S * 1e3
                                for name, r in record.items()},
        }
        emit({"phase": "sort_timing", **timing[shape]})
        del keys, payload
    torch.cuda.empty_cache()
    for shape in (SORT_MAIN, SORT_ROWS):
        for key_name, payload_name in K3_TYPES:
            k3_by_type(torch, bs, smi, library, shape,
                       *inputs(*shape, getattr(torch, key_name), getattr(torch, payload_name)))

    kernel_ms = timing[SORT_MAIN]["kernel_ms"]
    library_ms = {"sort_runs": timing[SORT_MAIN]["k3_library_ms"],  # every tile sorted
                  "block_exchange": timing[SORT_MAIN]["library_ms"],  # the whole call
                  "tail": timing[SORT_MAIN]["library_ms"]}
    sources = {"sort_runs": 116, "block_exchange": 171, "tail": 195}
    return {"kernels": [
        {
            "name": f"bitonic_{name}",
            "route": "cuda",
            "source": "probabilit_tpu_torch/csrc/bitonic_sort.cu",
            "replaces": f"probabilit_tpu/ops/pallas_sort.py:{line}",
            "launches": launches[name],
            "max_abs_err": main[name]["max_abs_err"],
            "ms": kernel_ms[name],
            "plain_ms": main[name]["twin_ms"],
            "bound_ms": main[name]["bound_bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": library_ms[name],
        }
        for name, line in sources.items()
    ]}


def streamed_path(torch, np, cuda_exec, _compile, smi):
    """Phase 12: ``estimate`` and ``sample_streaming`` on the megakernel."""
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50, mixed_dag_20

    n_blocks = -(-N_STREAM // BLOCK)
    options = {"quantiles": (0.5, 0.99), "cvar": (0.99,)}
    shipped_solve = streaming.RECOLOR_SOLVE
    results = {}
    folds = {}
    stream_errs = {"k1": 0.0, "k2": 0.0}
    for name, build, histogram in (("mixed_dag_20", mixed_dag_20, (-2e4, 1.5e5, 100)),
                                   ("mixed_correlated_50", mixed_correlated_50, (0.0, 100.0, 100))):
        sink = build()
        correlated = name != "mixed_dag_20"
        cuda_exec.LAUNCHES = 0
        cuda_exec.STATS_LAUNCHES = 0
        cuda_exec.FOLD_LAUNCHES = 0
        st = sink.estimate(N_STREAM, random_state=0, histogram=histogram, **options)
        k1, k2, fold = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES, cuda_exec.FOLD_LAUNCHES
        check(k1 == n_blocks, f"{name}: K1 ran {k1} times for {n_blocks} blocks")
        check(k2 == (n_blocks if correlated else 0), f"{name}: K2 ran {k2} times")
        check(fold == n_blocks, f"{name}: the fold kernel ran {fold} times for {n_blocks} blocks")
        h = st["histogram"]
        counted = int(h["counts"].sum() + h["underflow"] + h["overflow"])
        check(counted == N_STREAM, f"{name}: the histogram counts {counted}")
        emit({"phase": "streamed_estimate", "graph": name, "n": N_STREAM, "block": BLOCK,
              "k1_launches": k1, "k2_launches": k2, "fold_launches": fold,
              **estimate_agrees(np, sink, st, name),
              **{k: st[k] for k in ("q0.5", "q0.99", "cvar0.99", "min", "max")},
              "histogram_counted": counted})
        results[name] = (k1, k2, fold)

        # The kernels of one streamed block (start = BLOCK) against their
        # twins, then timed alone for the host share.
        plan = _compile.get_plan(sink)
        tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, {sink._id}), "cuda")
        words = cuda_exec.seed_words(0)
        record = {"phase": "streamed_kernels_vs_twin", "graph": name, "n": BLOCK, "start": BLOCK}
        ab = None
        if correlated:
            columns = [plan.col_of[v._id] for v in plan.corr_vars]
            sums = cuda_exec.corr_stats(words, BLOCK, columns, "cuda", start=BLOCK)
            sums_twin = cuda_exec.corr_stats_reference(words, BLOCK, columns, "cuda", start=BLOCK)
            sums_first = cuda_exec.corr_stats_reference(words, BLOCK, columns, "cuda")
            k2_err = (sums - sums_twin).abs().max().item()
            check(k2_err <= STATS_TOL * BLOCK,
                  f"{name}: statistics kernel at start {BLOCK} vs twin {k2_err} > {STATS_TOL} * n")
            record.update(k2_max_abs_err=k2_err, k2_tolerance=STATS_TOL * BLOCK,
                          k2_twin_change_from_block_0=(sums_twin - sums_first).abs().max().item())
            stream_errs["k2"] = max(stream_errs["k2"], k2_err)
            ab = cuda_exec.recolor_transform(plan, words, BLOCK, start=BLOCK, solve=shipped_solve)
            del sums, sums_twin, sums_first
        got, _ = cuda_exec.run(tape, words, BLOCK, ab, start=BLOCK)
        twin = cuda_exec.run_reference(tape, words, BLOCK, ab, start=BLOCK)
        k1_err = (got - twin).abs().max().item()
        scale = twin.abs().max().item()
        check(k1_err <= REL_TOL * scale,
              f"{name}: megakernel at start {BLOCK} vs twin {k1_err} > {REL_TOL} * {scale}")
        record.update(k1_max_abs_err=k1_err, k1_max_abs_twin=scale, k1_tolerance=REL_TOL * scale)
        stream_errs["k1"] = max(stream_errs["k1"], k1_err)
        emit(record)
        del twin
        prior, _ = cuda_exec.run(tape, words, BLOCK, ab)
        folds[name] = fold_cases(torch, cuda_exec, streaming, got[0], prior[0])
        emit({"phase": "streamed_fold_vs_twin", "graph": name, "card": smi, "n": BLOCK,
              "start": BLOCK, "tolerance": FOLD_TOL, **folds[name]})
        del got, prior
        # Per launch over 20 back to back, as a stream launches them: one
        # launch alone also times the host's way to it.
        k1_ms = rotating_ms(lambda _: cuda_exec.run(tape, words, BLOCK, ab, start=BLOCK),
                            [None], 20)
        k2_ms = 0.0
        if correlated:
            k2_ms = rotating_ms(
                lambda _: cuda_exec.corr_stats(words, BLOCK, columns, "cuda", start=BLOCK),
                [None], 20)
        fold_ms = folds[name]["moments_off"]["kernel_ms"]
        kernel_ms = n_blocks * (k1_ms + k2_ms + fold_ms)

        # Timings at 1e9, quantiles (and CVaR) on and off; a correlated
        # graph with the recolour system solved on the card and on the
        # host, interleaved.
        solves = ("device", "host") if correlated else (streaming.RECOLOR_SOLVE,)
        for label, opts in (("quantiles_on", options), ("quantiles_off", {})):
            walls = {solve: [] for solve in solves}
            try:
                for _ in range(3):
                    for solve in solves:
                        streaming.RECOLOR_SOLVE = solve
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        sink.estimate(N_STREAM, random_state=0, **opts)  # ends in a host read
                        walls[solve].append((time.perf_counter() - t0) * 1e3)
            finally:
                streaming.RECOLOR_SOLVE = shipped_solve
            for solve in solves:
                wall = statistics.median(walls[solve])
                emit({"phase": "streamed_timing", "graph": name, "card": smi, "n": N_STREAM,
                      "options": label, "solve": solve if correlated else None,
                      "shipped": solve == shipped_solve, "wall_ms": wall,
                      "samples_per_sec": N_STREAM / (wall * 1e-3),
                      "k1_block_ms": k1_ms, "k2_block_ms": k2_ms, "fold_block_ms": fold_ms,
                      "kernel_ms": kernel_ms,
                      "host_share": (wall - kernel_ms) / wall})

        if correlated:
            normals = normal_drivers(plan)
            idx = [plan.corr_vars.index(v) for v in normals]
            _, run = streaming._block_program(sink, 1 << 22, "cuda", extra=tuple(normals))
            blocks = [torch.stack(run(b, 2)[1]) for b in range(-(-N_MOMENTS // (1 << 22)))]
            drivers = torch.cat(blocks, dim=1)[:, :N_MOMENTS].double()
            got_corr = torch.corrcoef(drivers).cpu().numpy()
            corr_err = float(np.abs(got_corr - plan.corr_matrix[np.ix_(idx, idx)]).max())
            check(corr_err <= CORR_TOL, f"streamed normal drivers off the target by {corr_err}")
            emit({"phase": "streamed_correlation", "n": N_MOMENTS, "block": 1 << 22,
                  "corr_max_abs_err": corr_err, "corr_tolerance": CORR_TOL})
            del drivers, blocks
        else:
            n = 1 << 26
            streamed = sink.sample_streaming(n, block_size=BLOCK, random_state=3, executor="cuda")
            single = sink.sample(n, random_state=3, gc_strategy=[], executor="cuda").cpu().numpy()
            equal = bool(np.array_equal(streamed, single))
            check(equal, "sample_streaming(2^26) differs from sample(2^26)")
            emit({"phase": "streamed_equals_single_shot", "n": n, "block": BLOCK,
                  "bitwise_equal": equal})
            del streamed, single
    return {"k1_launches": sum(k1 for k1, _, _ in results.values()),
            "k2_launches": sum(k2 for _, k2, _ in results.values()),
            "fold_launches": sum(fold for _, _, fold in results.values()),
            "k1_err": stream_errs["k1"], "k2_err": stream_errs["k2"], "folds": folds}


def moments_of(x, np):
    """(mean, std, standard error of the mean, of the std) of a float64
    tensor (the std's by the delta method)."""
    m, sd = x.mean().item(), x.std().item()
    m4 = ((x - m) ** 4).mean().item()
    n = x.numel()
    return m, sd, sd / np.sqrt(n), np.sqrt((m4 - sd**4) / n) / (2 * sd)


def executors_agree(np, sink, label):
    """The sink's mean and std through ``executor="cuda"`` and ``None`` at
    N_MOMENTS, within SE_MAX standard errors; returns their record."""
    x1, x2 = (sink.sample(N_MOMENTS, random_state=1, gc_strategy=[], executor=executor).double()
              for executor in ("cuda", None))
    (m1, s1, se_m1, se_s1), (m2, s2, se_m2, se_s2) = moments_of(x1, np), moments_of(x2, np)
    se_mean, se_std = np.hypot(se_m1, se_m2), np.hypot(se_s1, se_s2)
    check(abs(m1 - m2) <= SE_MAX * se_mean, f"{label}: mean {m1} vs {m2}")
    check(abs(s1 - s2) <= SE_MAX * se_std, f"{label}: std {s1} vs {s2}")
    return {"mean_cuda": m1, "mean_plain": m2, "mean_diff_se": abs(m1 - m2) / se_mean,
            "std_cuda": s1, "std_plain": s2, "std_diff_se": abs(s1 - s2) / se_std}


def estimate_agrees(np, sink, st, label):
    """A streamed ``estimate(N_STREAM)``'s mean and std against a one-shot
    ``sample(N_MAIN, executor="cuda")``, within SE_MAX standard errors (the
    std's by its kurtosis); returns their record."""
    x = sink.sample(N_MAIN, random_state=1, gc_strategy=[], executor="cuda").double()
    m, sd, _, _ = moments_of(x, np)
    kurt = ((x - m) ** 4).mean().item() / sd**4 - 3.0
    del x
    se_mean = np.hypot(st["sem"], sd / np.sqrt(N_MAIN))
    se_std = np.hypot(st["std"] * np.sqrt((kurt + 2) / (4 * N_STREAM)),
                      sd * np.sqrt((kurt + 2) / (4 * N_MAIN)))
    check(abs(st["mean"] - m) <= SE_MAX * se_mean, f"{label}: estimate mean {st['mean']} vs {m}")
    check(abs(st["std"] - sd) <= SE_MAX * se_std, f"{label}: estimate std {st['std']} vs {sd}")
    return {"mean": st["mean"], "std": st["std"], "single_shot_mean": m, "single_shot_std": sd,
            "mean_diff_se": abs(st["mean"] - m) / se_mean,
            "std_diff_se": abs(st["std"] - sd) / se_std}


def family_fit(np, stats, name, args, kwargs, x):
    """p-value of the column ``x`` against ``scipy.stats``: KS for a
    continuous family, ``discrete_fit``'s chi-square for a discrete one."""
    dist = getattr(stats, name)(*args, **kwargs)
    if not isinstance(dist.dist, stats.rv_discrete):
        return "ks", stats.kstest(x, dist.cdf).pvalue
    support = np.arange(dist.ppf(1e-12), dist.ppf(1 - 1e-12) + 1)
    return "chi2", discrete_fit(np, stats, x, support, dist.pmf(support))


def family_path(torch, np, stats, cuda_exec, _compile, smi):
    """Phase 14: the family branches, five graphs of at most 15 families."""
    from probabilit_tpu_torch.models.benchmarks import FAMILY_SWEEP, family_graphs

    sweep = {name: (args, kwargs) for name, args, kwargs in FAMILY_SWEEP}
    words = cuda_exec.seed_words(4)
    launches_total, graphs = 0, {}
    for index, (label, (sink, nodes)) in enumerate(family_graphs().items()):
        plan = _compile.get_plan(sink)
        newton = label == "newton"
        # The entry point a user calls, sink only, at 1e8.
        cuda_exec.LAUNCHES = 0
        out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
        torch.cuda.synchronize()
        launches = cuda_exec.LAUNCHES
        check(launches >= 1, f"{label}: the family graph launched no kernel")
        check(tuple(out.shape) == (N_MAIN,) and bool(torch.isfinite(out).all()),
              f"{label}: the sink is not finite or not of shape (1e8,)")
        launches_total += launches
        del out
        if newton:
            # Streamed through the entry point a user calls, bitwise equal
            # to one shot: each block's solves give every lane its own value.
            n_streamed = 2 * BLOCK + 4099
            cuda_exec.LAUNCHES = 0
            one_shot = sink.sample(n_streamed, random_state=5, gc_strategy=[],
                                   executor="cuda").cpu().numpy()
            streamed = sink.sample_streaming(n_streamed, block_size=BLOCK, random_state=5,
                                             executor="cuda")
            launches_total += cuda_exec.LAUNCHES
            check(np.array_equal(streamed, one_shot),
                  "newton: sample_streaming differs from one-shot sample")
            emit({"phase": "newton_streamed_equals_single_shot", "n": n_streamed,
                  "block": BLOCK, "k1_launches": cuda_exec.LAUNCHES, "bitwise_equal": True})
            del one_shot, streamed

        # Every kept node against the twin at 2^22.
        keep = family_keep(nodes)(plan)
        tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
        got, flag = cuda_exec.run(tape, words, N_NODES)
        check(int(flag) == 0, f"{label}: non-finite values on the family graph")
        U = cuda_exec.philox_uniforms(words, N_NODES, plan.d, device="cuda")
        t0 = time.perf_counter()
        ref = cuda_exec.run_tape(tape, U)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        rows, worst = nodes_held(plan, tape, sink, nodes, got, ref, U, newton)
        for row in rows:
            check(row["held_err"] <= row["tolerance"], f"{label}: kernel vs twin per node: {row}")
        if not newton:
            transcribed = transcription_held(plan, tape, nodes, got, ref, U, sweep)
            for row in rows:
                row["transcription_rel_err"] = transcribed.get(row["node"])
        emit({"phase": "family_kernel_vs_twin", "graph": label, "n": N_NODES,
              "rel_tolerance": REL_TOL, "held_on": (
                  f"uniforms in {list(NEWTON_CENTRAL)}; the sink within the sum of its "
                  "terms' tolerances" if newton else "every sample"),
              "twin_seconds": twin_s, "nodes": rows})

        # Newton ops priced at the twin's mean trips on these draws, and at
        # the Newton tier's counts.
        prices = {}
        if newton:
            for name, node in nodes:
                prices[name] = newton_cost(torch, name, sweep[name][0],
                                           U[:, plan.col_of[node._id]])
        del got, ref, U

        # Each family's column at 2^20 against scipy.stats (a seed per
        # graph: a KS statistic is the same for every monotone map of the
        # same uniforms).
        sink.sample(N_FAMILY_KS, random_state=11 + index, gc_strategy=[n for _, n in nodes],
                    executor="cuda")
        fits = {}
        for name, node in nodes:
            test, p = family_fit(np, stats, name, *sweep[name],
                                 node.samples_.double().cpu().numpy())
            fits[name] = {"test": test, "p": p}
            check(p > FAMILY_P_MIN, f"{label}: {name} fails its {test} test, p = {p}")
        emit({"phase": "family_fit", "graph": label, "n": N_FAMILY_KS, "p_min": FAMILY_P_MIN,
              "families": fits})

        # K1 at 1e8, sink only, and its bound.
        sink_tape = cuda_exec.lowered(plan, [sink._id], "cuda")
        k1_ms = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, N_MAIN),
                             repeats=3 if newton else 5)
        twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(sink_tape, words, N_NODES),
                               repeats=1)
        cost = tape_cost(sink_tape, cuda_exec, {
            cuda_exec._FAMILY_OPS[name]: price["flops"] for name, price in prices.items()})
        bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
        record = {"families": [name for name, _ in nodes], "launches": launches,
                  "ms": k1_ms, "twin_ms_at_2^22": twin_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "flops_per_sample": cost[1],
                  "int_instr_per_sample": cost[0], "max_rel_err": worst}
        if newton:
            record.update(newton_prices(sink_tape, cuda_exec, prices))
        graphs[label] = record
        emit({"phase": "family_timing", "graph": label, "card": smi, "n": N_MAIN, **record})
    graphs["newton_families"] = newton_family_timings(torch, cuda_exec, _compile, smi)
    plain_betainc_ceiling(torch, np, "cuda")
    return {"k1_launches": launches_total, "graphs": graphs,
            "library": library_family_timings(torch, cuda_exec, _compile, smi)}


def plain_betainc_ceiling(torch, np, device):
    """Phase 14's check of the plain path's float32 betainc at the top of
    its range, on ``device`` against the CPU: its ceiling is the last
    float below 1, so the t ppf near its median is 0 where the CPU's is."""
    from probabilit_tpu_torch.ops import ppf, special

    band = torch.from_numpy(np.linspace(0.499, 0.501, 4001).astype(np.float32))
    x = torch.tensor(1.0 - 2.0**-24)
    values, zeros = {}, {}
    for where in ("cpu", device):
        a, b = torch.tensor(15.0, device=where), torch.tensor(0.5, device=where)
        values[where] = special.betainc(a, b, x.to(where)).item()
        zeros[where] = int((ppf.call("t", band.to(where), 30.0) == 0.0).sum())
    clamped = special.betainc_kernel(torch.tensor(15.0), torch.tensor(0.5), x).item()
    emit({"phase": "plain_betainc_ceiling", "device": device,
          "betainc_15_half_at_1_minus_2^-24": values, "kernel_ceiling_value": clamped,
          "t30_zeros_on_4001_band": zeros})
    check(abs(values[device] - values["cpu"]) <= 1e-6,
          f"plain betainc on {device}: {values[device]} against the CPU's {values['cpu']}")
    check(abs(values[device] - clamped) > 4e-4,
          f"plain betainc on {device} stops at the kernel's ceiling: {values[device]}")
    check(zeros[device] == zeros["cpu"] == T_BAND_ZEROS,
          f"t(30) ppf zeros on the median band: {zeros}, expected {T_BAND_ZEROS}")


def transcription_held(plan, tape, nodes, got, ref, U, sweep):
    """Phase 14's check of K1's rewritten closed-form rows against their
    PyTorch transcription (ops/fast_math.py) on the same uniforms: {family:
    max |K1 - transcription| / max |twin|}, each within REL_TOL."""
    from probabilit_tpu_torch.ops import fast_math

    out = {}
    for name, node in nodes:
        if name not in fast_math.FAMILIES:
            continue
        k = tape.keep_order.index(node._id)
        want = fast_math.value(name, U[:, plan.col_of[node._id]], *sweep[name])
        out[name] = (got[k] - want).abs().max().item() / max(ref[k].abs().max().item(), 1e-30)
        check(out[name] <= REL_TOL, f"{name}: K1 against its transcription: {out[name]}")
    return out


def library_family_timings(torch, cuda_exec, _compile, smi):
    """Each LIBRARY_FAMILIES family alone: K1 at 1e8 beside its bound and
    beside torch.distributions' icdf on the same uniforms (drawn
    beforehand), the largest difference between the two, and K1 against
    its twin and its transcription at 2^22 (REL_TOL)."""
    from probabilit_tpu_torch.ops import fast_math

    distributions = torch.distributions.Distribution
    validate = distributions._validate_args
    distributions.set_default_validate_args(False)  # no support checks in the timed call
    words = cuda_exec.seed_words(4)
    u = cuda_exec.philox_uniforms(words, N_MAIN, 1, device="cuda")[:, 0]
    records = {}
    try:
        for name, (args, kwargs) in LIBRARY_FAMILIES.items():
            node = single_family(name)
            tape = cuda_exec.lowered(_compile.get_plan(node), [node._id], "cuda")
            out, flag = cuda_exec.run(tape, words, N_MAIN)
            check(int(flag) == 0, f"single {name}: non-finite values")
            icdf, library = library_icdf(torch, name, args, kwargs)
            diff = (icdf(u) - out[0]).abs().max().item()
            ref = cuda_exec.run_tape(tape, u[:N_NODES, None])[0]
            scale = ref.abs().max().item()
            record = {"twin_rel_err": (out[0, :N_NODES] - ref).abs().max().item() / scale}
            check(record["twin_rel_err"] <= REL_TOL, f"single {name}: K1 vs twin: {record}")
            if name in fast_math.FAMILIES:
                want = fast_math.value(name, u[:N_NODES], args, kwargs)
                record["transcription_rel_err"] = (out[0, :N_NODES] - want).abs().max().item() / scale
                check(record["transcription_rel_err"] <= REL_TOL,
                      f"single {name}: K1 vs its transcription: {record}")
            del out
            bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, tape_cost(tape, cuda_exec))
            record.update(
                ms=cuda_time_ms(lambda: cuda_exec.run(tape, words, N_MAIN)),
                library_ms=cuda_time_ms(lambda: icdf(u)),
                library_call=f"torch.distributions.{library}.icdf",
                library_max_abs_diff=diff, max_abs=scale, bound_ms=bound_ms, bound_by=bound_by)
            records[name] = record
            emit({"phase": "family_library", "family": name, "card": smi, "n": N_MAIN, **record})
    finally:
        distributions.set_default_validate_args(validate)
    return records


def nodes_held(plan, tape, sink, nodes, got, ref, U, newton):
    """Phase 14's per-node check of K1's rows ``got`` against the twin's
    ``ref`` on the uniforms ``U``: every sample, or for a Newton graph the
    samples whose uniforms lie in NEWTON_CENTRAL (the sink on those whose
    every uniform does, within the sum of its terms' tolerances).  Returns
    (rows, the largest held error relative to its node's largest value)."""
    central = ((U >= NEWTON_CENTRAL[0]) & (U <= NEWTON_CENTRAL[1])).all(dim=1)
    name_of = {node._id: name for name, node in nodes}
    term_scale = sum(ref[k].abs().max().item() for k, nid in enumerate(tape.keep_order)
                     if nid != sink._id)
    rows, worst = [], 0.0
    for k, nid in enumerate(tape.keep_order):
        err = (got[k] - ref[k]).abs()
        scale = ref[k].abs().max().item()
        if newton:
            col = central if nid == sink._id else (
                (U[:, plan.col_of[nid]] >= NEWTON_CENTRAL[0])
                & (U[:, plan.col_of[nid]] <= NEWTON_CENTRAL[1]))
            held = err[col].max().item()
            tol = REL_TOL * (term_scale if nid == sink._id else scale)
        else:
            held, tol = err.max().item(), REL_TOL * scale
        rows.append({"node": name_of.get(nid, "sink"), "max_abs_err": err.max().item(),
                     "held_err": held, "tolerance": tol, "max_abs_twin": scale,
                     "rel_err": held / max(scale, 1e-30)})
        worst = max(worst, rows[-1]["rel_err"])
    return rows, worst


def newton_prices(tape, cuda_exec, prices):
    """The Newton rows of ``tape`` priced both ways (``newton_cost``): the
    bound at the twin's trips with fixed-length fractions is the record's
    ``bound_ms``; this adds the re-priced bound at the Newton tier's
    counts, with the counts."""
    ops = {cuda_exec._FAMILY_OPS[name]: price["tier_flops"] for name, price in prices.items()}
    cost = tape_cost(tape, cuda_exec, ops)
    tier_ms, tier_by = bound(N_MAIN, 4 * N_MAIN, cost)
    return {"mean_newton_trips": {name: price["trips"] for name, price in prices.items()},
            "tier_counts": {name: {"trips": price["tier_trips"], "inner": price["tier_inner"]}
                            for name, price in prices.items()},
            "tier_bound_ms": tier_ms, "tier_bound_by": tier_by,
            "tier_flops_per_sample": cost[1]}


def newton_family(name):
    """A graph of one Newton family's node at its FAMILY_SWEEP parameters."""
    from probabilit_tpu_torch.models.benchmarks import FAMILY_SWEEP
    from probabilit_tpu_torch.models.distributions import Distribution

    (args, kwargs), = [(a, k) for n, a, k in FAMILY_SWEEP if n == name]
    return Distribution(name, *args, **kwargs)


def newton_family_timings(torch, cuda_exec, _compile, smi):
    """Each of the 15 Newton families alone: K1 of its one-node graph at
    1e8 beside both bounds, with the twin's and the tier's counts."""
    from probabilit_tpu_torch.models.benchmarks import FAMILY_SWEEP

    words = cuda_exec.seed_words(4)
    records = {}
    for name in cuda_exec.INCOMPLETE_FAMILY_CAPS:
        node = newton_family(name)
        plan = _compile.get_plan(node)
        tape = cuda_exec.lowered(plan, [node._id], "cuda")
        ms = cuda_time_ms(lambda: cuda_exec.run(tape, words, N_MAIN), repeats=3)
        args = [a for n, a, _ in FAMILY_SWEEP if n == name][0]
        q = cuda_exec.philox_uniforms(words, N_NODES, 1, device="cuda")[:, 0]
        price = newton_cost(torch, name, args, q)
        cost = tape_cost(tape, cuda_exec, {cuda_exec._FAMILY_OPS[name]: price["flops"]})
        bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
        record = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  **newton_prices(tape, cuda_exec, {name: price})}
        records[name] = record
        emit({"phase": "newton_family_timing", "family": name, "card": smi, "n": N_MAIN,
              **record})
    return records


def portfolio_path(torch, np, scipy, cuda_exec, _compile, smi):
    """Phase 15: the correlated portfolio of examples/03_portfolio_var.py."""
    from probabilit_tpu_torch.models.benchmarks import portfolio_var

    sink, assets = portfolio_var()
    plan = _compile.get_plan(sink)
    K = len(plan.corr_vars)
    words = cuda_exec.seed_words(0)
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    k1_launches, k2_launches = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    check(k1_launches >= 1 and k2_launches >= 1, "the portfolio launched no K1 or no K2")
    check(tuple(out.shape) == (N_MAIN,) and bool(torch.isfinite(out).all()),
          "the portfolio's sink is not finite or not of shape (1e8,)")
    del out

    # K2 at 1e8 and K1's rows (the t branch included) at 2^22 against their twins.
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    sums = cuda_exec.corr_stats(words, N_MAIN, columns, "cuda")
    sums_twin = cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda")
    k2_err = (sums - sums_twin).abs().max().item()
    check(k2_err <= STATS_TOL * N_MAIN, f"portfolio: K2 vs twin {k2_err} > {STATS_TOL} * n")
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, portfolio_keep(plan)), "cuda")
    ab = cuda_exec.recolor_transform(plan, words, N_NODES, device="cuda")
    got, _ = cuda_exec.run(tape, words, N_NODES, ab)
    ref = cuda_exec.run_reference(tape, words, N_NODES, ab)
    names = {v._id: v.distr for v in plan.corr_vars}
    rows, k1_err = [], 0.0
    for k, nid in enumerate(tape.keep_order):
        err = (got[k] - ref[k]).abs().max().item()
        scale = ref[k].abs().max().item()
        rows.append({"node": names.get(nid, "sink"), "max_abs_err": err, "max_abs_twin": scale,
                     "rel_err": err / scale})
        check(err <= REL_TOL * scale, f"portfolio: K1 vs twin per node: {rows[-1]}")
        k1_err = max(k1_err, err)
    emit({"phase": "portfolio_kernels_vs_twin", "n_k2": N_MAIN, "k2_max_abs_err": k2_err,
          "k2_tolerance": STATS_TOL * N_MAIN, "n_k1": N_NODES, "rel_tolerance": REL_TOL,
          "nodes": rows})
    del got, ref

    # The drivers' normal scores carry the repaired target at 1e7.
    sink.sample(N_MOMENTS, random_state=2, gc_strategy=plan.corr_vars, executor="cuda")
    scores = []
    for v in plan.corr_vars:
        x = v.samples_.double().cpu().numpy()
        u = getattr(scipy.stats, v.distr)(*v.args, **v.kwargs).cdf(x)
        scores.append(scipy.special.ndtri(u))
    corr_err = float(np.abs(np.corrcoef(np.stack(scores)) - plan.corr_matrix).max())
    check(corr_err <= CORR_TOL, f"portfolio drivers' correlation off the target by {corr_err}")

    # cuda against None, then the streamed estimate against the one-shot run.
    emit({"phase": "portfolio_statistics", "n": N_MOMENTS, "target": plan.corr_matrix.tolist(),
          "corr_max_abs_err": corr_err, "corr_tolerance": CORR_TOL,
          **executors_agree(np, sink, "portfolio")})

    # K1 block by block, as estimate launches it (block b from b * BLOCK),
    # against one launch over the same rows, given one recolour transform:
    # a lane's Newton solve is its own, so the two are equal bitwise.
    n_streamed = 3 * BLOCK + 4099  # a partial last block
    sink_tape = cuda_exec.lowered(plan, [sink._id], "cuda")
    ab = cuda_exec.recolor_transform(plan, words, n_streamed, device="cuda")
    one_shot, _ = cuda_exec.run(sink_tape, words, n_streamed, ab)
    blocks = [cuda_exec.run(sink_tape, words, min(BLOCK, n_streamed - lo), ab, start=lo)[0]
              for lo in range(0, n_streamed, BLOCK)]
    streamed_bitwise = bool(torch.equal(torch.cat(blocks, dim=1), one_shot))
    check(streamed_bitwise, "portfolio: K1 streamed block by block differs from one launch")
    del one_shot, blocks
    emit({"phase": "portfolio_streamed_equals_one_shot", "n": n_streamed, "block": BLOCK,
          "bitwise_equal": streamed_bitwise})

    n_blocks = -(-N_STREAM // BLOCK)
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    st = sink.estimate(N_STREAM, random_state=0, quantiles=PORTFOLIO_QUANTILES, executor="auto")
    k1, k2 = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    check(k1 == n_blocks and k2 == n_blocks, f"portfolio estimate: K1 {k1}, K2 {k2} launches")
    k1_launches, k2_launches = k1_launches + k1, k2_launches + k2
    emit({"phase": "portfolio_estimate", "n": N_STREAM, "block": BLOCK, "k1_launches": k1,
          "k2_launches": k2, **estimate_agrees(np, sink, st, "portfolio"),
          **{f"q{q:g}": st[f"q{q:g}"] for q in PORTFOLIO_QUANTILES}})

    # Timings: the kernels alone, sample(1e8) and estimate(1e9), host share.
    ab = cuda_exec.recolor_transform(plan, words, N_MAIN, device="cuda")
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, N_MAIN, ab))
    k2_ms = cuda_time_ms(lambda: cuda_exec.corr_stats(words, N_MAIN, columns, "cuda"))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(sink_tape, words, N_NODES, ab),
                           repeats=1)
    sample_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    plain_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor=None), repeats=1)
    block_k1 = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, BLOCK, ab, start=BLOCK))
    block_k2 = cuda_time_ms(lambda: cuda_exec.corr_stats(words, BLOCK, columns, "cuda", start=BLOCK))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sink.estimate(N_STREAM, random_state=0, quantiles=PORTFOLIO_QUANTILES)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    stream_kernel_ms = n_blocks * (block_k1 + block_k2)
    # The t op priced on its own column's uniforms (its recoloured
    # quantiles are uniform too).
    t_col = cuda_exec.philox_uniforms(
        words, N_NODES, plan.d, device="cuda", columns=[plan.col_of[assets["commodities"]._id]])
    price = newton_cost(torch, "t", (4,), t_col[:, 0])
    del t_col
    cost = tape_cost(sink_tape, cuda_exec, {"PPF_T": price["flops"]})
    bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
    k2_bytes = 8 * cuda_exec._stats_width(K) * cuda_exec.stats_grid(K, N_MAIN)
    k2_bound_ms, k2_bound_by = bound(N_MAIN, k2_bytes, stats_cost(K))
    record = {"launches": k1_launches, "ms": k1_ms, "twin_ms_at_2^22": twin_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "flops_per_sample": cost[1],
              **newton_prices(sink_tape, cuda_exec, {"t": price}),
              "k2_ms": k2_ms, "k2_bound_ms": k2_bound_ms,
              "k2_bound_by": k2_bound_by, "sample_cuda_ms": sample_ms,
              "sample_plain_ms": plain_ms,
              "sample_host_share": (sample_ms - k1_ms - k2_ms) / sample_ms,
              "estimate_1e9_ms": wall, "estimate_block_k1_ms": block_k1,
              "estimate_block_k2_ms": block_k2,
              "estimate_host_share": (wall - stream_kernel_ms) / wall}
    emit({"phase": "portfolio_timing", "card": smi, "n": N_MAIN, "k": K, **record})
    return {"k1_launches": k1_launches, "k2_launches": k2_launches, "k1_err": k1_err,
            "k2_err": k2_err, "record": record}


def discrete_fit(np, stats, x, support, pmf):
    """Chi-square p-value of the integer-valued column ``x`` against the law
    with ``pmf`` on ``support`` (sorted); support points expecting fewer
    than 20 samples are merged into one bin."""
    values, counts = np.unique(x, return_counts=True)
    where = np.searchsorted(support, values)
    check(bool(np.all(support[np.minimum(where, len(support) - 1)] == values)),
          "a sampled value lies outside the law's support")
    observed = np.zeros(len(support))
    observed[where] = counts
    return counts_fit(np, stats, observed, pmf)


def counts_fit(np, stats, observed, pmf):
    """``discrete_fit`` on the counts ``observed`` of each support point."""
    expected = pmf * observed.sum()
    small = expected < 20
    if small.any():
        observed = np.append(observed[~small], observed[small].sum())
        expected = np.append(expected[~small], expected[small].sum())
    return stats.chisquare(observed, expected * observed.sum() / expected.sum()).pvalue


def table_laws(np, stats, nodes):
    """{name: (test, exact law)} of ``table_risk``'s columns: a discrete
    column's (support, pmf), an interpolated column's CDF."""
    laws = {}
    for name, node in nodes.items():
        kind = type(node).__name__
        if kind == "Distribution":
            dist = getattr(stats, node.distr)(*node.args, **node.kwargs)
            support = np.arange(dist.ppf(1e-12), dist.ppf(1 - 1e-12) + 1)
            laws[name] = ("chi2", (support, dist.pmf(support)))
        elif kind == "DiscreteDistribution":
            order = np.argsort(node.values)
            laws[name] = ("chi2", (node.values[order].astype(np.float64),
                                   node.probabilities[order]))
        elif kind == "EmpiricalDistribution":
            data = np.sort(node.data)
            grid = np.linspace(0.0, 1.0, len(data))
            laws[name] = ("ks", lambda x, data=data, grid=grid: np.interp(x, data, grid))
        else:
            laws[name] = ("ks", lambda x, node=node: np.interp(x, node.cumulatives, node.q))
    return laws


def fit_p(np, stats, law, x):
    test, exact = law
    if test == "chi2":
        return discrete_fit(np, stats, x, *exact)
    return stats.kstest(x, exact).pvalue


def correlated_tables_drawn():
    """``table_risk_correlated``'s margin on its own nodes, uncorrelated:
    its Empirical, Cumulative and Poisson tables searched from the
    kernel's own draws.  Returns ``(margin, {name: node})``."""
    from probabilit_tpu_torch.models.benchmarks import table_risk_correlated

    _, n = table_risk_correlated()
    return n["orders"] * (n["price"] - n["unit_cost"]) - n["lead_time"] * 50.0, n


def dist_keep(plan):
    """The sink and every distribution node."""
    return {plan.sink._id} | {node._id for node in plan.dist_nodes}


def table_prices(torch, cuda_exec, tape, words, ab=None):
    """``tape``'s table rows through the guide-indexed search on the twin's
    quantiles at N_NODES: the transcription (``ops/table_search.py``) held
    bitwise to the twin's rows, its loads a lookup and its wavefronts a
    sample (``table_search.warp_wavefronts``), and the bound at N_MAIN
    re-priced at those counts: the larger of the bytes, the operations
    (``TABLE_STEP`` a load of the search) and the wavefronts at
    ``SHARED_WAVEFRONTS_PER_S``."""
    import dataclasses

    from probabilit_tpu_torch.ops import table_search

    rows = [row for row in tape.program if cuda_exec.OPCODES[row[0]] in TABLE_TAIL]
    store = cuda_exec._OPCODE["STORE"]
    # The same tape, also storing each table row's quantile.
    probe = dataclasses.replace(
        tape,
        program=tape.program + tuple((store, tape.n_keep + i, row[2], -1, -1, -1)
                                     for i, row in enumerate(rows)),
        keep_order=tape.keep_order + tuple(range(len(rows))),
        imm=torch.cat([tape.imm, tape.imm.new_zeros(len(rows))]))
    U = cuda_exec.philox_uniforms(words, N_NODES, tape.d, device="cuda")
    quantiles = cuda_exec.run_program(probe, U, ab)[tape.n_keep:]
    del U
    guides = {dst: tuple(guide) for dst, *guide in tape.guides}
    per_row, wavefronts, flops = [], 0.0, {}
    for (op, dst, _, offset, nb, _), q in zip(rows, quantiles):
        name = cuda_exec.OPCODES[op]
        value, steps = table_search.lookup(name, tape.tables, offset, nb, q, guides.get(dst))
        twin = cuda_exec._table_row(name, tape.tables, offset, nb, q)
        check(torch.equal(value, twin), f"{name} of {nb} boundaries: transcription != twin")
        loads = steps.double().mean().item() + (dst in guides)
        warp = table_search.warp_wavefronts(name, steps, dst in guides)
        flops[dst] = TABLE_STEP * loads + TABLE_TAIL[name]
        wavefronts += warp
        per_row.append({"row": name, "boundaries": nb, "guide": guides.get(dst, (0, 1, 0))[1:],
                        "search_loads_per_lookup": loads, "warp_wavefronts_per_sample": warp})
    shared_ms = wavefronts * N_MAIN / SHARED_WAVEFRONTS_PER_S * 1e3
    bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN * tape.n_keep,
                               tape_cost(tape, cuda_exec, tables=flops))
    if shared_ms > bound_ms:
        bound_ms, bound_by = shared_ms, "shared memory"
    return {"table_rows": per_row, "wavefronts_per_sample": wavefronts,
            "shared_wavefront_ms": shared_ms, "repriced_bound_ms": bound_ms,
            "repriced_bound_by": bound_by, "guide_floats": tape.guide_floats}


def table_path(torch, np, scipy, cuda_exec, _compile, smi, registers):
    """Phase 16: K1's table branch (large_table, table_risk,
    table_risk_correlated) and the plain path's table, PCHIP and string
    tiers."""
    from probabilit_tpu_torch.models.benchmarks import (
        bird_survival,
        large_table,
        table_risk,
        table_risk_correlated,
    )
    from probabilit_tpu_torch.models.distributions import DiscreteDistribution, Distribution

    stats = scipy.stats
    launches, k1_err, k2_err, records = 0, 0.0, 0.0, {}

    # large_table(): bench.py's poisson(2000) + 0.0 at 1e8 and 4e8.
    sink = large_table()
    plan = _compile.get_plan(sink)
    poisson = plan.dist_nodes[0]
    record = {}
    for n, label in ((N_MAIN, "sample_ms_1e8"), (4 * N_MAIN, "sample_ms_4e8")):
        cuda_exec.LAUNCHES = 0
        out = sink.sample(n, random_state=0, gc_strategy=[], executor="cuda")
        torch.cuda.synchronize()
        check(cuda_exec.LAUNCHES >= 1, "large_table: K1 was not launched")
        check(tuple(out.shape) == (n,) and bool(torch.isfinite(out).all()),
              "large_table: the sink is not finite or not of its shape")
        launches += cuda_exec.LAUNCHES
        del out
        record[label] = cuda_time_ms(
            lambda: sink.sample(n, random_state=0, gc_strategy=[], executor="cuda"))
    record["slope_ns_per_sample"] = (
        (record["sample_ms_4e8"] - record["sample_ms_1e8"]) * 1e6 / (3 * N_MAIN))
    words = cuda_exec.seed_words(16)
    keep = {sink._id, poisson._id}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    got, flag = cuda_exec.run(tape, words, N_NODES)
    ref = cuda_exec.run_reference(tape, words, N_NODES)
    check(int(flag) == 0 and torch.equal(got, ref), "large_table: K1 differs from its twin")
    del got, ref
    table, loc = cuda_exec.trimmed_cdf_table(poisson)
    x = sink.sample(N_FAMILY_KS, random_state=17, gc_strategy=[], executor="cuda")
    dist = stats.poisson(2000)
    support = np.arange(dist.ppf(1e-12), dist.ppf(1 - 1e-12) + 1)
    p = discrete_fit(np, stats, x.double().cpu().numpy(), support, dist.pmf(support))
    check(p > FAMILY_P_MIN, f"large_table: chi-square against poisson(2000), p = {p}")
    sink_tape = cuda_exec.lowered(plan, [sink._id], "cuda")
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, N_MAIN))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(sink_tape, words, N_NODES), repeats=1)
    bounds = torch.from_numpy(table[:-1]).cuda()
    u = torch.rand(N_MAIN, device="cuda")
    library_ms = cuda_time_ms(lambda: torch.searchsorted(bounds, u) + loc)
    del u
    cost = tape_cost(sink_tape, cuda_exec)
    bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
    record.update(knots=len(table), loc=loc, k1_ms=k1_ms, twin_ms_at_2_22=twin_ms,
                  library_searchsorted_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                  flops_per_sample=cost[1], int_instr_per_sample=cost[0], chi2_p=p,
                  shared_bytes=sink_tape.shared_bytes,
                  registers_and_spill_bytes=registers.get("large_table"),
                  **table_prices(torch, cuda_exec, sink_tape, words))
    emit({"phase": "table_large", "card": smi, "n": [N_MAIN, 4 * N_MAIN], **record})
    records["large_table"] = record
    main = {"ms": k1_ms, "plain_ms": twin_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "repriced_bound_ms": record["repriced_bound_ms"]}

    # table_risk(): every kind of table node on one tape.
    sink, nodes = table_risk()
    plan = _compile.get_plan(sink)
    cuda_exec.LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    check(cuda_exec.LAUNCHES >= 1, "table_risk: K1 was not launched")
    check(tuple(out.shape) == (N_MAIN,) and bool(torch.isfinite(out).all()),
          "table_risk: the sink is not finite or not of shape (1e8,)")
    launches += cuda_exec.LAUNCHES
    del out
    keep = {sink._id} | {node._id for node in nodes.values()}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    got, flag = cuda_exec.run(tape, words, N_NODES)
    ref = cuda_exec.run_reference(tape, words, N_NODES)
    check(int(flag) == 0, "table_risk: non-finite values")
    name_of = {node._id: name for name, node in nodes.items()}
    rows = []
    for k, nid in enumerate(tape.keep_order):
        err = (got[k] - ref[k]).abs().max().item()
        scale = ref[k].abs().max().item()
        name = name_of.get(nid, "sink")
        bitwise = bool(torch.equal(got[k], ref[k]))
        rows.append({"node": name, "bitwise": bitwise, "max_abs_err": err, "max_abs_twin": scale})
        if name == "sink":
            check(err <= REL_TOL * scale, f"table_risk: sink vs twin {err} > {REL_TOL} * {scale}")
            k1_err = max(k1_err, err / scale)
        else:
            check(bitwise, f"table_risk: {name} differs from its twin")
    emit({"phase": "table_risk_vs_twin", "n": N_NODES, "rel_tolerance": REL_TOL, "nodes": rows})
    del got, ref
    sink.sample(N_FAMILY_KS, random_state=18, gc_strategy=list(nodes.values()), executor="cuda")
    fits = {}
    for name, law in table_laws(np, stats, nodes).items():
        p = fit_p(np, stats, law, nodes[name].samples_.double().cpu().numpy())
        fits[name] = {"test": law[0], "p": p}
        check(p > FAMILY_P_MIN, f"table_risk: {name} fails its {law[0]} test, p = {p}")
    emit({"phase": "table_risk_fit", "n": N_FAMILY_KS, "p_min": FAMILY_P_MIN, "nodes": fits})
    agree = executors_agree(np, sink, "table_risk")
    sink_tape = cuda_exec.lowered(plan, [sink._id], "cuda")
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, N_MAIN))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(sink_tape, words, N_NODES), repeats=1)
    cost = tape_cost(sink_tape, cuda_exec)
    bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
    record = {"launches": launches, "k1_ms": k1_ms, "twin_ms_at_2_22": twin_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "flops_per_sample": cost[1],
              "int_instr_per_sample": cost[0], "shared_bytes": sink_tape.shared_bytes,
              "registers_and_spill_bytes": registers.get("table_risk"), **agree,
              **table_prices(torch, cuda_exec, sink_tape, words)}
    emit({"phase": "table_risk_timing", "card": smi, "n": N_MAIN, **record})
    records["table_risk"] = record

    # table_risk_correlated(): K2 and K1's recolour branch into the table rows.
    sink, nodes = table_risk_correlated()
    plan = _compile.get_plan(sink)
    K = len(plan.corr_vars)
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
    torch.cuda.synchronize()
    k1, k2 = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    check(k1 >= 1 and k2 >= 1, "table_risk_correlated: K1 or K2 was not launched")
    check(bool(torch.isfinite(out).all()), "table_risk_correlated: non-finite sink")
    launches, k2_launches = launches + k1, k2
    del out
    columns = [plan.col_of[v._id] for v in plan.corr_vars]
    sums = cuda_exec.corr_stats(words, N_MAIN, columns, "cuda")
    sums_twin = cuda_exec.corr_stats_reference(words, N_MAIN, columns, "cuda")
    k2_err = (sums - sums_twin).abs().max().item()
    check(k2_err <= STATS_TOL * N_MAIN, f"table_risk_correlated: K2 vs twin {k2_err}")
    keep = {sink._id} | {v._id for v in plan.corr_vars}
    tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, keep), "cuda")
    ab = cuda_exec.recolor_transform(plan, words, N_NODES, device="cuda")
    got, flag = cuda_exec.run(tape, words, N_NODES, ab)
    ref = cuda_exec.run_reference(tape, words, N_NODES, ab)
    check(int(flag) == 0, "table_risk_correlated: non-finite values")
    # The recoloured quantiles went through the hardware's ndtr_fast, so a
    # count may cross a CDF step; the sink is held where the counts agree.
    k_orders = tape.keep_order.index(nodes["orders"]._id)
    count_err = (got[k_orders] - ref[k_orders]).abs()
    flips = (count_err > 0).float().mean().item()
    check(count_err.max().item() <= 1 and flips <= 1e-3,
          f"table_risk_correlated: orders off by {count_err.max().item()} on {flips} of samples")
    same = count_err == 0
    name_of = {node._id: name for name, node in nodes.items()}
    rows = [{"node": "orders", "max_abs_err": count_err.max().item(), "share_off": flips}]
    for k, nid in enumerate(tape.keep_order):
        if k == k_orders:
            continue
        err = (got[k] - ref[k]).abs()[same].max().item()
        scale = ref[k].abs().max().item()
        rows.append({"node": name_of.get(nid, "sink"), "max_abs_err": err, "max_abs_twin": scale})
        check(err <= REL_TOL * scale, f"table_risk_correlated: K1 vs twin: {rows[-1]}")
        k1_err = max(k1_err, err / scale)
    emit({"phase": "table_correlated_vs_twin", "n_k2": N_MAIN, "k2_max_abs_err": k2_err,
          "k2_tolerance": STATS_TOL * N_MAIN, "n_k1": N_NODES, "rel_tolerance": REL_TOL,
          "nodes": rows})
    del got, ref

    # Its table nodes drawn directly (the same tables, no recolour): bitwise.
    drawn, drawn_nodes = correlated_tables_drawn()
    drawn_plan = _compile.get_plan(drawn)
    drawn_keep = cuda_exec.keep_order(drawn_plan, dist_keep(drawn_plan))
    drawn_tape = cuda_exec.lowered(drawn_plan, drawn_keep, "cuda")
    got, flag = cuda_exec.run(drawn_tape, words, N_NODES)
    ref = cuda_exec.run_reference(drawn_tape, words, N_NODES)
    check(int(flag) == 0, "table_risk_correlated, drawn: non-finite values")
    name_of = {node._id: name for name, node in drawn_nodes.items()}
    rows = []
    for k, nid in enumerate(drawn_tape.keep_order):
        name = name_of.get(nid, "sink")
        err = (got[k] - ref[k]).abs().max().item()
        rows.append({"node": name, "bitwise": bool(torch.equal(got[k], ref[k])),
                     "max_abs_err": err})
        if name in ("unit_cost", "lead_time", "orders"):
            check(rows[-1]["bitwise"],
                  f"table_risk_correlated, drawn: {name} differs from its twin")
        else:
            check(err <= REL_TOL * ref[k].abs().max().item(),
                  f"table_risk_correlated, drawn: {rows[-1]}")
    emit({"phase": "table_correlated_drawn_vs_twin", "n": N_NODES, "nodes": rows})
    del got, ref

    # The drivers carry the repaired target at 1e7: the continuous ones'
    # normal scores through their exact CDFs; the count's correlation with
    # them is the target times corr(F^-1(Phi(Y)), Y), by quadrature.
    sink.sample(N_MOMENTS, random_state=2, gc_strategy=plan.corr_vars, executor="cuda")
    tiny = 2.0**-24
    x = {name: node.samples_.double().cpu().numpy() for name, node in nodes.items()}
    emp = np.sort(nodes["unit_cost"].data)
    cum = nodes["lead_time"]
    scores = {
        "price": (x["price"] - 100.0) / 15.0,
        "unit_cost": scipy.special.ndtri(np.clip(
            np.interp(x["unit_cost"], emp, np.linspace(0, 1, len(emp))), tiny, 1 - tiny)),
        "lead_time": scipy.special.ndtri(np.clip(
            np.interp(x["lead_time"], cum.cumulatives, cum.q), tiny, 1 - tiny)),
    }
    index = {v._id: i for i, v in enumerate(plan.corr_vars)}
    at = {name: index[node._id] for name, node in nodes.items()}
    target = plan.corr_matrix
    y = np.linspace(-8.0, 8.0, 200_001)
    w = scipy.stats.norm.pdf(y)
    w /= w.sum()
    counts = scipy.stats.poisson(400).ppf(np.clip(scipy.special.ndtr(y), tiny, 1 - tiny))
    mean_c = (w * counts).sum()
    attenuation = (w * (counts - mean_c) * y).sum() / np.sqrt((w * (counts - mean_c) ** 2).sum())
    corr_err = 0.0
    names = list(scores)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            got_r = np.corrcoef(scores[a], scores[b])[0, 1]
            corr_err = max(corr_err, abs(got_r - target[at[a], at[b]]))
        got_r = np.corrcoef(x["orders"], scores[a])[0, 1]
        corr_err = max(corr_err, abs(got_r - attenuation * target[at["orders"], at[a]]))
    check(corr_err <= CORR_TOL, f"table_risk_correlated: drivers off the target by {corr_err}")
    del x
    emit({"phase": "table_correlated_statistics", "n": N_MOMENTS, "target": target.tolist(),
          "count_attenuation": attenuation, "corr_max_abs_err": corr_err,
          "corr_tolerance": CORR_TOL, **executors_agree(np, sink, "table_risk_correlated")})

    n_blocks = -(-N_STREAM // BLOCK)
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    st = sink.estimate(N_STREAM, random_state=0, executor="auto")
    k1, k2 = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
    check(k1 == n_blocks and k2 == n_blocks, f"table_risk_correlated estimate: K1 {k1}, K2 {k2}")
    launches, k2_launches = launches + k1, k2_launches + k2
    emit({"phase": "table_correlated_estimate", "n": N_STREAM, "block": BLOCK,
          "k1_launches": k1, "k2_launches": k2,
          **estimate_agrees(np, sink, st, "table_risk_correlated")})

    sink_tape = cuda_exec.lowered(plan, [sink._id], "cuda")
    ab = cuda_exec.recolor_transform(plan, words, N_MAIN, device="cuda")
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, N_MAIN, ab))
    k2_ms = cuda_time_ms(lambda: cuda_exec.corr_stats(words, N_MAIN, columns, "cuda"))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(sink_tape, words, N_NODES, ab),
                           repeats=1)
    sample_ms = cuda_time_ms(
        lambda: sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    block_k1 = cuda_time_ms(lambda: cuda_exec.run(sink_tape, words, BLOCK, ab, start=BLOCK))
    block_k2 = cuda_time_ms(lambda: cuda_exec.corr_stats(words, BLOCK, columns, "cuda", start=BLOCK))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sink.estimate(N_STREAM, random_state=0)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    stream_kernel_ms = n_blocks * (block_k1 + block_k2)
    cost = tape_cost(sink_tape, cuda_exec)
    bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
    record = {"k1_ms": k1_ms, "k2_ms": k2_ms, "twin_ms_at_2_22": twin_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "flops_per_sample": cost[1],
              "sample_cuda_ms": sample_ms, "sample_host_share": (sample_ms - k1_ms - k2_ms) / sample_ms,
              "estimate_1e9_ms": wall, "estimate_block_k1_ms": block_k1,
              "estimate_block_k2_ms": block_k2,
              "estimate_host_share": (wall - stream_kernel_ms) / wall,
              "shared_bytes": sink_tape.shared_bytes,
              "registers_and_spill_bytes": registers.get("table_risk_correlated"),
              **table_prices(torch, cuda_exec, sink_tape, words, ab)}
    emit({"phase": "table_correlated_timing", "card": smi, "n": N_MAIN, "k": K, **record})
    records["table_risk_correlated"] = record

    # The plain path's tiers on the card, at 1e7 through executor=None.
    birds = bird_survival()
    x = birds.sample(N_MOMENTS, random_state=3, executor=None).double()
    m, sd, se, _ = moments_of(x, np)
    check(abs(m - 1.2) <= SE_MAX * se, f"bird_survival: mean {m}, not 1.2")
    try:
        birds.sample(1000, random_state=0, gc_strategy=[], executor="cuda")
    except ValueError:
        refused = True
    else:
        refused = False
    check(refused, "executor='cuda' took a composite binom")
    skew = Distribution("skewnorm", 3.0)
    t0 = time.perf_counter()
    x = skew.sample(N_MOMENTS, random_state=4, executor=None)
    torch.cuda.synchronize()
    pchip_s = time.perf_counter() - t0
    x = x.double().cpu().numpy()
    ks_p = stats.kstest(
        x, lambda v: scipy.special.ndtr(v) - 2.0 * scipy.special.owens_t(v, 3.0)).pvalue
    check(ks_p > FAMILY_P_MIN, f"skewnorm(3) through its PCHIP table: KS p = {ks_p}")
    values, probs = np.array(["low", "mid", "high"]), np.array([0.2, 0.5, 0.3])
    labels = DiscreteDistribution(values, probs)
    freq = {}
    for how, draw in (("sample", lambda: labels.sample(N_MOMENTS, random_state=5)),
                      ("sample_streaming", lambda: labels.sample_streaming(
                          N_MOMENTS, random_state=5, executor=None))):
        got_values = draw()
        check(isinstance(got_values, np.ndarray) and got_values.dtype == values.dtype,
              f"string DiscreteDistribution through {how} gave {type(got_values)}")
        share = np.array([np.mean(got_values == v) for v in values])
        check(bool(np.all(np.abs(share - probs) <= SE_MAX * np.sqrt(probs * (1 - probs) / N_MOMENTS))),
              f"string DiscreteDistribution through {how}: shares {share}")
        freq[how] = share.tolist()
    try:
        labels.estimate(1 << 20)
    except ValueError:
        refused = True
    else:
        refused = False
    check(refused, "estimate() took a string sink")
    emit({"phase": "table_plain_tiers", "n": N_MOMENTS, "bird_survival_mean": m,
          "bird_survival_mean_diff_se": abs(m - 1.2) / se, "cuda_refuses_composite_binom": True,
          "skewnorm_pchip_ks_p": ks_p, "skewnorm_pchip_seconds": pchip_s,
          "string_discrete_shares": freq, "estimate_refuses_strings": True})
    return {"k1_launches": launches, "k2_launches": k2_launches, "k1_err": k1_err,
            "k2_err": k2_err, "records": records, "main": main}


def typed_agreement(torch, got, ref, typed):
    """K1 (``got``) against its twin (``ref``) on a graph of int32 and bool
    nodes fed by float comparisons: the rows ``typed`` equal but on at most
    ``TYPED_SHARE_MAX`` of the samples, and off by at most 1 there; the
    other rows within REL_TOL of their largest value where every typed row
    agrees.  Returns (rows, the share off, the largest relative error)."""
    same = torch.ones(got.shape[1], dtype=torch.bool, device=got.device)
    rows, rel, abs_err = [], 0.0, 0.0
    for k in typed:
        err = (got[k] - ref[k]).abs()
        rows.append({"row": k, "max_abs_err": err.max().item(),
                     "share_off": (err > 0).float().mean().item()})
        same &= err == 0
    share = 1.0 - same.float().mean().item()
    check(all(r["max_abs_err"] <= 1 for r in rows) and share <= TYPED_SHARE_MAX,
          f"int and bool nodes: {rows}, {share} of the samples off")
    for k in range(got.shape[0]):
        if k in typed:
            continue
        err = (got[k] - ref[k]).abs()[same].max().item()
        scale = ref[k].abs().max().item()
        rows.append({"row": k, "max_abs_err": err, "max_abs_twin": scale})
        check(err <= REL_TOL * scale, f"float node where the typed ones agree: {rows[-1]}")
        rel, abs_err = max(rel, err / scale), max(abs_err, err)
    return rows, share, rel, abs_err


def exact_breach_law(np, scipy, correlated):
    """(P(severe), pmf of overruns) of breach_count: ten independent
    Bernoullis of p_i = P(cost_i > budget_i); None when correlated."""
    if correlated:
        return None, None
    from probabilit_tpu_torch.models.benchmarks import BREACH_BUDGETS

    costs = [scipy.stats.triang(0.3, loc=80 + 5 * i, scale=60) for i in range(6)]
    costs += [scipy.stats.lognorm(0.25, scale=100 + 10 * j) for j in range(4)]
    pmf = np.array([1.0])
    for cost, budget in zip(costs, BREACH_BUDGETS):
        p = cost.sf(budget)
        pmf = np.convolve(pmf, [1 - p, p])
    return float(pmf[3:].sum()), pmf


def estimates_agree(np, a, b, label):
    """Two estimates' means within SE_MAX of their joint standard error."""
    se = float(np.hypot(a["sem"], b["sem"]))
    check(abs(a["mean"] - b["mean"]) <= SE_MAX * se, f"{label}: {a['mean']} vs {b['mean']}")
    return abs(a["mean"] - b["mean"]) / se


def wall_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def typed_path(torch, np, scipy, cuda_exec, _compile, smi, registers, int_cost, here):
    """Phase 17: K1's int32 and bool values, and the sequential and
    checkpointed estimates."""
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models.benchmarks import (
        breach_count,
        breach_count_correlated,
        portfolio_var,
        typed_ops,
    )

    words = cuda_exec.seed_words(17)
    launches = k2_launches = 0
    records = {}

    # typed_ops: every kept node bitwise, 15 leaves at a time beside the sink.
    sink, leaves, r7 = typed_ops()
    plan = _compile.get_plan(sink)
    bitwise = {}
    for label, group in typed_ops_groups(leaves).items():
        tape = cuda_exec.lowered(plan, cuda_exec.keep_order(plan, group_keep(plan, leaves, group)),
                                 "cuda")
        got, flag = cuda_exec.run(tape, words, N_NODES)
        ref = cuda_exec.run_reference(tape, words, N_NODES)
        bitwise[label] = bool(torch.equal(got, ref)) and int(flag) == 0
        check(bitwise[label], f"typed_ops: {label} differs from the twin")
    emit({"phase": "typed_ops_vs_twin", "n": N_NODES, "leaves": len(leaves), "r7_leaves": list(r7),
          "bitwise": bitwise, "registers_and_spill_bytes": {
              label: registers.get(label) for label in bitwise}})
    records["typed_ops"] = {"bitwise": all(bitwise.values()), "leaves": len(leaves)}

    # breach_count and breach_count_correlated.
    k1_err = k1_abs_err = 0.0
    for name, build in (("breach_count", breach_count),
                        ("breach_count_correlated", breach_count_correlated)):
        correlated = name.endswith("correlated")
        loss, nodes = build()
        plan = _compile.get_plan(loss)
        cuda_exec.LAUNCHES = 0
        cuda_exec.STATS_LAUNCHES = 0
        out = loss.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
        torch.cuda.synchronize()
        k1, k2 = cuda_exec.LAUNCHES, cuda_exec.STATS_LAUNCHES
        check(k1 >= 1 and (k2 >= 1) == correlated, f"{name}: K1 {k1}, K2 {k2} launches")
        check(tuple(out.shape) == (N_MAIN,) and bool(torch.isfinite(out).all()),
              f"{name}: the sink is not finite or not of shape (1e8,)")
        launches, k2_launches = launches + k1, k2_launches + k2
        del out
        record = {"main_path_k1_launches": k1, "main_path_k2_launches": k2}
        checks = {}
        for label, node, keep in (("typed nodes", loss, breach_keep(plan, nodes)),
                                  ("severe", nodes["severe"], None)):
            node_plan = _compile.get_plan(node)
            keep = keep or {node._id}
            tape = cuda_exec.lowered(node_plan, cuda_exec.keep_order(node_plan, keep), "cuda")
            ab = (cuda_exec.recolor_transform(node_plan, words, N_NODES, device="cuda")
                  if correlated else None)
            got, flag = cuda_exec.run(tape, words, N_NODES, ab)
            ref = cuda_exec.run_reference(tape, words, N_NODES, ab)
            check(int(flag) == 0, f"{name}: non-finite values")
            typed = [k for k, nid in enumerate(tape.keep_order)
                     if nid != loss._id or label == "severe"]
            rows, share, rel, abs_err = typed_agreement(torch, got, ref, typed)
            checks[label] = {"rows": rows, "share_off": share, "max_rel_err": rel}
            k1_err, k1_abs_err = max(k1_err, rel), max(k1_abs_err, abs_err)
            del got, ref
        emit({"phase": "breach_vs_twin", "graph": name, "n": N_NODES,
              "share_max": TYPED_SHARE_MAX, "rel_tolerance": REL_TOL, **checks})

        # The streamed estimates of severe and overruns, cuda against None
        # and against the exact law where there is one.
        p_severe, pmf = exact_breach_law(np, scipy, correlated)
        streamed = {}
        for label, node, opts in (("severe", nodes["severe"], {}),
                                  ("overruns", nodes["overruns"], {"histogram": (-0.5, 10.5, 11)})):
            cuda_exec.LAUNCHES = 0
            cuda_exec.STATS_LAUNCHES = 0
            st = {ex: node.estimate(N_TYPED_STREAM, random_state=5, executor=ex, **opts)
                  for ex in ("cuda", None)}
            launches += cuda_exec.LAUNCHES
            k2_launches += cuda_exec.STATS_LAUNCHES
            row = {"mean_cuda": st["cuda"]["mean"], "mean_plain": st[None]["mean"],
                   "diff_se": estimates_agree(np, st["cuda"], st[None], f"{name} {label}")}
            if p_severe is not None:
                for ex, s_ in st.items():
                    tag = "cuda" if ex else "plain"
                    if label == "severe":
                        z = abs(s_["mean"] - p_severe) / s_["sem"]
                        check(z <= SE_MAX, f"{name}: P(severe) {s_['mean']} vs {p_severe}")
                        row[f"exact_diff_se_{tag}"] = z
                    else:
                        h = s_["histogram"]
                        counts = h["counts"]
                        check(counts.sum() == N_TYPED_STREAM, f"{name}: overruns outside 0..10")
                        p = counts_fit(np, scipy.stats, counts.astype(np.float64), pmf)
                        check(p > FAMILY_P_MIN, f"{name}: overruns against its law, p = {p}")
                        row[f"chi2_p_{tag}"] = p
                row["exact"] = p_severe if label == "severe" else float(pmf @ np.arange(11))
            streamed[label] = row
        emit({"phase": "breach_streamed", "graph": name, "n": N_TYPED_STREAM, **streamed})
        records[name] = {**record, "checks_share_off": {k: v["share_off"] for k, v in checks.items()},
                         "streamed": streamed}

    # breach_count at 1e8, sink only: sample and K1 beside the bound.
    loss, nodes = breach_count()
    plan = _compile.get_plan(loss)
    tape = cuda_exec.lowered(plan, [loss._id], "cuda")
    k1_ms = cuda_time_ms(lambda: cuda_exec.run(tape, words, N_MAIN))
    sample_ms = cuda_time_ms(
        lambda: loss.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda"))
    twin_ms = cuda_time_ms(lambda: cuda_exec.run_reference(tape, words, N_NODES), repeats=1)
    plain_ms = cuda_time_ms(
        lambda: loss.sample(N_MAIN, random_state=0, gc_strategy=[], executor=None), repeats=1)
    cost = tape_cost(tape, cuda_exec, int_cost=int_cost)
    bound_ms, bound_by = bound(N_MAIN, 4 * N_MAIN, cost)
    timing = {"k1_ms": k1_ms, "sample_cuda_ms": sample_ms, "sample_plain_ms": plain_ms,
              "twin_ms_at_2^22": twin_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "int_instr_per_sample": cost[0], "flops_per_sample": cost[1],
              "rows": tape.n_instr, "registers_and_spill_bytes": registers.get("breach_count"),
              "int_op_sass": int_cost}
    emit({"phase": "breach_timing", "card": smi, "n": N_MAIN, **timing})
    records["breach_count"]["timing"] = timing

    # The sequential estimate of severe, as a user would run it.
    severe = nodes["severe"]
    seq = {}
    for ex in ("auto", None):
        cuda_exec.LAUNCHES = 0
        st, ms = wall_ms(torch, lambda: severe.estimate(
            1 << 24, random_state=6, target_rel_sem=2e-4, executor=ex))
        if ex == "auto":
            check(cuda_exec.LAUNCHES > 0, "the sequential estimate ran no K1")
            launches += cuda_exec.LAUNCHES
        seq["cuda" if ex else "plain"] = {"wall_ms": ms, "rounds": st["rounds"],
                                          "converged": st["converged"], "n": st["n"],
                                          "mean": st["mean"], "sem": st["sem"]}
        seq["cuda" if ex else "plain"]["stats"] = st
    seq["diff_se"] = estimates_agree(np, seq["cuda"].pop("stats"), seq["plain"].pop("stats"),
                                     "sequential severe")
    check(seq["cuda"]["converged"], "the sequential estimate of severe did not converge")
    emit({"phase": "breach_sequential", "card": smi, "target_rel_sem": 2e-4, **seq})
    records["sequential"] = seq

    # examples/03_portfolio_var.py's two calls on the port's portfolio.
    portfolio, _ = portfolio_var()
    path = here / "build" / "chip_smoke_portfolio.ckpt.npz"
    example = {}
    for label, call in (
        ("sequential", lambda ex: portfolio.estimate(
            1 << 16, block_size=1 << 22, random_state=1, target_rel_sem=0.005, moments=True,
            executor=ex)),
        ("checkpointed", lambda ex: streaming.estimate(
            portfolio, 1 << 24, block_size=1 << 22, random_state=4, checkpoint=str(path),
            checkpoint_every=1 << 23, executor=ex)),
    ):
        runs = {}
        for ex in ("auto", None):
            cuda_exec.LAUNCHES = 0
            cuda_exec.STATS_LAUNCHES = 0
            st, ms = wall_ms(torch, lambda: call(ex))
            if ex == "auto":
                check(cuda_exec.LAUNCHES > 0 and cuda_exec.STATS_LAUNCHES > 0,
                      f"examples/03 {label}: K1 or K2 was not launched")
                launches += cuda_exec.LAUNCHES
                k2_launches += cuda_exec.STATS_LAUNCHES
            runs["cuda" if ex else "plain"] = (st, ms)
        check(not path.exists(), "the checkpoint file outlived its run")
        row = {tag: {"wall_ms": ms, "mean": st["mean"], "sem": st["sem"], "n": st["n"],
                     "rounds": st.get("rounds"), "converged": st.get("converged")}
               for tag, (st, ms) in runs.items()}
        row["diff_se"] = estimates_agree(np, runs["cuda"][0], runs["plain"][0], f"examples/03 {label}")
        example[label] = row
    emit({"phase": "portfolio_example", "card": smi, **example})
    records["examples_03"] = example

    # A checkpointed estimate(1e9), interrupted after two segments and resumed.
    path = here / "build" / "chip_smoke_breach.ckpt.npz"
    path.unlink(missing_ok=True)
    opts = dict(random_state=8, quantiles=(0.5, 0.99), checkpoint=str(path),
                checkpoint_every=CHECKPOINT_EVERY)
    cuda_exec.LAUNCHES = 0
    full, full_ms = wall_ms(torch, lambda: loss.estimate(N_STREAM, **opts))

    class Interrupted(Exception):
        pass

    real, segments = streaming._estimate_carry, []

    def dying(*args, **kwargs):
        if len(segments) == 2:
            raise Interrupted
        segments.append(1)
        return real(*args, **kwargs)

    streaming._estimate_carry = dying
    try:
        loss.estimate(N_STREAM, **opts)
        interrupted = False
    except Interrupted:
        interrupted = True
    finally:
        streaming._estimate_carry = real
    check(interrupted and path.exists(), "the interrupted run left no checkpoint")
    resumed, resume_ms = wall_ms(torch, lambda: loss.estimate(N_STREAM, **opts))
    launches += cuda_exec.LAUNCHES
    keys = ("n", "mean", "var", "std", "sem", "min", "max", "q0.5", "q0.99")
    equal = all(resumed[k] == full[k] for k in keys)
    check(equal and not path.exists(), "the resumed estimate differs from the uninterrupted one")
    checkpointed = {"n": N_STREAM, "every": CHECKPOINT_EVERY, "segments_before_cut": 2,
                    "uninterrupted_ms": full_ms, "resumed_ms": resume_ms, "bitwise_equal": equal,
                    **{k: full[k] for k in keys}}
    emit({"phase": "breach_checkpointed", "card": smi, **checkpointed})
    records["checkpointed"] = checkpointed
    return {"k1_launches": launches, "k2_launches": k2_launches, "k1_err": k1_err,
            "k1_abs_err": k1_abs_err, "records": records}


def frank_tau(np, theta):
    """Kendall's tau of a Frank copula, 1 - 4/theta (1 - D_1(theta)) (odd in
    theta), by quadrature of the Debye function."""
    from scipy.integrate import quad

    a = abs(theta)
    d1 = quad(lambda t: t / np.expm1(t), 0.0, a)[0] / a
    return float(np.sign(theta) * (1.0 - 4.0 / a * (1.0 - d1)))


def copula_graphs(np, tau_np):
    """{label: (sink, uniform marginals, closed-form tau of the first two)}:
    every copula factory, each marginal shaped by a QuantileTransform and
    the shaped marginals summed."""
    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch.ops import copulas

    rho = copulas.rho_from_tau(0.5)
    corr = [[1.0, rho], [rho, 1.0]]
    rng = np.random.default_rng(2027)
    data = rng.normal(size=(2000, 1)) + rng.normal(size=(2000, 2)) * 0.5
    shapes = (("norm", (), {}), ("lognorm", (0.5,), {}), ("expon", (), {"scale": 2.0}))
    factories = {
        "clayton(2, d=3)": (lambda: pt.ClaytonCopula(2.0, d=3), 2.0 / 4.0),
        "gumbel(2)": (lambda: pt.GumbelCopula(2.0), 0.5),
        "frank(20)": (lambda: pt.FrankCopula(20.0), frank_tau(np, 20.0)),
        "frank(-5)": (lambda: pt.FrankCopula(-5.0), frank_tau(np, -5.0)),
        "gaussian": (lambda: pt.GaussianCopula(corr), 0.5),
        "t(df=4)": (lambda: pt.TCopula(corr, df=4.0), 0.5),
        "empirical": (lambda: pt.EmpiricalCopula(data), tau_np(data[:, 0], data[:, 1])),
    }
    graphs = {}
    for label, (build, tau) in factories.items():
        us = build()
        shaped = [pt.QuantileTransform(u, name, *args, **kwargs)
                  for u, (name, args, kwargs) in zip(us, shapes)]
        graphs[label] = (sum(shaped[1:], shaped[0]), us, tau)
    return graphs


def quantile_layer_path(torch, np, scipy, smi, here):
    """Phase 18: QMC and antithetic sampling through sample, sample_streaming
    and estimate, and the copula and multivariate nodes, on the plain path."""
    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import compile as _compile
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20
    from probabilit_tpu_torch.ops import multivariate, qmc

    t_phase = time.perf_counter()
    sink = mixed_dag_20()
    d = _compile.get_plan(sink).d_total

    def offset(m):
        return HALTON_OFFSET if m == "halton" else QMC_OFFSET

    def on(device, m):
        return qmc.generate(m, 11, 1 << 22, d, offset=offset(m), total=LHS_TOTAL, device=device)

    # The CPU's words for the card-against-CPU check below, computed on a
    # host thread while the card runs the timings.
    pool = ThreadPoolExecutor(1)
    host_words = pool.submit(lambda: {m: on("cpu", m) for m in QMC_METHODS})
    rows = {}
    for m in QMC_METHODS:
        out = sink.sample(N_MAIN, random_state=0, gc_strategy=[], method=m)
        check(out.device.type == "cuda", f"{m}: sink lies on {out.device}")
        check(tuple(out.shape) == (N_MAIN,), f"{m}: sink shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{m}: non-finite sink values")
        mean = out.double().mean().item()
        del out
        sample_ms = cuda_time_ms(
            lambda m=m: sink.sample(N_MAIN, random_state=0, gc_strategy=[], method=m), warm=False)
        generate_ms = cuda_time_ms(lambda m=m: qmc.generate(m, 0, N_MAIN, d, device="cuda"),
                                   repeats=3, warm=False)
        rows[m] = {"sample_ms": sample_ms, "generate_ms": generate_ms,
                   "samples_per_sec": N_MAIN / (sample_ms * 1e-3), "sink_mean": mean}
    emit({"phase": "qmc_sample_timing", "card": smi, "n": N_MAIN, "d": d, "methods": rows})

    # The integer code on the card against the CPU's.
    agree = {}
    host = host_words.result()
    pool.shutdown()
    for m in QMC_METHODS:
        diff = int((on("cuda", m).cpu() != host[m]).sum())
        check(diff == 0, f"generate({m}) on the card differs from the CPU in {diff} entries")
        agree[m] = {"offset": offset(m), "bitwise_equal": diff == 0}
    emit({"phase": "qmc_card_vs_cpu", "n": 1 << 22, "d": d, "methods": agree})

    streamed = {}
    for m in QMC_METHODS:
        one = sink.sample(N_QMC_STREAM, random_state=4, gc_strategy=[], method=m).cpu().numpy()
        blocks = streaming.sample_streaming(sink, N_QMC_STREAM, block_size=BLOCK,
                                            random_state=4, method=m)
        equal = bool(np.array_equal(one, blocks))
        check(equal, f"sample_streaming(method={m!r}) differs from sample()")
        streamed[m] = equal
    emit({"phase": "qmc_streamed_equals_single_shot", "n": N_QMC_STREAM, "block": BLOCK,
          "bitwise_equal": streamed})

    rqmc, rqmc_ms = wall_ms(torch, lambda: sink.estimate(
        N_QMC_ESTIMATE, block_size=BLOCK, random_state=5, method="sobol", replicates=8))
    iid = sink.estimate(N_QMC_ESTIMATE, block_size=BLOCK, random_state=5)
    z = estimates_agree(np, rqmc, iid, "estimate(method='sobol', replicates=8)")
    iid_sem = rqmc["std"] / np.sqrt(rqmc["n"])
    check(rqmc["sem"] < iid_sem, f"RQMC sem {rqmc['sem']} not below the iid sem {iid_sem}")
    _, sobol_1e9_ms = wall_ms(torch, lambda: sink.estimate(
        N_STREAM, block_size=BLOCK, random_state=6, method="sobol"))
    emit({"phase": "qmc_estimate", "card": smi, "n": N_QMC_ESTIMATE, "replicates": 8,
          "mean": rqmc["mean"], "between_replicate_sem": rqmc["sem"], "iid_sem": iid_sem,
          "prng_mean": iid["mean"], "z": z, "replicated_ms": rqmc_ms,
          "sobol_1e9_ms": sobol_1e9_ms, "sobol_1e9_block": BLOCK})

    path = here / "build" / "chip_smoke_lhs.ckpt.npz"
    path.unlink(missing_ok=True)
    opts = dict(block_size=BLOCK, random_state=9, method="lhs", quantiles=(0.5, 0.99),
                checkpoint=str(path), checkpoint_every=N_QMC_STREAM // 2)
    full = sink.estimate(N_QMC_STREAM, **opts)

    class Interrupted(Exception):
        pass

    real, segments = streaming._estimate_carry, []

    def dying(*args, **kwargs):
        if segments:
            raise Interrupted
        segments.append(1)
        return real(*args, **kwargs)

    streaming._estimate_carry = dying
    try:
        sink.estimate(N_QMC_STREAM, **opts)
        interrupted = False
    except Interrupted:
        interrupted = True
    finally:
        streaming._estimate_carry = real
    check(interrupted and path.exists(), "the interrupted LHS run left no checkpoint")
    resumed = sink.estimate(N_QMC_STREAM, **opts)
    keys = ("n", "mean", "var", "std", "sem", "min", "max", "q0.5", "q0.99")
    equal = all(resumed[k] == full[k] for k in keys)
    check(equal and not path.exists(), "the resumed LHS estimate differs from the uninterrupted one")
    emit({"phase": "qmc_checkpointed", "n": N_QMC_STREAM, "method": "lhs",
          "segments_before_cut": 1, "bitwise_equal": equal, "mean": full["mean"]})

    copulas = {}
    for label, (csink, us, tau) in copula_graphs(np, lambda a, b: scipy.stats.kendalltau(a, b)[0]).items():
        keep = list(us)
        x = csink.sample(N_COPULA, random_state=12, gc_strategy=keep)
        check(x.device.type == "cuda" and bool(torch.isfinite(x).all()), f"{label}: sink")
        u = [node.samples_ for node in us]
        got = float(scipy.stats.kendalltau(u[0][:N_TAU].cpu().numpy(), u[1][:N_TAU].cpu().numpy())[0])
        check(abs(got - tau) <= TAU_TOL, f"{label}: Kendall tau {got} vs {tau}")
        ks = [float(scipy.stats.kstest(v[:N_UNIFORM_KS].double().cpu().numpy(), "uniform").pvalue)
              for v in u]
        check(min(ks) > FAMILY_P_MIN, f"{label}: a marginal fails KS against U(0, 1): {ks}")
        refused = False
        try:
            csink.sample(1000, random_state=0, gc_strategy=[], executor="cuda")
        except ValueError:
            refused = True
        check(refused, f"executor='cuda' accepted the {label} graph")
        call_ms = cuda_time_ms(lambda csink=csink: csink.sample(N_COPULA, random_state=12,
                                                                gc_strategy=[]))
        column = torch.rand(N_COPULA, device="cuda")
        key_ms = cuda_time_ms(lambda column=column: multivariate._key_from_q(column))
        copulas[label] = {"kendall_tau": got, "closed_form_tau": tau, "ks_p": ks, "ms": call_ms,
                          "key_host_read_ms": key_ms, "host_read_share": key_ms / call_ms}
        del x, u
    emit({"phase": "copulas", "card": smi, "n": N_COPULA, "tau_n": N_TAU,
          "ks_n": N_UNIFORM_KS, "graphs": copulas})

    multi = {}
    for name, kwargs, means in (
        ("dirichlet", {"alpha": [1.0, 2.0, 3.0]}, [1 / 6, 2 / 6, 3 / 6]),
        ("multinomial", {"n": 10, "p": [0.1, 0.2, 0.7]}, [1.0, 2.0, 7.0]),
    ):
        parts = list(pt.MultivariateDistribution(name, **kwargs))
        msink = sum(parts[1:], parts[0])
        msink.sample(N_COPULA, random_state=13, gc_strategy=parts)
        zs = []
        for part, mu in zip(parts, means):
            v = part.samples_.double()
            zs.append(abs(v.mean().item() - mu) / (v.std().item() / np.sqrt(N_COPULA)))
        check(max(zs) <= SE_MAX, f"{name}: marginal means off by {zs} standard errors")
        refused = False
        try:
            msink.sample(1000, random_state=0, gc_strategy=[], executor="cuda")
        except ValueError:
            refused = True
        check(refused, f"executor='cuda' accepted the {name} graph")
        multi[name] = {"z": zs, "ms": cuda_time_ms(lambda msink=msink: msink.sample(
            N_COPULA, random_state=13, gc_strategy=[]))}
    for m in QMC_METHODS:
        refused = False
        try:
            sink.sample(1000, random_state=0, gc_strategy=[], method=m, executor="cuda")
        except ValueError:
            refused = True
        check(refused, f"executor='cuda' accepted method={m!r}")
    check(config.device().type == "cuda", "the phase left the card")
    emit({"phase": "multivariate", "card": smi, "n": N_COPULA, "graphs": multi,
          "phase_seconds": time.perf_counter() - t_phase})



def same_result(np, a, b):
    """Two estimate_many results equal key by key (arrays elementwise)."""
    for node in a:
        if a[node].keys() != b[node].keys():
            return False
        for key, value in a[node].items():
            other = b[node][key]
            if isinstance(value, dict):
                if not all(np.array_equal(value[k], other[k]) for k in value):
                    return False
            elif isinstance(value, np.ndarray):
                if not np.array_equal(value, other):
                    return False
            elif value != other:
                return False
    return True


def median_wall(torch, fn, repeats=3):
    """(first result, median host-clock ms) of ``repeats`` calls."""
    runs = [wall_ms(torch, fn) for _ in range(repeats)]
    return runs[0][0], statistics.median(ms for _, ms in runs)


def estimate_many_path(torch, np, cuda_exec, _compile, smi, here):
    """Phase 19: estimate_many (joint streamed estimates of several nodes)
    and scalar_transform on the card."""
    import warnings

    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models import graph as tg
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20, portfolio_model

    t_phase = time.perf_counter()
    k1 = k2 = 0
    sink = mixed_dag_20()
    nodes = joint_nodes(_compile.get_plan(sink))
    labels = [f"{type(node).__name__}#{k}" for k, node in enumerate(nodes)]
    opts = dict(block_size=BLOCK, quantiles=MANY_QUANTILES, cvar=MANY_CVAR,
                histogram=MANY_HISTOGRAM, moments=True)

    # mixed_dag_20 jointly: no kernel launch (the NoOp sink), beside the
    # separate estimates a user would otherwise run (K1 each).
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    joint, joint_ms = median_wall(torch, lambda: streaming.estimate_many(
        nodes, N_STREAM, random_state=19, covariance=True, **opts))
    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          "estimate_many launched a kernel: the NoOp sink must run the plain executor")
    carry = streaming._many_carry(nodes, BLOCK, BLOCK, 5, "auto", covariance=True)
    on_card = all(v.device.type == "cuda" for v in carry)
    check(on_card, "estimate_many's carries left the card")
    del carry
    cuda_exec.LAUNCHES = 0
    separate, separate_ms = median_wall(torch, lambda: [
        node.estimate(N_STREAM, random_state=20 + k, **opts) for k, node in enumerate(nodes)])
    check(cuda_exec.LAUNCHES > 0, "the separate estimates launched no K1")
    k1 += cuda_exec.LAUNCHES
    rows = {}
    for label, node, one in zip(labels, nodes, separate):
        st = joint[node]
        h = st["histogram"]
        counted = int(h["counts"].sum()) + h["underflow"] + h["overflow"]
        check(counted == N_STREAM, f"{label}: the histogram counts {counted}, not n")
        rows[label] = {"mean": st["mean"], "sem": st["sem"], "separate_mean": one["mean"],
                       "z": estimates_agree(np, st, one, f"estimate_many {label}"),
                       "q0.5": st["q0.5"], "cvar0.99": st["cvar0.99"], "skew": st["skew"]}
    cov = np.stack([joint[node]["cov"] for node in nodes])
    corr = np.stack([joint[node]["corr"] for node in nodes])
    check(np.allclose(cov, cov.T, rtol=1e-12, atol=0), "cov is not symmetric")
    check(np.array_equal(np.diag(corr), np.ones(len(nodes))), "corr's diagonal is not 1")
    emit({"phase": "estimate_many_mixed_dag_20", "card": smi, "n": N_STREAM, "block": BLOCK,
          "nodes": labels, "k1_launches_of_estimate_many": 0, "carries_on_card": on_card,
          "estimate_many_ms": joint_ms, "separate_estimates_ms": separate_ms,
          "separate_over_joint": separate_ms / joint_ms, "corr": corr.tolist(), "per_node": rows})

    # Exactness against one shot: the streamed Sobol blocks are the rows of
    # the one-shot sequence.
    exact = streaming.estimate_many(nodes, N_MANY_EXACT, block_size=BLOCK, random_state=21,
                                    method="sobol", histogram=MANY_HISTOGRAM, covariance=True)
    tg.NoOp(*nodes).sample(N_MANY_EXACT, random_state=21, method="sobol", gc_strategy=nodes)
    X = torch.stack([node.samples_.to(torch.float32) for node in nodes])
    for node in nodes:
        del node.samples_
    Xd = X.double()
    mean = Xd.mean(dim=1)
    D = Xd - mean[:, None]
    var = (D * D).mean(dim=1)
    cov_one = (D @ D.T / N_MANY_EXACT).cpu().numpy()
    del D, Xd
    counts = streaming._histogram_accumulators_many(MANY_HISTOGRAM)(X).cpu().numpy()
    worst = 0.0
    for i, (label, node) in enumerate(zip(labels, nodes)):
        st = exact[node]
        h = st["histogram"]
        check(st["n"] == N_MANY_EXACT, f"{label}: n {st['n']}")
        check(st["min"] == X[i].min().item() and st["max"] == X[i].max().item(),
              f"{label}: min/max differ from the one-shot draws'")
        for got, want in ((st["mean"], mean[i].item()), (st["var"], var[i].item()),
                          *zip(st["cov"], cov_one[i])):
            rel = abs(got - want) / max(abs(want), 1e-300)
            worst = max(worst, rel)
            check(rel <= MANY_EXACT_TOL, f"{label}: {got} vs one-shot {want} ({rel:.3g} rel)")
        check(np.array_equal(np.concatenate([[h["underflow"]], h["counts"], [h["overflow"]]]),
                             counts[i]), f"{label}: histogram counts differ from the bin rule")
    del X
    emit({"phase": "estimate_many_equals_one_shot", "n": N_MANY_EXACT, "block": BLOCK,
          "method": "sobol", "max_rel_err": worst, "rel_tolerance": MANY_EXACT_TOL,
          "min_max_histograms_equal": True})

    # The portfolio's desks and total: recoloured per block on the plain path.
    total = portfolio_model(d=10)
    pplan = _compile.get_plan(total)
    assets = list(pplan.corr_vars)
    pnodes = [*assets, total]
    popts = dict(block_size=BLOCK, quantiles=PORTFOLIO_QUANTILES, cvar=(0.99,))
    _, probe_ms = wall_ms(torch, lambda: streaming.estimate_many(
        pnodes, 1 << 26, random_state=22, covariance=True, **popts))
    forecast_s = probe_ms * 1e-3 * N_STREAM / (1 << 26)
    n_port = N_STREAM if forecast_s < PORTFOLIO_SECONDS_MAX else N_PORTFOLIO_SMALL
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    port, port_ms = median_wall(torch, lambda: streaming.estimate_many(
        pnodes, n_port, random_state=23, covariance=True, **popts))
    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          "estimate_many launched a kernel on the portfolio")
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    pseparate, pseparate_ms = median_wall(torch, lambda: [
        node.estimate(n_port, random_state=30 + k, **popts) for k, node in enumerate(pnodes)])
    check(cuda_exec.LAUNCHES > 0 and cuda_exec.STATS_LAUNCHES > 0,
          "the portfolio's separate estimates launched no K1 or no K2")
    k1 += cuda_exec.LAUNCHES
    k2 += cuda_exec.STATS_LAUNCHES
    pcov = np.stack([port[node]["cov"] for node in pnodes])
    pcorr = np.stack([port[node]["corr"] for node in pnodes])
    a = len(assets)
    sum_means = sum(port[node]["mean"] for node in assets)
    mean_rel = abs(port[total]["mean"] - sum_means) / abs(sum_means)
    block_sum = float(pcov[:a, :a].sum())
    var_rel = abs(port[total]["var"] - block_sum) / block_sum
    check(mean_rel <= PORTFOLIO_MEAN_TOL, f"portfolio: total mean off the assets' by {mean_rel}")
    check(var_rel <= PORTFOLIO_VAR_TOL, f"portfolio: total var off the cov block by {var_rel}")
    # The drivers' normal scores carry the repaired target rho exactly per
    # block; lognormal values of shape s correlate at (e^{s^2 rho} - 1) /
    # (e^{s^2} - 1).
    target = np.asarray(pplan.corr_matrix)
    s2 = PORTFOLIO_S**2
    expected = np.expm1(s2 * target) / np.expm1(s2)
    corr_err = float(np.abs(pcorr[:a, :a] - expected).max())
    check(corr_err <= CORR_TOL, f"portfolio: asset correlations off by {corr_err}")
    for k, (node, one) in enumerate(zip(pnodes, pseparate)):
        estimates_agree(np, port[node], one, f"portfolio node {k}")
    emit({"phase": "estimate_many_portfolio", "card": smi, "n": n_port, "block": BLOCK,
          "forecast_1e9_s": forecast_s, "assets": a, "total_mean_rel_err": mean_rel,
          "total_var_rel_err": var_rel, "max_corr_err": corr_err, "corr_tolerance": CORR_TOL,
          "target_rho": float(target[0, 1]), "lognormal_image": float(expected[0, 1]),
          "mean_asset_corr": float(pcorr[:a, :a][~np.eye(a, dtype=bool)].mean()),
          "estimate_many_ms": port_ms, "separate_estimates_ms": pseparate_ms,
          "separate_over_joint": pseparate_ms / port_ms,
          "one_block_floats_sorted": (a + 1) * BLOCK, "k1_launches": cuda_exec.LAUNCHES,
          "k2_launches": cuda_exec.STATS_LAUNCHES})

    # Sequential to a relative target, and checkpointed.
    seq, seq_ms = wall_ms(torch, lambda: streaming.estimate_many(
        nodes, BLOCK, block_size=BLOCK, random_state=24, target_rel_sem=MANY_REL_SEM))
    for label, node in zip(labels, nodes):
        st = seq[node]
        check(st["converged"] and st["sem"] <= MANY_REL_SEM * abs(st["mean"]),
              f"sequential: {label} did not meet target_rel_sem")
    first = seq[nodes[0]]
    emit({"phase": "estimate_many_sequential", "card": smi, "target_rel_sem": MANY_REL_SEM,
          "rounds": first["rounds"], "n": first["n"], "wall_ms": seq_ms,
          "rel_sem": {label: seq[node]["sem"] / abs(seq[node]["mean"])
                      for label, node in zip(labels, nodes)}})

    path = here / "build" / "chip_smoke_many.ckpt.npz"
    path.unlink(missing_ok=True)
    copts = dict(block_size=BLOCK, random_state=25, quantiles=(0.5, 0.99), moments=True,
                 covariance=True, checkpoint=str(path), checkpoint_every=CHECKPOINT_EVERY)
    full, full_ms = wall_ms(torch, lambda: streaming.estimate_many(nodes, N_STREAM, **copts))

    class Interrupted(Exception):
        pass

    real, segments = streaming._many_carry, []

    def dying(*args, **kwargs):
        if len(segments) == 2:
            raise Interrupted
        segments.append(1)
        return real(*args, **kwargs)

    streaming._many_carry = dying
    try:
        streaming.estimate_many(nodes, N_STREAM, **copts)
        interrupted = False
    except Interrupted:
        interrupted = True
    finally:
        streaming._many_carry = real
    check(interrupted and path.exists(), "the interrupted estimate_many left no checkpoint")
    resumed, resume_ms = wall_ms(torch, lambda: streaming.estimate_many(nodes, N_STREAM, **copts))
    equal = same_result(np, resumed, full)
    check(equal and not path.exists(), "the resumed estimate_many differs from the uninterrupted one")
    emit({"phase": "estimate_many_checkpointed", "card": smi, "n": N_STREAM,
          "every": CHECKPOINT_EVERY, "segments_before_cut": 2, "uninterrupted_ms": full_ms,
          "resumed_ms": resume_ms, "equal_key_by_key": equal})

    # Refusals, and scalar_transform on the card.
    x, y = nodes[-2], nodes[-4]
    f = tg.scalar_transform(lambda u, v: u * v + 1)
    refused = []
    for label, call in (
        ("estimate_many", lambda: streaming.estimate_many(nodes, 1 << 20, block_size=1 << 20,
                                                          executor="cuda")),
        ("scalar_transform", lambda: f(x, y).sample(1 << 20, random_state=0, gc_strategy=[],
                                                    executor="cuda")),
    ):
        try:
            call()
        except ValueError:
            refused.append(label)
    check(len(refused) == 2, f"executor='cuda' accepted {set(('estimate_many', 'scalar_transform')) - set(refused)}")
    vmapped, vmapped_ms = median_wall(torch, lambda: f(x, y).sample(
        N_SCALAR, random_state=26, gc_strategy=[]))
    ops = (x * y + 1).sample(N_SCALAR, random_state=26, gc_strategy=[])
    ulp_err = ((vmapped - ops).abs() / torch.finfo(torch.float32).eps
               / ops.abs().clamp_min(torch.finfo(torch.float32).tiny)).max().item()
    check(vmapped.device.type == "cuda" and ulp_err <= 1.0,
          f"scalar_transform: {ulp_err} ulps from the operators' graph")
    del vmapped, ops

    @tg.scalar_transform
    def positive_part(u):
        if u > 0:
            return u
        return 0.0

    shifted = x - 1.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        host, host_ms = median_wall(torch, lambda: positive_part(shifted).sample(
            N_HOST_LOOP, random_state=27, gc_strategy=[]))
    warned = any("per-sample host loop" in str(w.message) for w in caught)
    check(warned and host.device.type == "cuda" and bool((host >= 0).all()),
          "the untraceable scalar_transform did not warn or left its result off the card")
    check(config.device().type == "cuda", f"the device moved to {config.device()}")
    emit({"phase": "scalar_transform", "card": smi, "refused_by_cuda": refused,
          "n_vmapped": N_SCALAR, "vmapped_ms": vmapped_ms,
          "vmapped_samples_per_s": N_SCALAR / (vmapped_ms * 1e-3), "max_ulp_err": ulp_err,
          "n_host_loop": N_HOST_LOOP, "host_loop_ms": host_ms,
          "host_loop_samples_per_s": N_HOST_LOOP / (host_ms * 1e-3), "host_loop_warned": warned,
          "phase_s": time.perf_counter() - t_phase})
    return {"k1_launches": k1, "k2_launches": k2}


def path_uniforms(np, n, d, seed, newton):
    """Float32-exact uniforms in (0, 1); in NEWTON_CENTRAL for a Newton ppf."""
    q = np.random.default_rng(seed).integers(1, 2**23, (n, d)) / 2**23
    if newton:
        lo, hi = NEWTON_CENTRAL
        q = lo + (hi - lo) * q
    return q


def within_se(np, x, mean, var, label):
    """(z of the mean, z of the variance or None): each within SE_MAX."""
    x = x.double()
    n = x.numel()
    m, v = x.mean().item(), x.var(correction=0).item()
    z_mean = (m - mean) / (v / n) ** 0.5
    check(abs(z_mean) <= SE_MAX, f"{label}: mean {m} vs {mean} ({z_mean:.2f} SE)")
    z_var = None
    if var is not None:
        m4 = ((x - m) ** 4).mean().item()
        z_var = (v - var) / ((m4 - v * v) / n) ** 0.5
        check(abs(z_var) <= SE_MAX, f"{label}: var {v} vs {var} ({z_var:.2f} SE)")
    return z_mean, z_var


def profiled_call(torch, fn):
    """One call of ``fn`` under torch.profiler: its wall ms, device ms,
    kernel launches, idle share, and the three kernels that take the most
    device time."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        _, profiled = wall_ms(torch, fn)
    busy = launches = 0.0
    top = {}
    for event in prof.key_averages():
        us = getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
        if us and event.device_type == torch.autograd.DeviceType.CUDA:
            busy += us / 1e3
            launches += event.count
            top[event.key[:60]] = us / 1e3
    return {"profiled_ms": profiled, "device_ms": busy, "kernel_launches": int(launches),
            "idle_share": 1.0 - busy / profiled,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:3])}


def profile_block(torch, fn):
    """A warm call, a timed one, then one under torch.profiler
    (``profiled_call``)."""
    fn()
    _, wall = wall_ms(torch, fn)
    return {"wall_ms": wall, **profiled_call(torch, fn)}


def batch_order(torch, np):
    """Whether a row of each time-axis op gets the same bits in a 2^18-row
    call as in its 2^16-row blocks (252 steps), and each op's ms a block
    (CUDA events): ``torch.cumsum`` along the last axis (reported: the
    library's), ``processes.time_cumsum`` and the bridge's product (both
    checked by the caller: streamed ``method=`` runs rely on them)."""
    from probabilit_tpu_torch.models.processes import time_cumsum
    from probabilit_tpu_torch.ops import bridge

    gen = torch.Generator(device="cuda").manual_seed(70)
    z = torch.randn((N_PATH_STREAM, 252), generator=gen, device="cuda")
    u = torch.special.ndtr(z)
    ops = {
        "cumsum_last_axis": lambda x: torch.cumsum(x, dim=1),
        "time_cumsum": time_cumsum,
        "bridge_product": lambda x: bridge.normal_increments(x, torch.float32),
    }
    out = {}
    for name, op in ops.items():
        x = u if name == "bridge_product" else z
        whole = op(x)
        blocks = torch.cat([op(x[i : i + PATHS_BLOCK]) for i in range(0, len(x), PATHS_BLOCK)])
        out[f"{name}_bitwise"] = bool(torch.equal(whole, blocks))
        out[f"{name}_differing_entries"] = int((whole != blocks).sum().item())
        out[f"{name}_ms_a_block"] = cuda_time_ms(lambda: op(x[:PATHS_BLOCK]))
    return out


def path_processes_path(torch, np, scipy, cuda_exec, _compile, smi):
    """Phase 20: the path processes on the card, through the plain executor."""
    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models.benchmarks import merton_book, path_families

    t_phase = time.perf_counter()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0

    # (a) bench.py::bench_paths, and examples/06's checks at its size.
    gbm = pt.GeometricBrownianMotion(s0=100, mu=0.03, sigma=0.2, T=1.0, steps=252)
    disc = float(np.exp(-0.03))
    call = gbm.terminal() - 100.0
    vanilla = (call > 0) * call * disc
    barrier = (gbm.maximum() < 130) * ((gbm.terminal() - 100) > 0) * (gbm.terminal() - 100) * disc

    def bench(seed):
        return streaming.estimate(barrier, N_PATHS, block_size=PATHS_BLOCK, random_state=seed,
                                  executor="auto")

    bench(0)
    priced, bench_ms = median_wall(torch, lambda: bench(1))
    d1 = (0.03 + 0.02) / 0.2
    black_scholes = 100 * scipy.stats.norm.cdf(d1) - 100 * disc * scipy.stats.norm.cdf(d1 - 0.2)
    opts = dict(block_size=PATHS_BLOCK, executor="auto")
    terminal = streaming.estimate(gbm.terminal(), N_PATHS, random_state=2, **opts)
    z_terminal = (terminal["mean"] - 100 * np.exp(0.03)) / terminal["sem"]
    check(abs(z_terminal) <= SE_MAX, f"gbm terminal {terminal['mean']} ({z_terminal:.2f} SE)")
    plain_call = streaming.estimate(vanilla, N_PATHS, random_state=3, **opts)
    z_call = (plain_call["mean"] - black_scholes) / plain_call["sem"]
    check(abs(z_call) <= SE_MAX, f"vanilla {plain_call['mean']} vs {black_scholes} ({z_call:.2f} SE)")
    ac = gbm.average() - 100.0
    asian = (ac > 0) * ac * disc
    a_plain = streaming.estimate(asian, N_PATHS, random_state=4, **opts)
    a_cv = streaming.estimate(asian, N_PATHS, random_state=4, control=(vanilla, black_scholes),
                              **opts)
    check(a_cv["sem"] < a_plain["sem"], f"the control did not tighten: {a_cv['sem']} >= {a_plain['sem']}")
    emit({"phase": "paths_bench", "card": smi, "n": N_PATHS, "steps": 252, "block": PATHS_BLOCK,
          "barrier_price": priced["mean"], "barrier_sem": priced["sem"], "wall_ms": bench_ms,
          "g_path_elements_per_s": N_PATHS * 252 / (bench_ms * 1e-3) / 1e9,
          "terminal_z": z_terminal, "vanilla": plain_call["mean"], "black_scholes": black_scholes,
          "vanilla_z": z_call, "asian_sem": a_plain["sem"], "asian_control_sem": a_cv["sem"],
          "control_rho": a_cv.get("control_rho")})

    # (b) examples/09's book: estimate_many under Sobol with replicates.
    views, prices = merton_book(steps=64)
    loss = [100.0 - v.terminal() for v in views]
    total = sum(loss)
    width = views[0].joint._q_width
    check(width == 3 * 3 * 64 + 2 * 64, f"the book's slab is {width} columns")

    def book():
        return streaming.estimate_many(loss + [total], N_BOOK, block_size=BOOK_BLOCK,
                                       quantiles=(0.99,), cvar=(0.99,), method="sobol",
                                       replicates=8, random_state=0)

    book()
    res, book_ms = wall_ms(torch, book)
    desks = {}
    for i, node in enumerate(loss):
        st = res[node]
        z = (st["mean"] - (100.0 - prices[i])) / st["sem"]
        check(abs(z) <= SE_MAX, f"desk {i}: mean loss {st['mean']} vs {100.0 - prices[i]}")
        desks[f"desk_{i}"] = {"mean_loss": st["mean"], "sem": st["sem"], "z": z,
                              "var99": st["q0.99"], "cvar99": st["cvar0.99"]}
    desk_sum = sum(res[node]["mean"] for node in loss)
    total_rel = abs(res[total]["mean"] - desk_sum) / abs(desk_sum)
    check(total_rel <= BOOK_TOTAL_TOL, f"the book's total is off its desks' sum by {total_rel}")
    emit({"phase": "paths_book", "card": smi, "n": N_BOOK, "block": BOOK_BLOCK, "steps": 64,
          "slab_columns": width, "quantile_bytes_a_block": BOOK_BLOCK * (width + 3) * 4,
          "wall_ms": book_ms, "desks": desks, "total_mean_loss": res[total]["mean"],
          "total_var99": res[total]["q0.99"], "total_rel_err": total_rel})

    # (c) each factory one-shot at 252 steps, and one slab on card and CPU.
    families = path_families(steps=252)
    records = {}
    for k, (name, fam) in enumerate(families.items()):
        n = N_FAMILY_PATHS_SMALL if name in SMALL_PATH_FAMILIES else N_FAMILY_PATHS
        term = fam.surface.terminal()
        term.sample(1 << 10, random_state=0, gc_strategy=[])  # first-call costs (torch.func)
        x, ms = wall_ms(torch, lambda: term.sample(n, random_state=40 + k, gc_strategy=[]))
        check(x.device.type == "cuda" and tuple(x.shape) == (n,), f"{name}: {x.device}, {x.shape}")
        z_mean, z_var = within_se(np, x, fam.mean, fam.var, name)
        node = getattr(fam.surface, "joint", fam.surface)
        q = path_uniforms(np, N_PATH_SLAB, _compile.get_plan(node).d_total, k, fam.newton)
        on_card = node.sample_from_quantiles(q).cpu().double()
        config.set_device("cpu")
        try:
            on_cpu = node.sample_from_quantiles(q).double()
        finally:
            config.set_device("cuda")
        rows = on_cpu.reshape(N_PATH_SLAB, -1)
        scale = rows.abs().amax(dim=1).clamp_min(1e-30)
        rel = ((on_card.reshape(N_PATH_SLAB, -1) - rows).abs().amax(dim=1) / scale).max().item()
        check(rel <= PATH_TOL, f"{name}: card vs CPU on one slab {rel}")
        del node.samples_
        records[name] = {"n": n, "ms": ms, "paths_per_s": n / (ms * 1e-3), "z_mean": z_mean,
                         "z_var": z_var, "slab_columns": q.shape[1], "card_vs_cpu_rel": rel}
    emit({"phase": "paths_families", "card": smi, "steps": 252, "rel_tolerance": PATH_TOL,
          "families": records})

    # (d) the time-axis ops a row must get the same bits from whatever
    # its batch (2^18 rows against 2^16-row blocks), then streamed Sobol
    # runs against one shot, bitwise.
    scan_order = batch_order(torch, np)
    check(scan_order["time_cumsum_bitwise"] and scan_order["bridge_product_bitwise"],
          f"a path op's rows depend on the batch: {scan_order}")
    streamed = {}
    for label, t in (("gbm_terminal", gbm.terminal()),
                     ("merton_average", families["merton"].surface.average())):
        full = t.sample(N_PATH_STREAM, random_state=50, method="sobol").cpu().numpy()
        blocks = streaming.sample_streaming(t, N_PATH_STREAM, block_size=PATHS_BLOCK,
                                            random_state=50, method="sobol")
        check(np.array_equal(full, blocks), f"{label}: streamed Sobol differs from one shot")
        streamed[label] = True

    # (e) no kernel, and the kernel path refuses a path graph.
    refused = False
    try:
        barrier.sample(1 << 10, random_state=0, gc_strategy=[], executor="cuda")
    except ValueError:
        refused = True
    check(refused, "executor='cuda' accepted a path graph")

    # (f) where a block's time goes: one 2^16-path block, key mode.
    profiles = {}
    for k, name in enumerate(PROFILED_PATHS):
        term = families[name].surface.terminal()
        profiles[name] = profile_block(
            torch, lambda: term.sample(PATHS_BLOCK, random_state=60 + k, gc_strategy=[]))
    profiles["book"] = profile_block(torch, lambda: streaming.estimate_many(
        loss + [total], BOOK_BLOCK, block_size=BOOK_BLOCK, quantiles=(0.99,), cvar=(0.99,),
        method="sobol", random_state=61))
    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          f"the path phase launched K1 {cuda_exec.LAUNCHES} and K2 {cuda_exec.STATS_LAUNCHES} times")
    emit({"phase": "paths_profile", "card": smi, "block": PATHS_BLOCK, "steps": 252,
          "batch_order": scan_order, "streamed_equals_one_shot": streamed, "cuda_refused": refused,
          "k1_launches": cuda_exec.LAUNCHES, "k2_launches": cuda_exec.STATS_LAUNCHES,
          "blocks": profiles, "phase_s": time.perf_counter() - t_phase})


def sensitivity_path(torch, np, cuda_exec, _compile, smi, here):
    """Phase 21: pathwise gradients and Sobol' indices on the card, through
    the plain executor (no kernel has a backward)."""
    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import sensitivity as sens
    from probabilit_tpu_torch.engine import streaming
    from probabilit_tpu_torch.models.benchmarks import mixed_dag_20

    t_phase = time.perf_counter()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    sink = mixed_dag_20()
    plan = _compile.get_plan(sink)
    pairs = [(node, slot) for node in plan.isns for slot in sens._numeric_slots(node)]
    check(len(pairs) == 16, f"mixed_dag_20 has {len(pairs)} numeric slots")
    wrt = list(plan.isns)

    def peak_mb(fn):
        """(result, wall ms, the MB the call itself held at its peak: over
        what the earlier phases leave allocated)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, ms = wall_ms(torch, fn)
        return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**20

    resident_mb = torch.cuda.memory_allocated() / 2**20

    # (a) One shot at 2^24, then the card against the CPU and against
    # float64 central differences on one 2^20 quantile matrix.
    def one_shot():
        return pt.sensitivity(sink, wrt=wrt, size=N_SENS, random_state=21)

    one_shot()
    res, shot_ms, shot_mb = peak_mb(one_shot)
    profile = profile_block(torch, one_shot)
    q = np.random.default_rng(21).integers(1, 2**23, (N_SENS_CHECK, plan.d)) / 2**23
    theta = [float(sens._read_slot(n, s)) for n, s in pairs]
    fn = sens._build_grad_fn(plan, pairs, torch.mean, _compile.resolve_correlator("imanconover"),
                             drawn=False)

    def grads_on(device):
        qt = torch.as_tensor(q, dtype=torch.float32, device=device)
        value, grad = fn(torch.tensor(theta, dtype=torch.float32, device=device), qt)
        return float(value), grad.cpu().double().numpy()

    card_value, card_grad = grads_on("cuda")
    config.set_device("cpu")
    try:
        cpu_value, cpu_grad = grads_on("cpu")
    finally:
        config.set_device("cuda")
    cpu_err = np.abs(card_grad - cpu_grad) / np.maximum(1.0, np.abs(cpu_grad))
    check(float(cpu_err.max()) <= SENS_TOL, f"gradient card vs CPU {cpu_err.max()}")
    fd = np.zeros(len(pairs))
    config.set_dtype(torch.float64)
    try:
        for k, (node, slot) in enumerate(pairs):
            h = SENS_FD_STEP * max(1.0, abs(theta[k]))
            side = []
            for sign in (1.0, -1.0):
                sens._write_slot(node, slot, theta[k] + sign * h)
                try:
                    side.append(float(sink.sample_from_quantiles(q, gc_strategy=[]).mean()))
                finally:
                    sens._write_slot(node, slot, theta[k])
            fd[k] = (side[0] - side[1]) / (2.0 * h)
    finally:
        config.set_dtype(torch.float32)
    fd_err = np.abs(card_grad - fd) / np.maximum(1.0, np.abs(fd))
    check(float(fd_err.max()) <= SENS_FD_TOL, f"gradient vs central differences {fd_err.max()}")
    labels = [f"{type(n).__name__}#{plan.col_of[n._id]}.{s}" for n, s in pairs]
    emit({"phase": "sensitivity_one_shot", "card": smi, "n": N_SENS, "slots": len(pairs),
          "value": res.value, "wall_ms": shot_ms, "peak_mb": shot_mb,
          "resident_mb_before_phase": resident_mb, **profile,
          "check_n": N_SENS_CHECK, "card_vs_cpu_max_rel": float(cpu_err.max()),
          "card_vs_cpu_value": card_value - cpu_value, "central_differences_max_rel":
          float(fd_err.max()), "tolerances": {"card_vs_cpu": SENS_TOL, "central": SENS_FD_TOL},
          "gradients": dict(zip(labels, card_grad.tolist())), "central": dict(zip(labels, fd))})

    # A one-shot quantile past torch.quantile's limit, and the Sobol
    # sequence streamed against one shot (the order of float32 sums).
    big, big_ms, big_mb = peak_mb(lambda: pt.sensitivity(
        sink, wrt=wrt, size=N_SENS_QUANTILE, statistic="q0.95", random_state=25))
    check(np.isfinite(big.value) and all(np.isfinite(list(big.gradients.values()))),
          f"one-shot q0.95 at {N_SENS_QUANTILE}: {big}")
    qmc = dict(wrt=wrt, size=N_SENS_CHECK, method="sobol", random_state=26)
    whole = pt.sensitivity(sink, **qmc)
    blocks = pt.sensitivity(sink, block_size=SENS_SOBOL_BLOCK, **qmc)
    sobol_rel = max(abs(blocks[p] - whole[p]) / max(1.0, abs(whole[p])) for p in pairs)
    sobol_value_rel = abs(blocks.value - whole.value) / abs(whole.value)
    check(max(sobol_rel, sobol_value_rel) <= SENS_SOBOL_TOL,
          f"streamed Sobol gradients vs one shot: {sobol_rel}, value {sobol_value_rel}")
    emit({"phase": "sensitivity_quantile_and_sobol_stream", "card": smi,
          "quantile_n": N_SENS_QUANTILE, "quantile_value": big.value, "quantile_wall_ms": big_ms,
          "quantile_peak_mb": big_mb, "sobol_n": N_SENS_CHECK, "sobol_block": SENS_SOBOL_BLOCK,
          "sobol_stream_max_rel": sobol_rel, "sobol_stream_value_rel": sobol_value_rel,
          "tolerance": SENS_SOBOL_TOL})

    # (b) Streamed at 2^28 in blocks of 2^24: the mean against the
    # estimate of the same blocks, cvar0.95, and a checkpoint cut and
    # resumed.
    opts = dict(wrt=wrt, size=N_SENS_STREAM, block_size=N_SENS, random_state=22)
    mean, mean_ms, mean_mb = peak_mb(lambda: pt.sensitivity(sink, **opts))
    est = streaming.estimate(sink, N_SENS_STREAM, block_size=N_SENS, random_state=22,
                             executor=None)
    value_rel = abs(mean.value - est["mean"]) / abs(est["mean"])
    check(value_rel <= SENS_VALUE_TOL, f"streamed value vs estimate {value_rel}")
    tail, tail_ms, tail_mb = peak_mb(lambda: pt.sensitivity(sink, statistic="cvar0.95", **opts))
    check(max(mean_mb, tail_mb) <= 2.0 * shot_mb,
          f"streamed peak {max(mean_mb, tail_mb)} MB against one block's {shot_mb}")
    path = here / "build" / "chip_phase21_checkpoint.npz"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    ck = dict(opts, checkpoint=str(path), checkpoint_every=SENS_CHECKPOINT_EVERY)
    full = pt.sensitivity(sink, **ck)
    real = sens._save_grad_checkpoint

    def cut(*args, **kwargs):
        real(*args, **kwargs)
        raise RuntimeError("cut after one segment")

    sens._save_grad_checkpoint = cut
    try:
        pt.sensitivity(sink, **ck)
        check(False, "the cut run finished")
    except RuntimeError as exc:
        check("cut after one segment" in str(exc), f"the cut run raised {exc!r}")
    finally:
        sens._save_grad_checkpoint = real
    check(path.exists(), "the cut run left no checkpoint")
    resumed, resume_ms = wall_ms(torch, lambda: pt.sensitivity(sink, **ck))
    bitwise = resumed.value == full.value and resumed.gradients == full.gradients
    check(bitwise, "the resumed run differs from the uninterrupted checkpointed run")
    check(not path.exists(), "the finished run left its checkpoint")
    emit({"phase": "sensitivity_streamed", "card": smi, "n": N_SENS_STREAM, "block": N_SENS,
          "mean_value": mean.value, "estimate_mean": est["mean"], "value_rel": value_rel,
          "mean_wall_ms": mean_ms, "mean_peak_mb": mean_mb, "cvar95_value": tail.value,
          "cvar95_wall_ms": tail_ms, "cvar95_peak_mb": tail_mb, "one_block_peak_mb": shot_mb,
          "checkpoint_segments": N_SENS_STREAM // SENS_CHECKPOINT_EVERY,
          "resumed_bitwise": bitwise, "resume_wall_ms": resume_ms,
          "mean_gradients": dict(zip(labels, (mean[p] for p in pairs))),
          "cvar95_gradients": dict(zip(labels, (tail[p] for p in pairs)))})

    # (c) bench_paths' GBM: the terminal mean's delta and d/dmu.
    gbm = pt.GeometricBrownianMotion(s0=100, mu=0.03, sigma=0.2, T=1.0, steps=252)

    def greeks():
        return pt.sensitivity(gbm.terminal(), wrt={gbm: ["s0", "mu"]}, size=N_GREEK_PATHS,
                              block_size=GREEK_BLOCK, replicates=GREEK_REPLICATES,
                              random_state=23)

    greeks()
    g, greek_ms = wall_ms(torch, greeks)
    z_delta = (g[(gbm, "s0")] - np.exp(0.03)) / g.sems[(gbm, "s0")]
    z_mu = (g[(gbm, "mu")] - 100 * np.exp(0.03)) / g.sems[(gbm, "mu")]
    check(abs(z_delta) <= SE_MAX and abs(z_mu) <= SE_MAX,
          f"GBM Greeks {g.gradients} ({z_delta:.2f}, {z_mu:.2f} SE)")
    emit({"phase": "sensitivity_greeks", "card": smi, "paths": N_GREEK_PATHS, "steps": 252,
          "block": GREEK_BLOCK, "replicates": GREEK_REPLICATES, "wall_ms": greek_ms,
          "delta": g[(gbm, "s0")], "delta_sem": g.sems[(gbm, "s0")], "delta_z": z_delta,
          "dmu": g[(gbm, "mu")], "dmu_sem": g.sems[(gbm, "mu")], "dmu_z": z_mu})

    # (d) Sobol' indices: 2^20 on the card, the card against the CPU on
    # one A and B, and Ishigami against its closed forms.
    def indices():
        return pt.sobol_indices(sink, size=N_SOBOL, random_state=24, method="sobol")

    indices()
    sob, sobol_ms, sobol_mb = peak_mb(indices)
    cols = tuple(plan.columns_of(v) for v in plan.isns)
    AB = np.random.default_rng(24).integers(1, 2**23, (N_SOBOL_CHECK, 2 * plan.d)) / 2**23
    sobol_fn = sens._build_sobol_fn(plan, cols)

    def sobol_on(device):
        A = torch.as_tensor(AB[:, :plan.d], dtype=torch.float32, device=device)
        B = torch.as_tensor(AB[:, plan.d:], dtype=torch.float32, device=device)
        return [v.cpu().double().numpy() for v in sobol_fn(A, B)]

    on_card = sobol_on("cuda")
    config.set_device("cpu")
    try:
        on_cpu = sobol_on("cpu")
    finally:
        config.set_device("cuda")
    moment_rel = max(abs(float(a) - float(b)) / max(1.0, abs(float(b)))
                     for a, b in zip(on_card[:2], on_cpu[:2]))
    index_err = max(float(np.abs(a - b).max()) for a, b in zip(on_card[2:4], on_cpu[2:4]))
    check(moment_rel <= SOBOL_MOMENT_TOL and index_err <= SOBOL_INDEX_TOL,
          f"Sobol' card vs CPU: moments {moment_rel}, indices {index_err}")
    xs = [pt.Distribution("uniform", loc=-np.pi, scale=2 * np.pi) for _ in range(3)]
    f = pt.Sin(xs[0]) + 7 * pt.Sin(xs[1]) ** 2 + 0.1 * xs[2] ** 4 * pt.Sin(xs[0])
    ish = pt.sobol_indices(f, size=N_ISHIGAMI, random_state=1)
    ish_err = max(max(abs(ish.first_order[x] - s), abs(ish.total_order[x] - t))
                  for x, s, t in zip(xs, (0.3139, 0.4424, 0.0), (0.5576, 0.4424, 0.2437)))
    check(ish_err <= ISHIGAMI_TOL, f"Ishigami indices off by {ish_err}")
    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          f"the sensitivity phase launched K1 {cuda_exec.LAUNCHES} and K2 "
          f"{cuda_exec.STATS_LAUNCHES} times")
    emit({"phase": "sensitivity_sobol", "card": smi, "n": N_SOBOL, "variables": len(cols),
          "rows": (2 + len(cols)) * N_SOBOL, "wall_ms": sobol_ms, "peak_mb": sobol_mb,
          "first_order": {f"{type(v).__name__}#{plan.col_of[v._id]}": sob.first_order[v]
                          for v in plan.isns},
          "total_order": {f"{type(v).__name__}#{plan.col_of[v._id]}": sob.total_order[v]
                          for v in plan.isns},
          "check_n": N_SOBOL_CHECK, "card_vs_cpu_moments_rel": moment_rel,
          "card_vs_cpu_indices_abs": index_err, "ishigami_n": N_ISHIGAMI,
          "ishigami_max_abs_err": ish_err, "k1_launches": cuda_exec.LAUNCHES,
          "k2_launches": cuda_exec.STATS_LAUNCHES, "phase_s": time.perf_counter() - t_phase})


def walled(torch, fn):
    """(result, record) of one call of ``fn``: its wall ms (host clock, card
    synchronised) and its peak MB above what was allocated when it began
    (earlier phases' tensors can be freed during the phase, so the phase's
    own start is no floor)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, wall = wall_ms(torch, fn)
    return out, {"wall_ms": wall, "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20}


def measured(torch, fn):
    """``walled``, then a second call under torch.profiler
    (``profiled_call``)."""
    out, record = walled(torch, fn)
    return out, {**record, **profiled_call(torch, fn)}


def black_scholes_call(np, scipy, s0, k, r, sigma, t):
    d1 = (np.log(s0 / k) + (r + sigma**2 / 2) * t) / (sigma * np.sqrt(t))
    d2 = d1 - sigma * np.sqrt(t)
    return float(s0 * scipy.stats.norm.cdf(d1) - k * np.exp(-r * t) * scipy.stats.norm.cdf(d2))


def estimators_path(torch, np, scipy, cuda_exec, _compile, smi):
    """Phase 22: ``sweep``, ``tilted`` and ``mlmc_estimate`` on the card,
    through the plain executor (no kernel takes their graphs)."""
    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch import config
    from probabilit_tpu_torch.engine import mlmc, streaming
    from probabilit_tpu_torch.engine import sweep as sweep_mod
    from probabilit_tpu_torch.models.benchmarks import build_project_cost, mixed_dag_20

    t_phase = time.perf_counter()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    sink = mixed_dag_20()
    plan = _compile.get_plan(sink)
    price = plan.isns[0]  # lognorm(s=0.25, scale=50)
    scales = np.linspace(40.0, 60.0, LADDER_POINTS)
    ladder = {(price, "scale"): scales}

    # (a) A 64-point CRN ladder of the price's scale at 2^20 draws, an 8 x 8
    # meshgrid of its shape and scale, and the card against the CPU on one
    # explicit matrix for four scenarios.
    def one_shot():
        return pt.sweep(sink, ladder, size=N_LADDER, random_state=22,
                        statistics=LADDER_STATISTICS)

    one_shot()
    lad, lad_rec = measured(torch, one_shot)
    check(all(np.all(np.isfinite(lad[k])) for k in lad.keys()), "ladder statistics not finite")
    check(bool(np.all(np.diff(lad["mean"]) > 0)), f"the ladder's mean is not monotone: {lad['mean']}")
    ss, aa = np.meshgrid(np.linspace(0.15, 0.35, 8), np.linspace(40.0, 60.0, 8))
    grid, grid_rec = measured(torch, lambda: pt.sweep(
        sink, {price: {"s": ss.ravel(), "scale": aa.ravel()}}, size=N_LADDER, random_state=23,
        statistics=LADDER_STATISTICS))
    check(grid.n == LADDER_POINTS and all(np.all(np.isfinite(grid[k])) for k in grid.keys()),
          "meshgrid statistics not finite")
    # Independent streams take the loop (one body a scenario): its cost on
    # the card beside the batch.
    loose, loose_rec = measured(torch, lambda: pt.sweep(
        sink, {(price, "scale"): scales[:LADDER_LOOP_POINTS]}, size=N_LADDER, random_state=25,
        statistics=LADDER_STATISTICS, common_random_numbers=False))
    check(all(np.all(np.isfinite(loose[k])) for k in loose.keys()),
          "independent-stream ladder not finite")
    q = np.random.default_rng(22).integers(1, 2**23, (N_LADDER_CHECK, plan.d)) / 2**23
    fn = sweep_mod._build_sweep_fn(plan, [(price, "scale")], LADDER_STATISTICS, True,
                                   _compile.resolve_correlator("imanconover"), True)

    def ladder_on(device):
        th = torch.tensor(scales[:LADDER_CHECK_SCENARIOS, None], dtype=torch.float32,
                          device=device)
        return fn(th, torch.as_tensor(q, dtype=torch.float32, device=device))

    card = ladder_on("cuda")
    config.set_device("cpu")
    try:
        cpu = ladder_on("cpu")
    finally:
        config.set_device("cuda")
    ladder_err = float((np.abs(card - cpu) / np.maximum(1.0, np.abs(cpu))).max())
    check(ladder_err <= LADDER_TOL, f"sweep card vs CPU {ladder_err}")
    # One scenario's evaluation (the body and a mean) beside the ladder.
    one = sweep_mod._build_sweep_fn(plan, [(price, "scale")], ["mean"], False,
                                    _compile.resolve_correlator("imanconover"), True)
    qd = torch.rand((N_LADDER, plan.d), device="cuda")
    th1 = torch.tensor([[50.0]], device="cuda")
    one(th1, qd)
    _, one_ms = wall_ms(torch, lambda: one(th1, qd))
    emit({"phase": "estimators_sweep", "at_s": time.perf_counter() - t_phase, "card": smi, "n": N_LADDER, "scenarios": LADDER_POINTS,
          "statistics": LADDER_STATISTICS, "batched": sweep_mod._batchable(plan, [(price, "scale")],
                                                                          True),
          "ladder": lad_rec, "meshgrid": grid_rec,
          "independent_streams": {"scenarios": LADDER_LOOP_POINTS, **loose_rec},
          "one_scenario_mean_ms": one_ms, "ladder_mean": lad["mean"][[0, 31, 63]].tolist(),
          "ladder_q95": lad["q0.95"][[0, 31, 63]].tolist(),
          "ladder_cvar95": lad["cvar0.95"][[0, 31, 63]].tolist(),
          "check_n": N_LADDER_CHECK, "check_scenarios": LADDER_CHECK_SCENARIOS,
          "card_vs_cpu_max_rel": ladder_err, "tolerance": LADDER_TOL})

    # (b) The same ladder streamed at 2^24 draws a scenario in 2^20 blocks;
    # scenarios 0 and 63 against estimate(executor=None) with the scale set
    # by hand (to the float32 value the sweep swaps in).
    streamed, st_rec = measured(torch, lambda: pt.sweep(
        sink, ladder, size=N_LADDER_STREAM, block_size=LADDER_BLOCK, random_state=24,
        statistics=LADDER_STATISTICS))
    check(bool(np.all(np.diff(streamed["mean"]) > 0)), "the streamed ladder is not monotone")
    stream_err = {}
    for s in (0, LADDER_POINTS - 1):
        saved = price.kwargs["scale"]
        price.kwargs["scale"] = float(np.float32(scales[s]))
        try:
            est = streaming.estimate(sink, N_LADDER_STREAM, block_size=LADDER_BLOCK,
                                     random_state=24, executor=None, quantiles=(0.95,),
                                     cvar=(0.95,))
        finally:
            price.kwargs["scale"] = saved
        stream_err[s] = max(abs(streamed[k][s] - est[k]) / max(1.0, abs(est[k]))
                            for k in LADDER_STATISTICS)
        check(stream_err[s] <= LADDER_STREAM_TOL,
              f"streamed scenario {s} vs estimate: {stream_err[s]}")
    emit({"phase": "estimators_sweep_streamed", "at_s": time.perf_counter() - t_phase, "card": smi, "n": N_LADDER_STREAM,
          "block": LADDER_BLOCK, "scenarios": LADDER_POINTS, **st_rec,
          "vs_estimate_max_rel": {str(s): e for s, e in stream_err.items()},
          "tolerance": LADDER_STREAM_TOL, "mean": streamed["mean"][[0, 63]].tolist()})

    # (c) examples/04's three sweeps of the project-cost model.
    total, variables = build_project_cost()
    rate = variables["hourly_rate"]
    rates = np.linspace(85.0, 105.0, 9)
    calls = {
        "crn_ladder": dict(size=1 << 16, random_state=0, statistics=("mean", "q0.95")),
        "streamed_replicated": dict(size=1 << 17, block_size=1 << 15, random_state=0,
                                    replicates=4, statistics=("mean", "q0.95")),
        "sequential": dict(size=1 << 14, random_state=0, replicates=4, target_sem=200.0),
    }
    example = {}
    for label, kwargs in calls.items():
        res, rec = measured(torch, lambda kw=kwargs: pt.sweep(total, {(rate, "loc"): rates},
                                                              **kw))
        check(bool(np.all(np.diff(res["mean"]) > 0)), f"examples/04 {label}: mean not monotone")
        if "q0.95" in res.keys():
            check(bool(np.all(np.diff(res["q0.95"]) > 0)),
                  f"examples/04 {label}: P95 not monotone")
        example[label] = {**rec, "mean": res["mean"][[0, 4, 8]].tolist()}
        if label == "sequential":
            check(res.converged, f"the sequential ladder did not converge in {res.rounds} rounds")
            example[label].update(rounds=res.rounds, converged=res.converged,
                                  draws_a_scenario=res.size, worst_sem=float(res["sem"].max()))
        if label == "streamed_replicated":
            example[label]["q95_base"] = float(res["q0.95"][4])
            example[label]["q95_base_sem"] = float(res["q0.95_sem"][4])
    emit({"phase": "estimators_examples_04", "at_s": time.perf_counter() - t_phase, "card": smi, **example})

    # (d) examples/08's first case: P(Z < -6) by a lower tilt at the
    # suggested exponent, at 10^6 in 2^17 blocks and at 2^24 in 2^20 blocks.
    exact = float(scipy.stats.norm.cdf(-6.0))
    k = pt.suggest_tilt(1e-9)
    z, w = pt.tilted("norm", k=k, tail="lower")
    event = (z < -6.0) * w
    rare = {}
    for n, block in ((N_RARE, RARE_BLOCK), (N_RARE_LARGE, RARE_LARGE_BLOCK)):
        est, rec = measured(torch, lambda n=n, block=block: pt.estimate(
            event, n, block_size=block, random_state=0))
        zs = (est["mean"] - exact) / est["sem"]
        check(abs(zs) <= RARE_SE, f"P(Z < -6) at {n}: {est['mean']} vs {exact} ({zs:.2f} SE)")
        rare[str(n)] = {**rec, "block": block, "mean": est["mean"], "sem": est["sem"], "z": zs}
    emit({"phase": "estimators_rare_event", "at_s": time.perf_counter() - t_phase, "card": smi, "k": k, "exact": exact, **rare})

    # (e) examples/07's mlmc_demo (Milstein, eps 0.02) and the README's Euler
    # call at eps 0.01; then each level's launches on one block.
    want = float(np.exp(0.05)) * black_scholes_call(np, scipy, 100.0, 100.0, 0.05, 0.2, 1.0)

    def payoff(paths):
        return torch.clamp(paths[:, -1] - 100.0, min=0.0)

    def drift(t, x):
        return 0.05 * x

    def diffusion(t, x):
        return 0.2 * x

    for scheme, eps in MLMC_CASES:
        res, rec = measured(torch, lambda s=scheme, e=eps: pt.mlmc_estimate(
            drift, diffusion, payoff, x0=100.0, eps=e, scheme=s, random_state=0))
        check(abs(res["mean"] - want) <= MLMC_SE * eps,
              f"mlmc {scheme}: {res['mean']} vs {want} (eps {eps})")

        def make(n_steps, s=scheme):
            return pt.SDE(drift, diffusion, x0=100.0, T=1.0, steps=n_steps, scheme=s)

        levels = []
        for lv, steps in enumerate(res["steps"]):
            draw, sums, _ = mlmc._level_kernel(make, payoff, 4, 4, lv)
            rows = min(res["n_per_level"][lv], max(64, ((1 << 22) // steps) // 64 * 64))
            prof = profile_block(torch, lambda: sums(draw(lv, rows, 0)).tolist())
            levels.append({"level": lv, "steps": steps, "n": res["n_per_level"][lv],
                           "block_rows": rows, "launches_a_block": prof["kernel_launches"],
                           "block_wall_ms": prof["wall_ms"], "block_device_ms": prof["device_ms"],
                           "block_idle_share": prof["idle_share"]})
        emit({"phase": "estimators_mlmc", "at_s": time.perf_counter() - t_phase, "card": smi, "scheme": scheme, "eps": eps, **rec,
              "mean": res["mean"], "want": want, "error_over_eps": (res["mean"] - want) / eps,
              "levels": res["levels"], "n_per_level": res["n_per_level"],
              "steps": res["steps"], "cost": res["cost"], "cost_mc": res["cost_mc"],
              "cost_over_cost_mc": res["cost"] / res["cost_mc"], "per_level": levels})

    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          f"the estimators phase launched K1 {cuda_exec.LAUNCHES} and K2 "
          f"{cuda_exec.STATS_LAUNCHES} times")
    emit({"phase": "estimators", "card": smi, "k1_launches": cuda_exec.LAUNCHES,
          "k2_launches": cuda_exec.STATS_LAUNCHES, "phase_s": time.perf_counter() - t_phase})


def american_copula_path(torch, np, scipy, cuda_exec, _compile, smi):
    """Phase 23: ``american_price``/``american_greeks``, the Student-t
    copula and the permutation correlator on the card, through the plain
    executor (no kernel takes their work)."""
    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch.correlation import PermutationCorrelator
    from probabilit_tpu_torch.engine import american
    from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50

    t_phase = time.perf_counter()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0

    def put(strike):
        return lambda s: torch.clamp(strike - s, min=0.0)

    def gbm(s0=40.0, sigma=0.2, steps=50):
        return pt.GeometricBrownianMotion(s0=s0, mu=0.06, sigma=sigma, T=1.0, steps=steps)

    # One small call of each kind first: the first call of a path family or
    # of autograd sets up what the timed calls reuse.
    heston = pt.Heston(s0=9.0, mu=0.1, v0=0.0625, kappa=5.0, theta=0.16, sigma=0.9, rho=0.1,
                       T=0.25, steps=50)
    pt.american_price(gbm(), put(40.0), rate=0.06, size=1 << 12, random_state=0)
    pt.american_price(heston, put(10.0), rate=0.1, size=1 << 12, random_state=0)
    pt.american_greeks(gbm(steps=16), put(40.0), rate=0.06, size=1 << 12, random_state=0)

    # (a) Longstaff-Schwartz 2001, table 1: GBM puts at 2^20 paths, 50 dates;
    # then one fit alone, for its launches a date.
    table = {}
    for s0, fd in LSMC_TABLE:
        res, rec = measured(torch, lambda s0=s0: pt.american_price(
            gbm(s0), put(40.0), rate=0.06, size=N_LSMC, random_state=0))
        check(abs(res["price"] - fd) < LSMC_TOL and res["price"] < fd + 3 * res["se"],
              f"LSMC put at s0 = {s0}: {res['price']} +- {res['se']} against FD {fd}")
        table[str(s0)] = {**rec, "price": res["price"], "se": res["se"], "fd": fd,
                          "exercise_fraction": res["exercise_fraction"]}
    pay, feats = american._sample_states(gbm(36.0), 23, N_LSMC, torch.float32, None, "joint",
                                         None)
    powers = american._monomial_powers(1, 3)
    fit = profile_block(torch, lambda: american._fit_weights(
        pay, feats, put(40.0), powers, float(np.exp(-0.06 / 50)), 1e-6))
    del pay, feats
    emit({"phase": "american_ls2001", "at_s": time.perf_counter() - t_phase, "card": smi,
          "n": N_LSMC, "dates": 50, "tolerance": LSMC_TOL, "puts": table,
          "fit_alone": fit, "fit_launches_a_date": fit["kernel_launches"] / 49})

    # (b) Heston, Ikonen-Toivanen: the joint (s, v) basis against the asset's.
    prices = {}
    for state in ("joint", "asset"):
        res, rec = measured(torch, lambda state=state: pt.american_price(
            heston, put(10.0), rate=0.1, size=N_HESTON_LSMC, random_state=0, state=state))
        prices[state] = {**rec, "price": res["price"], "se": res["se"],
                         "exercise_fraction": res["exercise_fraction"]}
    pj, pa = prices["joint"], prices["asset"]
    se = max(pj["se"], pa["se"])
    check(pj["price"] - pa["price"] > 3 * se,
          f"Heston joint basis {pj['price']} does not beat the asset basis {pa['price']}")
    check(0.985 * HESTON_FD <= pj["price"] <= HESTON_FD + 3 * pj["se"],
          f"Heston joint price {pj['price']} +- {pj['se']} against FD {HESTON_FD}")
    emit({"phase": "american_heston", "at_s": time.perf_counter() - t_phase, "card": smi,
          "n": N_HESTON_LSMC, "dates": 50, "fd": HESTON_FD, **prices,
          "joint_minus_asset_over_se": (pj["price"] - pa["price"]) / se})

    # (c) Andersen-Broadie's Bermudan max-call on two assets, Sobol paths.
    joint = pt.CorrelatedGBM([100.0, 100.0], [-0.05, -0.05], [0.2, 0.2],
                             [[1.0, 0.0], [0.0, 1.0]], T=3.0, steps=9)[0].joint
    res, rec = measured(torch, lambda: pt.american_price(
        joint, lambda a, b: torch.clamp(torch.maximum(a, b) - 100.0, min=0.0), rate=0.05,
        size=N_MAX_CALL, degree=5, method="sobol", random_state=0))
    low, high = MAX_CALL_BOUNDS
    check(low - 4 * res["se"] <= res["price"] <= high + 2 * res["se"],
          f"max-call {res['price']} +- {res['se']} outside [{low} - 4 se, {high} + 2 se]")
    emit({"phase": "american_max_call", "at_s": time.perf_counter() - t_phase, "card": smi,
          "n": N_MAX_CALL, "dates": 9, "degree": 5, "method": "sobol", **rec,
          "price": res["price"], "se": res["se"], "exercise_fraction": res["exercise_fraction"],
          "bounds": MAX_CALL_BOUNDS})

    # (d) The ATM put's Greeks against central differences on common seeds.
    greeks, rec = measured(torch, lambda: pt.american_greeks(
        gbm(steps=16), put(40.0), rate=0.06, size=N_LSMC_GREEKS, random_state=0))

    def price_at(s0, sigma):
        return pt.american_price(gbm(s0, sigma, 16), put(40.0), rate=0.06, size=N_LSMC_GREEKS,
                                 random_state=0)["price"]

    fd_delta = (price_at(40.25, 0.2) - price_at(39.75, 0.2)) / 0.5
    fd_vega = (price_at(40.0, 0.21) - price_at(40.0, 0.19)) / 0.02
    check(-1.0 < greeks["s0"] < 0.0 and abs(greeks["s0"] - fd_delta) <= LSMC_DELTA_TOL,
          f"delta {greeks['s0']} against the central difference {fd_delta}")
    check(greeks["sigma"] > 0.0 and abs(greeks["sigma"] - fd_vega) <= LSMC_VEGA_REL_TOL * fd_vega,
          f"vega {greeks['sigma']} against the central difference {fd_vega}")
    check(greeks["rate"] < 0.0, f"rho {greeks['rate']} is not negative")
    emit({"phase": "american_greeks", "at_s": time.perf_counter() - t_phase, "card": smi,
          "n": N_LSMC_GREEKS, "dates": 16, **rec, "greeks": greeks, "fd_delta": fd_delta,
          "fd_vega": fd_vega})

    # (e) One 2^14-path fit and evaluation on the card and on the CPU from
    # the same increments (drawn on the CPU), in float32.  The two devices
    # sum the Gram matrices in other orders, and one flipped decision moves
    # every earlier date's carry, so the fits are held on their first solve
    # (the last interior date), the policy on one fit (the card's, applied
    # on both), and the whole prices against their standard error.
    node = gbm(36.0)
    cpu = torch.Generator().manual_seed(23)
    incs = [node._increments(cpu, N_LSMC_CHECK, torch.float32) for _ in range(2)]
    disc = float(np.exp(-0.06 / 50))

    def fit_and_evaluate(device, fitted=None):
        fit_pay, eval_pay = (
            torch.stack([s.T for s in node._state_paths_from_increments(inc.to(device))], dim=2)
            for inc in incs)
        if fitted is None:
            fitted = american._fit_weights(fit_pay, fit_pay, put(40.0), powers, disc, 1e-6)
        fitted = tuple(t.to(device) for t in fitted)
        value, _ = american._apply_policy(eval_pay, eval_pay, put(40.0), powers, disc, fitted)
        return value.double().cpu().numpy(), fitted

    v_card, fit_card = fit_and_evaluate("cuda")
    v_cpu, fit_cpu = fit_and_evaluate("cpu")
    v_policy, _ = fit_and_evaluate("cpu", fit_card)
    w_card, w_cpu = (f[0].double().cpu().numpy() for f in (fit_card, fit_cpu))
    first_solve_gap = float(np.abs(w_card[-1] - w_cpu[-1]).max() / np.abs(w_cpu[-1]).max())
    weight_gaps = np.abs(w_card - w_cpu).max(axis=1) / np.abs(w_cpu).max(axis=1)
    moved = np.abs(v_policy - v_card) > LSMC_PRICE_TOL * np.maximum(1.0, np.abs(v_card))
    policy_gap = abs(v_policy[~moved].mean() - v_card[~moved].mean()) / abs(v_card.mean())
    se = float(v_cpu.std() / np.sqrt(N_LSMC_CHECK))
    price_gap = abs(v_card.mean() - v_cpu.mean())
    check(first_solve_gap <= LSMC_WEIGHT_TOL,
          f"LSMC first solve, card against CPU: {first_solve_gap}")
    check(moved.mean() <= LSMC_MOVED_SHARE and policy_gap <= LSMC_PRICE_TOL,
          f"LSMC policy, card against CPU: {moved.mean()} of the paths moved, price {policy_gap}")
    check(price_gap <= LSMC_SE_SHARE * se, f"LSMC card against CPU: {price_gap} against se {se}")
    emit({"phase": "american_card_vs_cpu", "n": N_LSMC_CHECK, "dates": 50,
          "price_card": float(v_card.mean()), "price_cpu": float(v_cpu.mean()), "se": se,
          "price_gap_over_se": price_gap / se, "first_solve_weight_gap": first_solve_gap,
          "weight_gap_by_date": weight_gaps.tolist(),
          "one_policy_moved_share": float(moved.mean()),
          "one_policy_price_rel_gap": float(policy_gap),
          "own_policies_moved_share": float(np.mean(np.abs(v_cpu - v_card) > LSMC_PRICE_TOL
                                                    * np.maximum(1.0, np.abs(v_card)))),
          "tolerances": {"first_solve": LSMC_WEIGHT_TOL, "moved_share": LSMC_MOVED_SHARE,
                         "policy_price": LSMC_PRICE_TOL, "price_over_se": LSMC_SE_SHARE}})

    # (f) The t copula on mixed_correlated_50: one shot at 1e8 beside the
    # Gaussian copula on the same seed, and streamed at 2^28 in 2^24 blocks.
    sink = mixed_correlated_50()
    plan = _compile.get_plan(sink)
    keep = list(plan.corr_vars)

    def one_shot(n, correlator):
        return sink.sample(n, random_state=23, correlator=correlator, gc_strategy=keep,
                           executor=None)

    shots = {}
    for n in (N_TCOPULA, N_TCOPULA_SMALL):
        x, rec = walled(torch, lambda n=n: one_shot(n, "tcopula"))
        check(bool(torch.isfinite(x).all()), f"t copula at {n}: values not finite")
        rho = float(plan.corr_matrix[0, 3])
        a, b = (v.samples_[:N_TAU].double().cpu().numpy() for v in (keep[0], keep[3]))
        tau = float(scipy.stats.kendalltau(a, b).statistic)
        want = 2.0 / np.pi * np.arcsin(rho)
        check(abs(tau - want) <= TAU_TOL, f"t copula tau {tau} against {want}")
        q_t = float(torch.sort(x).values[int(0.999 * (n - 1))])
        del x
        g, g_rec = walled(torch, lambda n=n: one_shot(n, "imanconover"))
        q_g = float(torch.sort(g).values[int(0.999 * (n - 1))])
        del g
        check(q_t > q_g, f"t copula's 99.9% quantile {q_t} not above the Gaussian's {q_g}")
        shots[str(n)] = {**rec, "tau": tau, "tau_want": want, "rho": rho, "q999_t": q_t,
                         "q999_gaussian": q_g, "gaussian": g_rec}
        if rec["peak_mb"] <= TCOPULA_PEAK_MB:
            break
    est, streamed = walled(torch, lambda: pt.estimate(
        sink, N_TCOPULA_STREAM, block_size=TCOPULA_BLOCK, random_state=23,
        correlator="tcopula", executor=None))
    check(np.isfinite(est["mean"]), "streamed t copula estimate not finite")
    # One 2^24 block under the profiler stands for both: a one-shot call
    # runs the same body (the launches do not depend on n), and a trace of
    # its ~22,000 launches takes the profiler about ten seconds.
    block = profiled_call(torch, lambda: pt.estimate(
        sink, TCOPULA_BLOCK, block_size=TCOPULA_BLOCK, random_state=23, correlator="tcopula",
        executor=None))
    emit({"phase": "tcopula", "at_s": time.perf_counter() - t_phase, "card": smi,
          "graph": "mixed_correlated_50", "k": len(keep), "df": 4.0, "one_shot": shots,
          "streamed": {"n": N_TCOPULA_STREAM, "block": TCOPULA_BLOCK, **streamed,
                       "mean": est["mean"], "sem": est["sem"]},
          "one_block_profiled": block})

    # (g) The permutation correlator on a (10^5, 10) matrix toward the
    # repaired target, default 1,000 iterations; a short run profiled.
    gen = torch.Generator(device="cuda").manual_seed(23)
    X = torch.randn(PERMUTATION_SHAPE, generator=gen, device="cuda")
    target = plan.corr_matrix
    pc = PermutationCorrelator(seed=23).set_target(target)
    err0 = pc._error(np.corrcoef(X.cpu().numpy(), rowvar=False), target)
    Y, rec = walled(torch, lambda: pc(X))
    err = pc._error(np.corrcoef(Y.cpu().numpy(), rowvar=False), target)
    check(torch.equal(torch.sort(Y, dim=0).values, torch.sort(X, dim=0).values),
          "a permuted column is not a permutation of its input")
    check(err < err0, f"the permutation climb did not improve: {err0} -> {err}")
    short = PermutationCorrelator(iterations=PERMUTATION_PROFILED_ITERATIONS,
                                  seed=23).set_target(target)
    prof = profiled_call(torch, lambda: short(X))
    steps = PERMUTATION_PROFILED_ITERATIONS * PERMUTATION_SHAPE[1]
    emit({"phase": "permutation_correlator", "at_s": time.perf_counter() - t_phase,
          "card": smi, "shape": list(PERMUTATION_SHAPE), "iterations": pc.iters,
          **rec, "error_before": err0, "error": err,
          "profiled_iterations": PERMUTATION_PROFILED_ITERATIONS, "profiled": prof,
          "launches_a_column_step": prof["kernel_launches"] / steps})

    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          f"the American and copula phase launched K1 {cuda_exec.LAUNCHES} and K2 "
          f"{cuda_exec.STATS_LAUNCHES} times")
    emit({"phase": "american_copula", "card": smi, "k1_launches": cuda_exec.LAUNCHES,
          "k2_launches": cuda_exec.STATS_LAUNCHES, "phase_s": time.perf_counter() - t_phase})


def mesh_profiling_path(torch, np, cuda_exec, _compile, smi, here):
    """Phase 24: the sample-axis mesh and the profiling utilities on the
    card (``parallel/mesh.py``, ``utils/profiling.py``)."""
    import contextlib
    import io
    import os
    import shutil

    import probabilit_tpu_torch as pt
    from probabilit_tpu_torch.models.benchmarks import mixed_correlated_50, mixed_dag_20
    from probabilit_tpu_torch.parallel import make_mesh, use_mesh
    from probabilit_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    sink, corr = mixed_dag_20(), mixed_correlated_50()
    plan = _compile.get_plan(sink)
    ladder = {(plan.isns[0], "scale"): np.linspace(40.0, 60.0, MESH_LADDER_POINTS)}

    def call_payoff(paths):
        return torch.clamp(paths[:, -1] - 100.0, min=0.0)

    gbm = pt.GeometricBrownianMotion(s0=36.0, mu=0.06, sigma=0.2, T=1.0, steps=50)

    def bitwise(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return repr(a) == repr(b)

    def correlated_close(a, b):
        return bool(torch.all(torch.abs(b - a) <= MESH_CORR_TOL * (1.0 + torch.abs(a))))

    def mlmc_close(a, b):
        return (a["n_per_level"] == b["n_per_level"]
                and abs(b["mean"] - a["mean"]) <= MESH_MLMC_TOL * abs(a["mean"]))

    def lsmc_close(a, b):
        return abs(b["price"] - a["price"]) <= 3 * a["se"] and 0.0 < b["exercise_fraction"] < 1.0

    def gradients_close(a, b):
        rtol, atol = MESH_GRAD_TOL
        return len(a.gradients) == 16 and all(
            abs(b.gradients[k] - g) <= atol + rtol * abs(g) for k, g in a.gradients.items())

    def ladder_equal(a, b):
        return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                   for k in ("mean", "q0.95", "cvar0.95"))

    # name: (call under the mesh or not, agreement with the call without one).
    # estimate() takes executor="auto", which picks K1 without a mesh: the
    # baseline asks for the plain executor, whose stream the mesh keeps.
    cases = {
        "sample_iid": (lambda meshed: sink.sample(N_MESH, random_state=24, gc_strategy=[]),
                       bitwise),
        "sample_sobol": (lambda meshed: sink.sample(N_MESH, random_state=24, method="sobol",
                                                    gc_strategy=[]), bitwise),
        "correlated_iid": (lambda meshed: corr.sample(N_MESH, random_state=24, gc_strategy=[]),
                           correlated_close),
        "correlated_sobol": (lambda meshed: corr.sample(N_MESH, random_state=24, method="sobol",
                                                        gc_strategy=[]), correlated_close),
        "estimate": (lambda meshed: pt.estimate(
            sink, N_MESH_ESTIMATE, random_state=24, quantiles=(0.5, 0.99), cvar=(0.99,),
            executor="auto" if meshed else None), bitwise),
        "mlmc_euler": (lambda meshed: pt.mlmc_estimate(
            lambda t, x: 0.05 * x, lambda t, x: 0.2 * x, call_payoff, x0=100.0, eps=0.01,
            scheme="euler", random_state=0), mlmc_close),
        "lsmc_put": (lambda meshed: pt.american_price(
            gbm, lambda s: torch.clamp(40.0 - s, min=0.0), rate=0.06, size=N_MESH_LSMC,
            random_state=0), lsmc_close),
        "gradients": (lambda meshed: pt.sensitivity(
            sink, wrt=list(plan.isns), size=N_MESH_GRADIENTS, random_state=24),
            gradients_close),
        "ladder": (lambda meshed: pt.sweep(
            sink, ladder, size=N_MESH_GRADIENTS, random_state=24,
            statistics=("mean", "q0.95", "cvar0.95")), ladder_equal),
    }

    # (a) Each case without a mesh (a warm call, then the timed one), under
    # make_mesh() (every card) and under four shards on cuda:0.
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    base = {}
    records = {name: {} for name in cases}
    for name, (fn, _) in cases.items():
        fn(False)
        base[name], records[name]["no_mesh_wall_ms"] = wall_ms(torch, lambda fn=fn: fn(False))
    meshes = {"make_mesh": make_mesh(),
              f"{MESH_SHARDS_ONE_CARD}_shards_on_cuda0":
              make_mesh([torch.device("cuda:0")] * MESH_SHARDS_ONE_CARD)}
    for label, mesh in meshes.items():
        with use_mesh(mesh):
            for name, (fn, agree) in cases.items():
                out, ms = wall_ms(torch, lambda fn=fn: fn(True))
                ok = agree(base[name], out)
                records[name][label] = {"wall_ms": ms, "agrees": ok}
                check(ok, f"phase 24, {name} under {label}: disagrees with the run without a mesh")
            try:
                sink.sample(N_MESH, random_state=0, gc_strategy=[], executor="cuda")
            except ValueError as err:
                refusal = str(err)
            else:
                refusal = None
            check(refusal is not None and "does not run under a device mesh" in refusal,
                  f"executor='cuda' under {label}: {refusal!r}")
    check(cuda_exec.LAUNCHES == 0 and cuda_exec.STATS_LAUNCHES == 0,
          f"the mesh phase launched K1 {cuda_exec.LAUNCHES} and K2 "
          f"{cuda_exec.STATS_LAUNCHES} times")
    emit({"phase": "mesh", "at_s": time.perf_counter() - t_phase, "card": smi,
          "device_count": torch.cuda.device_count(),
          "meshes": {label: mesh.size for label, mesh in meshes.items()},
          "n": N_MESH, "n_estimate": N_MESH_ESTIMATE, "cases": records,
          "cuda_refusal": refusal, "k1_launches": cuda_exec.LAUNCHES,
          "k2_launches": cuda_exec.STATS_LAUNCHES})

    # (b) trace() around one K1 sample at 1e8; the profile hook on both
    # executors; compiled_stats of the plain body at 2^20.
    t_b = time.perf_counter()
    cuda_exec.LAUNCHES = 0
    cuda_exec.STATS_LAUNCHES = 0
    # A short profiler session's kernel records are sometimes lost
    # (CUPTI): up to TRACE_ATTEMPTS traces, each attempt's kernel events
    # printed.
    attempts = []
    for attempt in range(TRACE_ATTEMPTS):
        trace_dir = here / "build" / f"chip_smoke_trace_{attempt}"
        shutil.rmtree(trace_dir, ignore_errors=True)
        with profiling.trace(logdir=str(trace_dir)) as where:
            sink.sample(N_MAIN, random_state=0, gc_strategy=[], executor="cuda")
        trace_file = Path(where) / "trace.json"
        trace_text = trace_file.read_text()
        events = json.loads(trace_text)["traceEvents"]
        named = "graph_megakernel" in trace_text
        attempts.append({"kernel_events": sum(e.get("cat") == "kernel" for e in events),
                         "names_k1": named})
        if named:
            break
    check(attempts[-1]["names_k1"], f"no trace names the K1 kernel: {attempts}")
    hooks = {}
    os.environ["PROBABILIT_TPU_PROFILE"] = "1"
    try:
        for executor in ("cuda", None):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                _, wall = wall_ms(torch, lambda executor=executor: sink.sample(
                    N_MAIN, random_state=0, gc_strategy=[], executor=executor))
            lines = err.getvalue().splitlines()
            check(lines[:1] == ["[probabilit-tpu profile] sample() phases:"],
                  f"profile header missing: {lines[:1]}")
            phases = {line.split()[0]: float(line.split()[1]) for line in lines[1:]}
            check(list(phases) == ["build+compile", "execute", "host"],
                  f"profile phases {list(phases)}")
            check(sum(phases.values()) <= wall, f"profile phases {phases} over the wall {wall}")
            hooks[str(executor)] = {"wall_ms": wall, "phases_ms": phases}
    finally:
        del os.environ["PROBABILIT_TPU_PROFILE"]
    body = _compile.build_body(plan, {sink._id})
    gen = torch.Generator(device="cuda").manual_seed(24)
    q = torch.rand((N_PROFILE_STATS, plan.d), generator=gen, device="cuda")
    stats = profiling.compiled_stats(body, q)
    check(stats["flops"] > 0 and stats["bytes_accessed"] > 0 and stats["peak_bytes"] > 0
          and stats["output_bytes"] == 4 * N_PROFILE_STATS, f"compiled_stats {stats}")
    launches = cuda_exec.LAUNCHES
    emit({"phase": "profiling", "at_s": time.perf_counter() - t_phase, "card": smi,
          "trace_file": str(trace_file.relative_to(here)), "trace_bytes": len(trace_text),
          "trace_attempts": attempts,
          "profile_hook": hooks, "compiled_stats_plain_body": {"n": N_PROFILE_STATS, **stats},
          "k1_launches": launches, "k2_launches": cuda_exec.STATS_LAUNCHES,
          "part_s": time.perf_counter() - t_b, "phase_s": time.perf_counter() - t_phase})
    return {"k1_launches": launches}


if __name__ == "__main__":
    main()
