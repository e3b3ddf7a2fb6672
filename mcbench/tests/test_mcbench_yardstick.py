"""The yardstick's work per sample, counted from each configuration's
graph, repeats exactly."""

import json

import pytest

from mcbench import spec, yardstick

# (integer instructions, float32 flops) a sample of K1, and K2's bound's
# pipe, for each configuration; 2^24 samples a launch.
K1 = {"mixed_dag_20": (86.0, 268.0), "mixed_correlated_50": (107.5, 959.0)}


def config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(K1))
def test_k1_work_per_sample(name):
    assert yardstick.k1_cost(config(name)) == K1[name]
    assert yardstick.k1_bytes(1 << 24) == 4 << 24
    seconds, by = yardstick.k1_bound(config(name), 1 << 24)
    ints, flops = K1[name]
    assert by == "operations"
    assert seconds == max((1 << 24) * ints / yardstick.INT32_OPS_PER_S,
                          (1 << 24) * flops / yardstick.FP32_FLOPS)


def test_k2_work_per_sample():
    assert yardstick.k2_cost(10) == (107.5, 540, 110)
    assert yardstick.k2_bytes(10) == 520
    seconds, by = yardstick.k2_bound(config("mixed_correlated_50"), 1 << 24)
    assert (by, seconds) == ("operations", (1 << 24) * 540 / yardstick.FP32_FLOPS)
    assert yardstick.k2_bound(config("mixed_dag_20"), 1 << 24) is None


def test_bytes_bind_a_light_launch():
    seconds, by = yardstick.bound(1 << 20, 1 << 40, ints=1.0)
    assert by == "bytes" and seconds == (1 << 40) / yardstick.HBM_BYTES_PER_S
