"""The benchmark's arithmetic against hand-worked cases: operations from
the model's shapes, the kNN observation's least time, percentiles, and a
profiler trace reduced to busy time, idle share and idle gaps."""

import time

import pytest

from portbench import measure


def test_policy_operations_from_the_shapes():
    # 81 features, trunk (256, 256), 20 + 20 logits and a value fused
    fwd = 2 * (81 * 256 + 256 * 256 + 256 * 41)
    assert fwd == 193_536
    assert measure.mlp_forward_flops(81, (256, 256), 41) == fwd
    # the update: forward, weight gradients, input gradients but the first
    upd = fwd + fwd + (fwd - 2 * 81 * 256)
    assert upd == 539_136
    assert measure.mlp_update_flops(81, (256, 256), 41) == upd
    rows = 250 * 100 * 110
    assert rows * (fwd + upd) == pytest.approx(2.01485e12, rel=1e-5)


def test_knn_bound_at_the_flagship_shape():
    E, N, k = 1024, 105, 10
    bytes_in = 4 * (8 * E * N + N + E)
    bytes_out = 4 * E * N * 81
    assert bytes_in + bytes_out == 38_281_636
    ms, by, nbytes = measure.knn_bound_ms(E, N, k, E * N * (N - 1))
    assert by == "bytes" and nbytes == 38_281_636
    assert ms == pytest.approx(1e3 * 38_281_636 / 3.35e12)
    assert ms == pytest.approx(0.011427, rel=1e-4)
    # the operations bound the MXU form only where the pairs outweigh bytes
    ms_ops, by_ops, _ = measure.knn_bound_ms(1, 2, 1, 1e13)
    assert by_ops == "operations" and ms_ops == pytest.approx(5e16 / 67e12)


def test_percentile_interpolates_between_ranks():
    values = list(range(1, 101))  # 1..100 ms
    assert measure.percentile(values, 90) == pytest.approx(90.1)
    assert measure.percentile([5.0], 90) == 5.0
    assert measure.percentile([1.0, 3.0], 50) == 2.0
    with pytest.raises(ValueError):
        measure.percentile([], 90)


def test_busy_union_and_idle_share_of_a_synthetic_trace():
    # kernels in microseconds: two overlapping, one apart, one outside
    kernels = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("a", 30.0, 40.0),
               ("c", 95.0, 130.0)]
    host = [("cudaGraphLaunch", 18.0, 35.0), ("outer", 0.0, 100.0),
            ("aten::sum", 60.0, 90.0)]
    s = measure.summarize(kernels, host, (0.0, 100.0))
    # busy: [0, 20] + [30, 40] + [95, 100] = 35 us of 100
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["idle_share"] == pytest.approx(65.0)
    # gaps: [40, 95] (55 us, under aten::sum), [20, 30] (cudaGraphLaunch)
    assert s["idle_gaps"][0][0] == "aten::sum"
    assert s["idle_gaps"][0][1] == pytest.approx(55e-6)
    assert s["idle_gaps"][1][0] == "cudaGraphLaunch"
    assert s["idle_gaps"][1][1] == pytest.approx(10e-6)
    ops = dict((n, t) for n, t in s["device_ops"])
    assert ops["a"] == pytest.approx(20e-6)
    assert ops["c"] == pytest.approx(5e-6)  # cut at the window's end
    assert measure.union_us([]) == 0.0


def test_readers_of_a_synthetic_run():
    from portbench import harness

    info = {"platform": "gpu", "envs": 1024, "agents": 105, "k": 10,
            "traced_steps": 2, "step_ms": 0.35,
            "credited_launches": {"knn_obs_flat_exact": 2},
            "traced_kernels": [
                ("void knn::scan_kernel<knn::ExactKey>", 0.0, 100.0),
                ("elementwise", 100.0, 300.0),
                ("void knn::scan_kernel<knn::ExactKey>", 400.0, 500.0),
                ("elementwise", 500.0, 700.0)]}
    bound = measure.knn_bound_ms(1024, 105, 10, 1)[0]
    knn = harness.metric_reader("knn_roofline.sim").read(info)
    assert knn == pytest.approx(100.0 * bound / 0.1)
    assert harness.metric_reader("env_ms.sim").read(info) == \
        pytest.approx(0.2)
    info["traced_kernels"] = [("elementwise", 0.0, 1.0)]
    with pytest.raises(RuntimeError):
        harness.metric_reader("knn_roofline.sim").read(info)
    train = {"platform": "gpu", "iter_ms": [200.0, 200.0],
             "phase_ms": [(120.0, 60.0), (122.0, 62.0)],
             "rows_per_iter": 2_750_000, "precision": "float32",
             "row_flops": {"forward": 193_536, "update": 539_136}}
    mfu = harness.metric_reader("mfu.train").read(train)
    assert mfu == pytest.approx(100 * 2.01485e12 / (0.2 * 67e12), rel=1e-5)
    assert harness.metric_reader("rollout_ms.train").read(train) == 121.0
    assert harness.metric_reader("update_ms.train").read(train) == 61.0
    train["platform"] = "cpu"  # no device number from a CPU run
    assert harness.metric_reader("mfu.train").read(train) is None


class _Paced:
    """A stand-in for a run's context and its chunks of work: each chunk
    takes ``sleep`` seconds and reads the next of ``times`` (the last one
    over again)."""

    def __init__(self, times, age_s=0.0, sleep=0.0):
        self.settle = True
        self.t_start = time.perf_counter() - age_s
        self.times, self.calls, self.sleep = list(times), 0, sleep

    def chunk(self):
        time.sleep(self.sleep)
        self.calls += 1
        return self.times[min(self.calls, len(self.times)) - 1]


@pytest.mark.parametrize("pace", [0.5, 0.05, 5.0])
def test_settling_waits_for_the_process_s_own_turn(pace):
    """Slow chunks, then one 10% faster: settled after it, whatever the
    pace (no outside pace enters)."""
    from portbench import harness

    ctx = _Paced([pace] * 4 + [0.9 * pace])
    line = harness.settle(ctx, ctx.chunk)
    assert line.startswith("settled (turned)") and ctx.calls == 5


def test_settling_at_a_steady_pace_runs_to_the_cap():
    """A process that never turns (within 6%) settles until it is
    ``SETTLE_UNTIL_S`` old, fast or slow."""
    from portbench import harness

    ctx = _Paced([1.0, 0.97, 0.96, 1.0], age_s=harness.SETTLE_UNTIL_S - 0.1,
                 sleep=0.01)
    line = harness.settle(ctx, ctx.chunk)
    assert line.startswith("settled (capped)") and ctx.calls >= 4
    ctx.settle = False
    assert harness.settle(ctx, ctx.chunk) == "not settled"
