"""The metric readers' arithmetic on synthetic runs."""

import math
import statistics
import types

from qsbench import registry, trace


def _run(latencies_ms, seconds=2.0, **extra):
    records, t = [], 0.0
    for ms in latencies_ms:
        records.append({"query": "q1", "start": t, "end": t + ms / 1e3,
                        "rows": []})
        t += ms / 1e3
    run = types.SimpleNamespace(seconds=seconds, window=(0.0, seconds),
                                records=records, setup_s=12.5,
                                enforcer_ms=[], spans=None, busy_s=None,
                                window_s=None, device_kind=None, **extra)
    run.completed = lambda: [r for r in records if r["end"] <= seconds]
    run.latencies_ms = lambda: [(r["end"] - r["start"]) * 1e3
                                for r in run.completed()]
    return run


def test_qps_counts_what_completed_in_the_window():
    run = _run([125.0] * 20)          # 2.5 s of queries in a 2 s window
    assert registry.reader("qps")(run) == 16 / 2.0


def test_p95_is_over_every_query():
    lat = [float(i) for i in range(1, 101)]
    run = _run(lat, seconds=1000.0)
    want = statistics.quantiles(lat, n=20, method="inclusive")[18]
    assert math.isclose(registry.reader("p95_ms")(run), want, rel_tol=1e-9)
    assert 95.0 <= want <= 96.0
    assert registry.reader("p95_ms")(_run([5.0])) is None


def test_geometric_mean():
    run = _run([1.0, 10.0, 100.0], seconds=10.0)
    assert math.isclose(registry.reader("geomean_ms")(run), 10.0)


def test_setup_is_the_runs_own():
    assert registry.reader("setup_s")(_run([1.0])) == 12.5


def test_admit_wait_is_latency_less_execution():
    run = _run([10.0, 30.0], seconds=10.0)
    run.enforcer_ms = [4.0, 6.0]
    assert math.isclose(registry.reader("admit_wait_ms")(run), 15.0)
    run.enforcer_ms = []
    assert registry.reader("admit_wait_ms")(run) is None


def test_roofline_bytes_come_from_the_sql_and_the_config_file():
    bench = registry.benchmark()
    config = registry.config(bench, "tpch-sf10")
    mod = registry.reader("roofline_share").__globals__
    rows = {"lineitem": 1000, "orders": 100, "part": 10, "supplier": 5,
            "partsupp": 40, "customer": 20, "nation": 25, "region": 5}
    q6 = registry.queries("tpch-sf10")["q6"]
    # l_extendedprice, l_discount, l_quantity (DECIMAL(15,2): 8 bytes) and
    # l_shipdate (4)
    assert mod["query_bytes"](q6, config["column_bytes"], rows) == 28 * 1000
    q21 = registry.queries("tpch-sf10")["q21"]
    # s_suppkey, s_name, s_nationkey; l_suppkey, l_orderkey, l_receiptdate,
    # l_commitdate once though three aliases read them; o_orderkey,
    # o_orderstatus; n_nationkey, n_name
    want = 4 * (3 * 5 + 4 * 1000 + 2 * 100 + 2 * 25)
    assert mod["query_bytes"](q21, config["column_bytes"], rows) == want
    run = _run([100.0] * 10, seconds=1.0, config=config, table_rows=rows,
               queries={"q1": q6},
               peaks={"devices": {"H100": {"hbm_bytes_per_s": 1e6}}})
    run.busy_s, run.device_kind = 0.5, "NVIDIA H100 80GB HBM3"
    share = registry.reader("roofline_share")(run)
    assert math.isclose(share, 100.0 * 10 * 28000 / 1e6 / 0.5)
    run.device_kind = "cpu"
    assert registry.reader("roofline_share")(run) is None


def test_device_idle_share():
    run = _run([1.0])
    assert registry.reader("device_idle_share")(run) is None
    run.busy_s, run.window_s = 1.5, 2.0
    assert math.isclose(registry.reader("device_idle_share")(run), 25.0)


def test_busy_is_the_union_and_gaps_the_rest():
    ns = 10**9
    intervals = [(0, 2, "a"), (1, 3, "b"), (5, 6, "a"), (8, 12, "c")]
    covered, gaps = trace.busy(intervals, 0, 10)
    assert covered == 6 / ns
    assert gaps == [(3, 5), (6, 8)]
    covered, gaps = trace.busy(intervals, 4, 20)
    assert covered == 5 / ns and gaps == [(4, 5), (6, 8), (12, 20)]


def test_breakdown_names_ops_and_labels_gaps():
    spans = trace.Spans({"q7": "select 7"})
    spans.items = [(1, "statement", 0, 80), (1, "run_plan", 10, 78),
                   (1, "materialise", 60, 78)]
    spans.executions = [{"start": 0, "end": 80, "query": "q7",
                         "stream": None}]
    intervals = [(0, 10, "k1"), (20, 50, "k2"), (55, 60, "k1")]
    _, gaps = trace.busy(intervals, 0, 120)
    b = trace.breakdown(intervals, gaps, spans)
    assert b["device_ops"] == [["k2", 30e-9], ["k1", 15e-9]]
    assert b["idle_gaps"][0] == ["no statement", 60e-9]
    assert ["q7 run_plan", 10e-9] in b["idle_gaps"]


def test_plan_and_upload_from_spans():
    spans = trace.Spans()
    ns = 10**9
    spans.items = [(1, "parse", 0, ns // 1000), (2, "plan", ns // 100,
                                                 ns // 100 + ns // 500),
                   (2, "plan", 3 * ns, 3 * ns + 5)]
    spans.executions = [
        {"start": 0, "end": ns // 2, "query": "q1",
         "stream": {"per_segment": [{"upload_s": 0.1}, {"upload_s": 0.3}]}},
        {"start": ns, "end": 2 * ns, "query": "q2", "stream": None}]
    run = _run([1.0])
    run.spans = spans
    # one plan in the window: 1 ms of parse and 2 ms of plan
    assert math.isclose(registry.reader("plan_ms")(run), 3.0)
    assert math.isclose(registry.reader("upload_share")(run), 80.0)


def test_kernel_time_per_stream_averages_each_query_over_its_runs():
    ns = 10**9
    run = _run([1.0])
    run.orders = [["q1", "q2"]]
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.records = [
        {"query": "q1", "start": 0.0, "end": 1.0, "rows": []},
        {"query": "q2", "start": 1.0, "end": 2.0, "rows": []},
        {"query": "q1", "start": 2.0, "end": 3.0, "rows": []},
        {"query": "q2", "start": 3.0, "end": 4.0, "error": "E"}]
    run.intervals = [
        (0, ns // 10, "k"), (ns // 20, ns // 5, "k"),      # q1: 200 ms
        (ns // 2, ns, "Memcpy HtoD (Pageable -> Device)"),  # host copy
        (ns + ns // 10, ns + ns // 2, "k"),                 # q2: 400 ms
        (2 * ns, 2 * ns + ns // 10, "Memset (Device)"),     # q1: 100 ms
        # after the last query's call: its own, however late it ran
        (3 * ns + ns // 2, 3 * ns + ns // 2 + ns // 5, "k")]
    read = registry.reader("kernel_ms_per_stream")
    # q1: (200 + 100 + 200 after the failed call) / 2, q2: 400
    assert math.isclose(read(run), 250.0 + 400.0)
    run.orders = [["q1", "q2", "q3"]]
    assert read(run) is None              # q3 never ran
    run.orders = [["q1"], ["q2"]]
    assert read(run) is None              # two sessions share the card
    run.orders, run.device_kind = [["q1", "q2"]], None
    assert read(run) is None              # no card


def test_host_readings_of_a_device_cell_are_qps_and_geomean():
    run = _run([1.0, 10.0, 100.0], seconds=10.0)
    assert registry.reader("qps.host")(run) == registry.reader("qps")(run)
    assert math.isclose(registry.reader("geomean_ms.host")(run), 10.0)
    run.busy_s, run.device_kind = 0.5, None
    run.peaks = {"devices": {"H100": {"hbm_bytes_per_s": 1e6}}}
    assert registry.reader("roofline_share.tput")(run) is None
