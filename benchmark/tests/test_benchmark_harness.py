"""The harness on the CPU: lookup by name, BENCHMARK.json against the
contract's shape, the whole-unit window, the trace reduction and the
metric readers on a synthetic trace, and the result line's keys."""

import json
import os
import re
import statistics

import pytest

from benchmark.harness import common, registry
from benchmark.harness.trace import Trace, breakdown, events_of, reduce_events

SPEC = registry.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_its_files():
    for cell in SPEC["workloads"]:
        cfg = registry.config(cell["config"])
        assert cfg["name"] == cell["config"]
        tr = registry.traffic(cell["traffic"])
        registry.runner(tr["runner"])
        assert registry.limits(cell["name"])
    for m in SPEC["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))
    for fam in ("swin", "knn"):
        assert registry.kernel_map(fam)["patterns"]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.workload(SPEC, "no-such-cell")
    for fn in (registry.config, registry.traffic, registry.limits, registry.metric_reader):
        with pytest.raises(FileNotFoundError):
            fn("no-such-name")


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in SPEC["configs"]]
    cells = [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(registry.ROOT, c["file"]))
        assert c["name"] in {w["config"] for w in SPEC["workloads"]}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert m["moves"] in {x["name"] for x in registry.metrics_of(SPEC, cell,
                                                                         "end_to_end")}
    for cell in cells:
        reported = [m["name"] for m in registry.metrics_of(SPEC, cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.metrics_of(SPEC, cell, "per_layer")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_whole_units_begin_before_the_deadline_and_end_complete():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731

    def step(i):
        now[0] += 2.5  # a unit takes 2.5 s

    units, window = common.whole_units(step, 10.0, clock=clock)
    assert units == 4 and window == 10.0  # the 4th begins at 7.5 s and ends at 10
    now[0] = 0.0
    units, window = common.whole_units(step, 9.0, clock=clock)
    assert units == 4 and window == 10.0  # begun at 7.5 < 9, it runs to its end
    assert common.p50([3.0, 1.0, 2.0]) == statistics.median([1.0, 2.0, 3.0])


# cuBLAS's and CUTLASS's own products, which run the model's layers outside
# A, B, C and D: their names hold `gemm_bf16` / `gemm_f32` and must not count
LIBRARY_GEMMS = ["sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas",
                 "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_cublas",
                 "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_64x64_nn>"
                 "(cutlass_80_tensorop_bf16_s16816gemm_bf16_64x64_nn::Params)",
                 "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x3_tn",
                 "void at::native::row_sqnorm_kernel<float>(float const*)"]


def _trace(extra=()):
    kernels = [("void scp::mlp_sm90<256>(CUtensorMap_st, int)", 0.0, 1.0),
               ("void scp::gemm_sm90<128, true>(CUtensorMap_st, int)", 0.5, 1.5),
               ("elementwise_kernel", 3.0, 4.0), ("void at::native::reduce_kernel<128, 4>", 6.0, 7.0)]
    kernels += [(name, 8.0 + 0.1 * i, 8.05 + 0.1 * i) for i, name in enumerate(extra)]
    host = [("bench.encode", 0.0, 5.0), ("bench.decode", 5.0, 10.0)]
    ops = [("aten::add", 1.6), ("cudaMemcpyAsync", 4.5), ("aten::topk", 8.0)]
    return Trace(kernels, host, ops, 10.0)


def test_trace_union_gaps_and_kernel_time():
    t = _trace()
    assert t.busy_s == pytest.approx(3.5)  # [0, 1.5] + [3, 4] + [6, 7]
    assert t.kernel_seconds(["mlp_sm90", "gemm_sm90"]) == pytest.approx(2.0)
    assert t.kernel_seconds(["no_such_kernel"]) is None
    gaps = dict(t.idle_gaps())
    assert gaps["bench.encode / aten::add"] == pytest.approx(1.5)
    assert gaps["bench.decode / aten::topk"] == pytest.approx(3.0)
    b = breakdown([t])
    assert set(b) == {"device_ops", "idle_gaps"} and len(b["device_ops"]) <= 10


def test_reduce_events_skips_annotations_and_other_cards():
    ev = [("bench.traced", False, -1, 1000, 11000), ("k1", True, 0, 2000, 3000),
          ("k2", True, 1, 2000, 3000), ("bench.encode", True, 0, 1000, 11000),
          ("aten::mm", False, -1, 1500, 1600)]
    t = reduce_events(ev, device_index=0)
    assert [k[0] for k in t.kernels] == ["k1"] and t.window_s == pytest.approx(1e-5)


class _Event:
    """A profiler event with only the methods every supported PyTorch has."""

    def __init__(self, name, cuda, start, end, annotation=False, method="is_user_annotation"):
        self._v = (name, cuda, start, end, annotation)
        if method:
            setattr(self, method, lambda: annotation if method == "is_user_annotation"
                    else ("gpu_user_annotation" if annotation else "kernel"))

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def device_index(self):
        return 0

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


@pytest.mark.parametrize("method", ["is_user_annotation", "activity_type", None])
def test_profiler_events_drop_annotations_whatever_the_release(method):
    ev = [_Event("bench.traced", False, 0, 10, True, method),
          _Event("void scp::mlp_sm90<256>(int)", True, 1, 2, False, method),
          _Event("phase1", True, 0, 10, True, method)]
    names = [x[0] for x in events_of(ev)]
    assert "void scp::mlp_sm90<256>(int)" in names and "bench.traced" in names
    assert ("phase1" in names) == (method is None)


def _record(**kw):
    rec = {"window_s": 10.0, "chips": 1, "spans": {"encode": [1.0, 3.0, 2.0]},
           "products": {"flops": 989e12}, "traces": [_trace()],
           "traced_products": {"swin": [(989e9, 0.0)], "knn": [(1.0, 1.0)]},
           "memory_peak_bytes": 2 ** 31}
    rec.update(kw)
    return rec


def test_readers_on_a_synthetic_trace():
    read = registry.metric_reader
    assert read("encode_ms.p50")(_record()) == pytest.approx(2000.0)
    assert read("preprocess_ms.p50")(_record()) is None
    assert read("mfu.sweeps")(_record()) == pytest.approx(10.0)
    # A, B and C's least time 1 ms over their 2 s of kernels
    assert read("roofline.swin.sweeps")(_record()) == pytest.approx(0.05)
    # no kernel of D in the trace: the metric is absent, never 0
    assert read("roofline.knn.sweeps")(_record()) is None
    assert read("roofline.swin.sweeps")(_record(traces=None)) is None
    assert read("idle_share.sweeps")(_record()) == pytest.approx(0.65)
    assert read("peak_mem_gib.train")(_record()) == pytest.approx(2.0)


def test_kernel_maps_take_the_ports_kernels_and_no_library_gemm():
    swin = registry.kernel_map("swin")["patterns"]
    knn = registry.kernel_map("knn")["patterns"]
    ports = {"swin": ["void scp::mlp_sm90<256>(CUtensorMap_st, CUtensorMap_st, int)",
                      "void scp::gemm_sm90<128, true>(CUtensorMap_st, int)",
                      "void scp::attn_core_bf16<64, 1>(scp::AttnArgs)",
                      "scp::attn_core_f32(scp::AttnArgs)",
                      "void scp::gemm_bf16<true>(__nv_bfloat16 const*, int)",
                      "void scp::gemm_f32<false>(float const*, int)"],
             "knn": ["void (anonymous namespace)::knn_topk_wide<__nv_bfloat16, 1>(long*)",
                     "void (anonymous namespace)::knn_topk_pruned<4>(float const*, long*)",
                     "void (anonymous namespace)::knn_topk_boxes<float, 3>(float const*)",
                     "void (anonymous namespace)::row_sqnorm<__nv_bfloat16>(float*, int)"]}
    for fam, pats in (("swin", swin), ("knn", knn)):
        for name in ports[fam]:
            assert Trace([(name, 0.0, 1.0)], [], [], 1.0).kernel_seconds(pats) == 1.0, name
        for name in LIBRARY_GEMMS + ports["knn" if fam == "swin" else "swin"]:
            assert Trace([(name, 0.0, 1.0)], [], [], 1.0).kernel_seconds(pats) is None, name
    # the library's products beside A, B and C leave the roofline as it was
    read = registry.metric_reader("roofline.swin.sweeps")
    assert read(_record(traces=[_trace(LIBRARY_GEMMS)])) == pytest.approx(0.05)


def test_result_line_keys():
    line = json.loads(common.result_line(True, 3, 0, {"bpp": common.metric(18.4, "bits/pt")},
                                         {"platform": "gpu"}, [("decode_diff", 0, 0)]))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["checks"] == {"decode_diff": {"value": 0, "limit": 0}}
    assert common.passes([("a", 0.1, 0.2)]) and not common.passes([("a", None, 1.0)])
    assert not common.passes([("a", float("nan"), 1.0)])
    assert common.forbidden_loaded(["scp_tpu_torch.codec", "numpy"]) == []
    assert common.forbidden_loaded(["scp_tpu.codec", "jax.numpy"]) == ["jax", "scp_tpu"]
