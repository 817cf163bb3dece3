"""The roofline and FLOP arithmetic the per-layer metrics divide by."""

import pytest

from benchmark.run import load_plugin


def test_int4_bytes_reproduce_the_kernel_table_bounds():
    scan, peaks = load_plugin("rooflines", "int4_scan"), load_plugin("rooflines", "peaks")
    ms = lambda d: scan.call_bytes(1_249_280, d, 1) / peaks.HBM_BYTES_PER_S * 1e3  # noqa: E731
    assert round(ms(768), 4) == 0.1462
    assert round(ms(1024), 4) == 0.1939
    assert scan.scanned_rows(1_249_281) == 1_253_376


def test_int4_kernel_names():
    scan = load_plugin("rooflines", "int4_scan")
    assert scan.is_launch("void rlt::mma_scan_kernel<true, 4>(unsigned char const*)")
    assert not scan.is_launch("void rlt::mma_scan_kernel<false, 4>(unsigned char const*)")
    assert scan.is_call_kernel("void rlt::merge_splits_kernel(float const*)")


@pytest.mark.parametrize(("model", "params"), [
    ({"layers": 8, "d_model": 768, "d_ff": 3072}, 56_623_104),
    ({"layers": 24, "d_model": 1024, "d_ff": 4096}, 301_989_888),
])
def test_encoder_flops_count_matmul_params_and_attention(model, params):
    flops = load_plugin("rooflines", "encoder_flops")
    t = 27
    assert flops.query_flops(model, t) == 2 * params * t + model["layers"] * 4 * t * t * model["d_model"]


def test_int4_scan_roofline_reads_the_trace_and_the_entrys_batch_calls():
    """Two scans of a B 32 batch call each, at twice their bound: 50 %."""
    from types import SimpleNamespace

    from benchmark.run import Cell, Context
    from benchmark.spans import Spans

    scan, peaks = load_plugin("rooflines", "int4_scan"), load_plugin("rooflines", "peaks")
    entry = load_plugin("entries", "search.vector_search_batch")
    corpus = {"chunks": 624_640, "rows_per_chunk": 2, "dim": 768}
    cell = Cell("x", 1, {"corpus": corpus}, {"entry": "search.vector_search_batch"}, {}, [], [])
    spans = Spans()
    spans.records[entry.BATCH] = [(0.1, 0.2, 32), (0.3, 0.4, 32)]
    bound_s = 2 * scan.call_bytes(1_249_280, 768, 32) / peaks.HBM_BYTES_PER_S
    launch = "void rlt::mma_scan_kernel<true, 4>(unsigned char const*)"
    trace = SimpleNamespace(by_name={launch: 1.5 * bound_s, "void rlt::merge_splits_kernel(float const*)": 0.5 * bound_s,
                                     "gemm": 1.0}, counts={launch: 2})
    ctx = Context(cell, (0.0, 1.0), [], {}, spans, 1, trace=trace, entry=entry)
    ctx.extra["trace_window"] = (0.0, 1.0)
    assert load_plugin("metrics", "int4_scan_roofline").read(ctx) == pytest.approx(50.0)
