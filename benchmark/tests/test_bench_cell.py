"""A cell defined by data files alone runs through the harness, and its
comparison fails when the timed path is broken underneath or when the
float8 control answers in the program's place."""

import pytest

from benchmark.run import Cell, process_start_epoch, run_cell
from benchmark.tests.tiny import write_tiny_bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return write_tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny.hybrid", "tiny.vector"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_of_data_files_runs_and_is_correct(bench, workload, trace):
    cell = Cell.load(bench, workload)
    out = run_cell(cell, 2**33 + 1, 1.5, bool(trace), device="cpu", started=process_start_epoch())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # The CPU has no device kernels to read: those readers install and find nothing.
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)} - {"int4_scan_roofline"}
    assert want <= set(out["metrics"]), (want, out["metrics"])
    assert list(out)[-1] == "checks"


def _fault(kind):
    """A wrapper of the program's batch search that breaks its answers."""
    state = {}

    def wrap(original):
        def broken(queries, **kwargs):
            if kind == "half":  # half the batch left out: the rest's answers stand in
                head = original(queries[: max(1, len(queries) // 2)], **kwargs)
                return [head[i % len(head)] for i in range(len(queries))]
            results = original(queries, **kwargs)
            if kind == "stale":  # the state left unchanged: the previous call's answers again
                previous, state["last"] = state.get("last"), results
                if previous is not None and len(previous) == len(results):
                    return previous
                return results
            if kind == "altered":  # one answer altered where it is produced
                ids, scores = results[0]
                swap = next(f"bg-{i}" for i in range(7, 100) if f"bg-{i}" not in ids)
                return [([swap, *ids[1:]], scores), *results[1:]]
            raise AssertionError(kind)

        return broken

    return wrap


@pytest.mark.parametrize("workload", ["tiny.hybrid", "tiny.vector"])
@pytest.mark.parametrize("kind", ["half", "stale", "altered"])
def test_broken_timed_path_is_not_correct(bench, workload, kind, monkeypatch):
    from raglite_tpu_torch import search

    cell = Cell.load(bench, workload)
    name = "hybrid_search_batch" if workload == "tiny.hybrid" else "vector_search_batch"
    monkeypatch.setattr(search, name, _fault(kind)(getattr(search, name)))
    out = run_cell(cell, 2**33 + 2, 1.5, False, device="cpu", started=process_start_epoch())
    assert not out["correct"], out["checks"]


def test_a_dense_route_that_drops_its_best_hit_is_not_correct(bench, monkeypatch):
    """The fused path's dense side starting one rank late: the order holds
    and the fused scores still decompose, so the recall alone sees it."""
    from raglite_tpu_torch.index.dense import DenseIndex

    original = DenseIndex.search_chunks_device

    def late(self, queries, *, num_results, **kwargs):
        scores, ords = original(self, queries, num_results=num_results + 1, **kwargs)
        return scores[:, 1:].contiguous(), ords[:, 1:].contiguous()

    monkeypatch.setattr(DenseIndex, "search_chunks_device", late)
    out = run_cell(Cell.load(bench, "tiny.hybrid"), 2**33 + 3, 1.5, False, device="cpu", started=process_start_epoch())
    checks = out["checks"]
    assert not out["correct"], checks
    assert checks["recall_miss"]["value"] > checks["recall_miss"]["limit"], checks
    assert checks["rank_faults"]["value"] == 0 and checks["order_gap"]["value"] <= checks["order_gap"]["limit"], checks


@pytest.mark.parametrize("workload", ["tiny.hybrid", "tiny.vector"])
def test_the_float8_control_fails_and_the_reference_itself_passes(bench, workload):
    from benchmark.tools.control import control_readings

    cell = Cell.load(bench, workload)
    for seed in (5, 6, 7):
        control = control_readings(cell, seed, device="cpu", weights="fp8")
        assert any(c["value"] > c["limit"] for c in control.values()), control
    itself = control_readings(cell, 5, device="cpu", weights="served")
    assert itself["order_gap"]["value"] < 1e-9 and itself["rank_faults"]["value"] == 0


@pytest.mark.card
@pytest.mark.parametrize("workload", ["sem768.hybrid-b32", "sem768.vector-b32", "bgem3.vector-b32"])
def test_the_float8_control_fails_at_the_cells_size(card, workload):
    from benchmark.run import ROOT
    from benchmark.tools.control import control_readings

    cell = Cell.load(ROOT / "BENCHMARK.json", workload)
    for seed in (101, 102, 103):
        control = control_readings(cell, seed, device=card, weights="fp8")
        assert any(c["value"] > c["limit"] for c in control.values()), control
