"""Share of its roofline that the stage-1 int4 scan reaches, in per cent:
the bytes its calls in the traced window must move at 3.35 TB/s
(``rooflines/int4_scan.py``), over the device time of its kernels there
(device_trace).  The batch of each call is the mean batch of the cell's
batch calls (the entry's ``BATCH``) in the traced window (one scan each)."""

from benchmark.run import load_plugin


def install(ctx):
    ctx.spans.span(ctx.entry.BATCH)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    scan = load_plugin("rooflines", "int4_scan")
    peaks = load_plugin("rooflines", "peaks")
    kernel_s = sum(s for n, s in t.by_name.items() if scan.is_call_kernel(n))
    launches = sum(c for n, c in t.counts.items() if scan.is_launch(n))
    calls = ctx.spans.within(ctx.entry.BATCH, *ctx.extra["trace_window"])
    if kernel_s <= 0 or not launches or not calls:
        return None
    batch = sum(n for _, _, n in calls) / len(calls)
    corpus = ctx.cell.config["corpus"]
    rows = int(corpus["chunks"]) * int(corpus["rows_per_chunk"])
    bound_s = launches * scan.call_bytes(rows, int(corpus["dim"]), batch) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / kernel_s
