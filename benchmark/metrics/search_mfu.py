"""The encoder's model FLOPs for every query answered in the window over
the window's seconds at the chip's bfloat16 peak, in per cent.  FLOPs are
counted from each query's real tokens (``rooflines/encoder_flops.py``), not padded
ones; the denominator is the bf16 dense peak, whatever precision the
program computes in."""

from benchmark.run import load_plugin


def read(ctx):
    flops = load_plugin("rooflines", "encoder_flops")
    peaks = load_plugin("rooflines", "peaks")
    dims = ctx.cell.config["model"]
    lo, hi = ctx.window
    total = 0.0
    for r in ctx.records:
        if r.error is None:
            total += sum(flops.query_flops(dims, ctx.tokens[p]) for p in r.positions(ctx.pool_size))
    if total <= 0:
        return None
    return 100.0 * total / ((hi - lo) * peaks.BF16_FLOPS)
