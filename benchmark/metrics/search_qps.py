"""Every query answered in the window over the window's seconds."""


def read(ctx):
    lo, hi = ctx.window
    answered = sum(r.count for r in ctx.records if r.error is None)
    return answered / (hi - lo)
