"""Set-up: from process start to the first timed request (host clock)."""


def read(ctx):
    return ctx.setup_s
