"""Mean milliseconds of the batch calls an offline client makes (the
entry's ``BATCH``, such as ``vector_search_batch``), from call to results
on the host (program_span)."""


def install(ctx):
    ctx.spans.span(ctx.entry.BATCH)


def read(ctx):
    return ctx.spans.mean_ms(ctx.entry.BATCH, *ctx.window)
