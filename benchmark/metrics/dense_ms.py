"""Mean milliseconds of a dense index search
(``DenseIndex.search_chunks``: the int4 two-stage route and its one host
fetch) (program_span)."""

TARGET = "raglite_tpu_torch.index.dense:DenseIndex.search_chunks"


def install(ctx):
    ctx.spans.span(TARGET)


def read(ctx):
    return ctx.spans.mean_ms(TARGET, *ctx.window)
