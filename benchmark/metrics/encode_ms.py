"""Mean milliseconds of the query encode a search call makes
(``embed_queries`` as the search module calls it; it ends with the host
fetch of the embeddings) (program_span)."""

TARGET = "raglite_tpu_torch.search:embed_queries"


def install(ctx):
    ctx.spans.span(TARGET)


def read(ctx):
    return ctx.spans.mean_ms(TARGET, *ctx.window)
