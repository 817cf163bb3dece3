"""``search.hybrid_search_batch``: a request is a batch of queries,
answered by the dense route and BM25 fused by RRF."""

from benchmark.entries._batch import batch_entry

ANSWER = "hybrid"
BATCH = "raglite_tpu_torch.search:hybrid_search_batch"


def make(traffic, config):
    return batch_entry("hybrid_search_batch", traffic, config)
