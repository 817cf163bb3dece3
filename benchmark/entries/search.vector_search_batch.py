"""``search.vector_search_batch``: a request is a batch of queries,
answered by the dense route alone."""

from benchmark.entries._batch import batch_entry

ANSWER = "vector"
BATCH = "raglite_tpu_torch.search:vector_search_batch"


def make(traffic, config):
    return batch_entry("vector_search_batch", traffic, config)
