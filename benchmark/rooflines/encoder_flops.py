"""Model FLOPs of one query through a post-LN transformer encoder, from its
real tokens T: 2 x (matmul parameters) x T for the linear layers (4 d^2 +
2 d d_ff a layer), plus attention's 4 T^2 d a layer (scores and the
weighted sum).  Embeddings, LayerNorms, softmax and pooling are left out."""


def query_flops(model: dict, tokens: int) -> float:
    d, ff, layers = int(model["d_model"]), int(model["d_ff"]), int(model["layers"])
    matmul_params = layers * (4 * d * d + 2 * d * ff)
    return 2.0 * matmul_params * tokens + layers * 4.0 * tokens * tokens * d
