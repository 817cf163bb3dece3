"""Training on the card: the counterparts of the JAX package's trainers in
``scripts/`` (``corpus``, ``encoder``, ``boundary``) and the ``optax``
pieces they use (``optim``).  Each trainer is ``python -m
raglite_tpu_torch.train.<name>``; nothing here imports JAX, optax or
``tokenizers``."""
