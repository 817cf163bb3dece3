"""Search across processes (raglite_tpu_torch/parallel/: ``distributed_init``
and the ``group=`` merge of the sharded searches), the counterpart of
tests/test_multihost.py: two real processes, each holding 4 of the 8 row
shards of one global index (no process holds the whole matrix), joined by
a gloo process group over loopback.  Each process merges its own shards,
then the ranks' ``[B, k]`` winners cross and merge; rank 0 writes the
result.  It must equal the single-process 8-shard search (ids equal, scores
equal: the same f32 sums, and the winners cross as f64) and the JAX
package's ``sharded_topk_search`` on its 8-device mesh (ids equal, scores
rtol 1e-5), and hold the exact top-k.  Each worker has its own time limit.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
N, D, B, K, SHARDS, L = 1024, 64, 4, 8, 8, 64

#: One rank: its 4 local shards of the seeded global matrix, both sharded
#: searches with the process group, rank 0 saving the merged result.
WORKER = textwrap.dedent(
    f"""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from raglite_tpu_torch.ops.fused_scan import pack_rows_int4, quantize_rows_int8
    from raglite_tpu_torch.parallel.mesh import distributed_init
    from raglite_tpu_torch.parallel.sharded import sharded_int4_two_stage, sharded_topk_search

    rank, coordinator, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    distributed_init(coordinator, 2, rank, backend="gloo")
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    rng = np.random.default_rng(0)
    rows = rng.normal(size=({N}, {D})).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = torch.from_numpy(rng.normal(size=({B}, {D})).astype(np.float32))
    local = {SHARDS} // 2
    per_shard = {N} // {SHARDS}
    devices = [torch.device("cpu")] * local
    mine = [torch.from_numpy(rows[(rank * local + s) * per_shard : (rank * local + s + 1) * per_shard]) for s in range(local)]
    zeros = [torch.zeros(per_shard) for _ in range(local)]
    ones = [torch.ones(per_shard, dtype=torch.bool) for _ in range(local)]
    group = dist.group.WORLD
    s1, i1 = sharded_topk_search(mine, zeros, ones, queries, None, num_hits={K}, metric="cosine", devices=devices, group=group)
    q8 = [quantize_rows_int8(m) for m in mine]
    p4 = [pack_rows_int4(r, sc) for r, sc in q8]
    s2, i2 = sharded_int4_two_stage(
        [p for p, _ in p4], [s for _, s in p4], [r for r, _ in q8], [sc for _, sc in q8], zeros, ones, queries,
        num_hits={K}, candidates=32, metric="cosine", devices=devices, num_buckets={L}, group=group,
    )
    if rank == 0:
        np.savez(out, s1=s1.numpy(), i1=i1.numpy(), s2=s2.numpy(), i2=i2.numpy())
    dist.destroy_process_group()
    print(f"RANK{{rank}} OK", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_dcn_sharded_search(tmp_path) -> None:
    import jax
    import jax.numpy as jnp

    from raglite_tpu.parallel.mesh import index_mesh, row_sharding
    from raglite_tpu.parallel.sharded import sharded_topk_search as jsharded
    from raglite_tpu_torch.ops.fused_scan import pack_rows_int4, quantize_rows_int8
    from raglite_tpu_torch.parallel.mesh import split_rows
    from raglite_tpu_torch.parallel.sharded import sharded_int4_two_stage, sharded_topk_search

    out = tmp_path / "result.npz"
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(rank), coordinator, str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for rank in (0, 1)
    ]
    try:
        for rank, proc in enumerate(procs):
            stdout, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, stdout[-2000:]
            assert f"RANK{rank} OK" in stdout
    finally:
        for proc in procs:
            proc.kill()
    got = np.load(out)

    # The same global data in one process: 8 shards, no group.
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rng.normal(size=(B, D)).astype(np.float32)
    devices = [torch.device("cpu")] * SHARDS
    t_rows, q = torch.from_numpy(rows), torch.from_numpy(queries)
    s1, i1 = sharded_topk_search(
        *(split_rows(x, devices) for x in (t_rows, torch.zeros(N), torch.ones(N, dtype=torch.bool))), q, None,
        num_hits=K, metric="cosine", devices=devices,
    )
    np.testing.assert_array_equal(got["i1"], i1.numpy())
    np.testing.assert_array_equal(got["s1"], s1.numpy())
    rows8, scale8 = quantize_rows_int8(t_rows)
    packed, scale4 = pack_rows_int4(rows8, scale8)
    s2, i2 = sharded_int4_two_stage(
        *(split_rows(x, devices) for x in (packed, scale4, rows8, scale8, torch.zeros(N), torch.ones(N, dtype=torch.bool))),
        q, num_hits=K, candidates=32, metric="cosine", devices=devices, num_buckets=L,
    )
    np.testing.assert_array_equal(got["i2"], i2.numpy())
    np.testing.assert_array_equal(got["s2"], s2.numpy())

    # The JAX package's sharded search on its 8-device mesh, and the exact oracle.
    mesh = index_mesh(SHARDS)
    one_d = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    js, ji = jsharded(
        jax.device_put(jnp.asarray(rows), row_sharding(mesh)), jax.device_put(jnp.zeros((N,), jnp.float32), one_d),
        jax.device_put(jnp.ones((N,), jnp.bool_), one_d), jnp.asarray(queries), None,
        num_hits=K, metric="cosine", mesh=mesh,
    )
    np.testing.assert_array_equal(got["i1"], np.asarray(ji))
    np.testing.assert_allclose(got["s1"], np.asarray(js), rtol=1e-5)
    oracle = np.argsort(-(rows @ queries.T), axis=0, kind="stable")[:K].T
    np.testing.assert_array_equal(np.sort(got["i1"], axis=1), np.sort(oracle, axis=1))
    assert (np.diff(got["s1"], axis=1) <= 0).all()
