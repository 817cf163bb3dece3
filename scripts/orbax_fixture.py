"""Write ``tests/data/orbax_tiny/``: a small decoder checkpoint saved by the
JAX package (orbax over tensorstore: OCDBT, zarr v2 chunks as compressed
zstd frames), which the port's ``ckpt:`` reader is held to on the CPU
(tests/test_torch_checkpoint.py) and on the card (chip_smoke.py, phase 10
(f)), where neither tensorstore nor orbax is installed.

The config's vocabulary covers the byte tokenizer (259 ids), its two
embedding leaves are over 128 KiB (more than one zstd block each), and the
norm leaves (f32 ones) compress.  The weights are drawn by
``raglite_tpu.models.decoder.init_decoder_params`` from ``SEED`` in bf16,
so the test can draw them again and hold the fixture to them.

Usage (needs jax, orbax and tensorstore):
  JAX_PLATFORMS=cpu python scripts/orbax_fixture.py [--out tests/data/orbax_tiny]
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONFIG = dict(layers=1, d_model=64, heads=2, kv_heads=1, d_ff=96, vocab=1032, max_len=256)
SEED = 11


def fixture_params():
    """The fixture's parameter tree, drawn by the JAX package."""
    import jax.numpy as jnp

    from raglite_tpu.models.decoder import init_decoder_params

    return init_decoder_params(CONFIG, seed=SEED, dtype=jnp.bfloat16)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "tests" / "data" / "orbax_tiny"))
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from raglite_tpu.models.checkpoint import save_checkpoint

    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    save_checkpoint(out, fixture_params(), CONFIG)
    size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out} ({size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
