"""Export a trained npz encoder checkpoint to the HF safetensors layout
(counterpart of scripts/export_hf_encoder.py).

Turns a directory (or .npz file) written by ``save_npz_encoder`` into an
HF-layout directory (``model.safetensors`` at f16, ``config.json``,
``tokenizer.json``) that ``load_safetensors_encoder`` reads, so that
``flax:<dir>`` serves it as it serves a BERT-family checkpoint.  Runs on
the host: the weights only pass through f16.

Usage:
  python -m raglite_tpu_torch.train.export_hf --src data/encoder_train_large/maxsim.npz \\
      --tokenizer data/encoder_train_large/tokenizer.json \\
      --out data/encoder_train_large/export_hf
"""

from __future__ import annotations

import argparse
import os

import torch

from raglite_tpu_torch.models.transformer import EncoderModel, load_npz_encoder, save_hf_encoder


def export(src: str, out: str, tokenizer: str | None = None) -> str:
    """Write ``src``'s encoder to ``out``; the tokenizer defaults to the
    ``tokenizer.json`` beside the npz.  Returns the npz path read."""
    if os.path.isdir(src):
        src = os.path.join(src, "encoder.npz")
    tok = tokenizer or os.path.join(os.path.dirname(src), "tokenizer.json")
    cfg, params, _ = load_npz_encoder(src)
    model = EncoderModel.from_params(cfg, params, dtype=torch.float16, device="cpu")
    save_hf_encoder(out, model, tokenizer_json=tok)
    return src


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", required=True, help="npz checkpoint (file or dir with encoder.npz)")
    parser.add_argument("--tokenizer", default=None, help="tokenizer.json (default: next to src)")
    parser.add_argument("--out", required=True, help="output HF-layout directory")
    args = parser.parse_args(argv)
    src = export(args.src, args.out, args.tokenizer)
    size = os.path.getsize(os.path.join(args.out, "model.safetensors")) / 1e6
    print(f"exported {src} -> {args.out} ({size:.1f} MB model.safetensors)")


if __name__ == "__main__":
    main()
