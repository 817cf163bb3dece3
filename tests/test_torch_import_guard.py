"""The PyTorch port stands alone: importing it (the retrieval modules, the
keyword index with its native loader, BM25 and RRF ops, deletes, the
decoder LLM, speculation, the grammar automata, the hash table draw, the
LLM factory, rag, the attention ops, extraction, evals, the query adapter
and its NNLS op, the safetensors and checkpoint readers and the int8
matmuls) loads neither JAX nor the JAX package (nor markdown-it,
tokenizers, safetensors, transformers, orbax, tensorstore, msgpack or
filelock on the in-memory path, a tokenizer.json read included, nor pandas,
tqdm or pydantic), its public names are the JAX package's, its config asks for the
card by default,
and asking for the card where there is none raises instead of running on
the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_defaults_to_cuda() -> None:
    code = textwrap.dedent(
        """
        import sys
        import raglite_tpu_torch
        import raglite_tpu_torch.index.dense, raglite_tpu_torch.models.encoder
        import raglite_tpu_torch.ops.cuda_build, raglite_tpu_torch.search
        import raglite_tpu_torch.models.decoder, raglite_tpu_torch.models.speculative
        import raglite_tpu_torch.models.llm, raglite_tpu_torch.rag
        import raglite_tpu_torch.ops.decode_attention, raglite_tpu_torch.ops.prefill_attention
        import raglite_tpu_torch.native, raglite_tpu_torch.index.keyword, raglite_tpu_torch.delete
        import raglite_tpu_torch.ops.bm25, raglite_tpu_torch.ops.rrf
        import raglite_tpu_torch.models.json_automaton, raglite_tpu_torch.models.schema_automaton
        import raglite_tpu_torch.models.hash_table
        import raglite_tpu_torch.extract, raglite_tpu_torch.evals, raglite_tpu_torch.query_adapter
        import raglite_tpu_torch.ops.nnls
        import raglite_tpu_torch.models.safetensors_io, raglite_tpu_torch.models.checkpoint
        import raglite_tpu_torch.ops.quant_matmul, raglite_tpu_torch.models.transformer
        assert "pydantic" not in sys.modules
        bad = [
            m for m in sys.modules
            if m in ("jax", "raglite_tpu") or m.startswith(("jax.", "raglite_tpu."))
        ]
        assert not bad, bad
        assert raglite_tpu_torch.RAGLiteConfig().device == "cuda"
        # The host path needs none of the packages the card's machine may
        # lack: Markdown blocks and BPE ids are first-party, and a ":memory:"
        # store touches no persistence code.
        from raglite_tpu_torch.models.encoder import PACKAGED_ENCODER_DIR
        from raglite_tpu_torch.models.tokenizer import load_tokenizer
        from raglite_tpu_torch.store import Store
        from raglite_tpu_torch.utils.mdparse import parse_markdown
        assert [t.type for t in parse_markdown("# x\\n\\n- y\\n")][:2] == ["heading_open", "bullet_list_open"]
        assert load_tokenizer(str(PACKAGED_ENCODER_DIR / "tokenizer.json")).encode("x")
        Store(":memory:").save()
        extra = {
            "markdown_it", "tokenizers", "msgpack", "filelock", "safetensors", "transformers", "orbax",
            "tensorstore",
        } & {m.split(".")[0] for m in sys.modules}
        assert not extra, extra
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cuda_without_a_gpu_raises(monkeypatch: pytest.MonkeyPatch) -> None:
    from raglite_tpu_torch import RAGLiteConfig
    from raglite_tpu_torch.search import vector_search

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = RAGLiteConfig(store_path=":memory:", embedder="flax:tiny", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vector_search("anything", config=config)


def test_multi_gpu_is_not_ported_yet() -> None:
    from raglite_tpu_torch import RAGLiteConfig

    with pytest.raises(NotImplementedError):
        RAGLiteConfig(num_devices=2)


def test_kernel_sources_build_for_sm90a() -> None:
    """The build module compiles every csrc/*.cu for sm_90a (the command
    only: there is no nvcc here)."""
    from raglite_tpu_torch.ops import cuda_build

    sources = {p.stem for p in cuda_build.CSRC.glob("*.cu")}
    assert sources == set(cuda_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_import_loads_no_pandas_tqdm_or_pydantic() -> None:
    """Beyond what torch itself imports, ``import raglite_tpu_torch`` (and
    its evals, adapter and NNLS modules) loads none of pandas, tqdm and
    pydantic, which the card's machine may lack."""
    code = textwrap.dedent(
        """
        import sys
        import torch
        before = set(sys.modules)
        import raglite_tpu_torch
        import raglite_tpu_torch.evals, raglite_tpu_torch.query_adapter, raglite_tpu_torch.ops.nnls
        new = {m.split(".")[0] for m in set(sys.modules) - before}
        bad = new & {"pandas", "tqdm", "pydantic", "jax", "raglite_tpu"}
        assert not bad, bad
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_public_api_equals_the_jax_packages() -> None:
    """``raglite_tpu_torch.__all__`` names what ``raglite_tpu.__all__``
    names, and every name resolves."""
    import raglite_tpu

    import raglite_tpu_torch

    assert set(raglite_tpu_torch.__all__) == set(raglite_tpu.__all__)
    assert all(getattr(raglite_tpu_torch, name) is not None for name in raglite_tpu_torch.__all__)
