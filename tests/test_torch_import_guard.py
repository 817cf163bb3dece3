"""The PyTorch port stands alone: importing it (the retrieval modules, the
keyword index with its native loader, BM25 and RRF ops, deletes, the
decoder LLM, speculation, the grammar automata, the hash table draw, the
LLM factory, rag, the attention ops, extraction, evals, the query adapter
and its NNLS op, the safetensors and checkpoint readers (OCDBT and zstd
included), the int8
matmuls, the document converters, the boundary model, the tracer, the
micro-batcher, the MCP server, the web chat, the CLI, the multi-GPU
modules, the IR benchmark with its HNSW baseline, the tokenizer's
Unicode tables, the trainers with their optimizer and corpus, the HF
export and the store-scale run) loads
neither JAX
nor the JAX package nor click (nor markdown-it,
tokenizers, optax, safetensors, transformers, orbax, tensorstore, msgpack or
filelock on the in-memory path, a tokenizer.json read included, nor pandas,
tqdm or pydantic), its public names are the JAX package's, its config asks for the
card by default,
and asking for the card where there is none raises instead of running on
the CPU."""

import json
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
        import raglite_tpu_torch.models.ocdbt
        import raglite_tpu_torch.ops.quant_matmul, raglite_tpu_torch.models.transformer
        import raglite_tpu_torch.markdown, raglite_tpu_torch.utils.pdf, raglite_tpu_torch.utils.office
        import raglite_tpu_torch.models.boundary, raglite_tpu_torch.models.boundary_data
        import raglite_tpu_torch.utils.trace, raglite_tpu_torch.utils.microbatch
        import raglite_tpu_torch.mcp, raglite_tpu_torch.webchat, raglite_tpu_torch.cli
        import raglite_tpu_torch.__main__
        import raglite_tpu_torch.parallel.mesh, raglite_tpu_torch.parallel.sharded
        import raglite_tpu_torch.parallel.tp_decoder
        import raglite_tpu_torch.irbench, raglite_tpu_torch.models.unicode_props
        import raglite_tpu_torch.train.optim, raglite_tpu_torch.train.corpus
        import raglite_tpu_torch.train.encoder, raglite_tpu_torch.train.boundary
        import raglite_tpu_torch.train.export_hf, raglite_tpu_torch.store_scale
        import raglite_tpu_torch.train.bpe, raglite_tpu_torch.train.semantic_ir_bench
        assert "pydantic" not in sys.modules
        assert "pandas" not in sys.modules
        assert "click" not in sys.modules
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
            "markdown_it", "tokenizers", "optax", "msgpack", "filelock", "safetensors", "transformers", "orbax",
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


def test_ckpt_load_leaves_storage_packages_unloaded(tmp_path) -> None:
    """A ``ckpt:`` load of the committed orbax fixture (compressed zstd
    frames in OCDBT) and a save and load of the port's own leave
    tensorstore, ml_dtypes, zstandard, orbax and JAX unloaded: the card's
    machine has none of them."""
    code = textwrap.dedent(
        f"""
        import sys
        from raglite_tpu_torch.models.decoder import TorchChatLLM
        llm = TorchChatLLM("ckpt:tests/data/orbax_tiny", device="cpu")
        llm.save_checkpoint({str(tmp_path / "ck")!r})
        back = TorchChatLLM("ckpt:{tmp_path / "ck"}@int8", device="cpu")
        assert back.cfg == llm.cfg
        loaded = {{m.split(".")[0] for m in sys.modules}}
        bad = loaded & {{"tensorstore", "ml_dtypes", "zstandard", "orbax", "jax", "raglite_tpu"}}
        assert not bad, bad
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_every_checkpoint_layout_loads_without_storage_packages() -> None:
    """Each committed layout fixture (zarr v3 sharded and Blosc, zarr v2
    Blosc, gzip, zlib, bz2, big-endian and F order, numbered OCDBT
    manifests) loads through ``ckpt:`` or ``flax:ckpt:`` with none of
    tensorstore, ml_dtypes, zstandard, orbax, numcodecs, zarr, blosc, lz4,
    JAX or the JAX package loaded; the native sources they need are
    first-party C++ that includes the standard library alone."""
    code = textwrap.dedent(
        """
        import sys
        from pathlib import Path
        from raglite_tpu_torch.models.checkpoint import load_checkpoint
        from raglite_tpu_torch.models.decoder import TorchChatLLM
        from raglite_tpu_torch.models.encoder import TransformerEncoder
        for root in sorted(Path("tests/data/orbax_layouts").iterdir()):
            tree, cfg = load_checkpoint(root)
            if "lm_head" in tree:
                assert TorchChatLLM(f"ckpt:{root}", device="cpu").cfg == cfg
            else:
                assert TransformerEncoder(f"ckpt:{root}", device="cpu").embed(["x"]).shape == (1, cfg["d_model"])
        loaded = {m.split(".")[0] for m in sys.modules}
        bad = loaded & {"tensorstore", "ml_dtypes", "zstandard", "orbax", "numcodecs", "zarr", "blosc", "lz4",
                        "jax", "raglite_tpu"}
        assert not bad, bad
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    from raglite_tpu_torch import native

    assert {p.name for p in native._SOURCES} >= {"zstd.cpp", "blosc.cpp"}
    for source in native._SOURCES:
        includes = {line.split()[1] for line in source.read_text().splitlines() if line.startswith("#include")}
        # C++ standard headers only: <name>, no ".h" (no zlib, lz4, blosc or zstd headers)
        assert all(i.startswith("<") and "." not in i for i in includes), (source.name, includes)


def test_cuda_without_a_gpu_raises(monkeypatch: pytest.MonkeyPatch) -> None:
    from raglite_tpu_torch import RAGLiteConfig
    from raglite_tpu_torch.search import vector_search

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = RAGLiteConfig(store_path=":memory:", embedder="flax:tiny", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vector_search("anything", config=config)


def test_boundary_model_on_cuda_without_a_gpu_raises(monkeypatch: pytest.MonkeyPatch) -> None:
    """The learned boundary model of a device="cuda" config raises where
    there is no card, through the model, split_sentences and an insert."""
    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents
    from raglite_tpu_torch.models.boundary import BoundaryModel, default_model, learned_sentence_boundaries
    from raglite_tpu_torch.sentences import split_sentences

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_model("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BoundaryModel.load()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BoundaryModel()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        learned_sentence_boundaries("One. Two.")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        split_sentences("One sentence. Two sentences.", base_probas="learned")
    config = RAGLiteConfig(store_path=":memory:", embedder="hash:64", sentence_boundary_model="learned", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        insert_documents([Document.from_text("One sentence here. And two sentences.")], config=config)
    assert default_model("cpu") is not None


def test_trainers_on_cuda_without_a_gpu_raise(monkeypatch: pytest.MonkeyPatch, tmp_path) -> None:
    """The trainers' and the held-out evaluation's command lines ask for the
    card by default and raise where there is none, before they read or write
    a file; with ``--device cpu`` the evaluation runs."""
    from raglite_tpu_torch.train import boundary, encoder
    from raglite_tpu_torch.train import semantic_ir_bench as sib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        boundary.main(["--out", str(tmp_path / "b.npz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encoder.main(["--phase", "mlm", "--workdir", str(tmp_path / "work")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encoder.main(["--phase", "tokenizer", "--workdir", str(tmp_path / "work")])
    args = ["--docs", "4", "--queries", "1", "--corpus", str(tmp_path / "corpus"), "--embedder", "hash:64"]
    for main, extra in ((sib.main, ["--adapter-queries", "0", "--workdir", str(tmp_path / "ir")]),
                        (sib.beir_main, ["--dir", str(tmp_path / "beir"), "--store-dir", str(tmp_path / "stores")]),
                        (sib.blend_main, ["--adapter-queries", "0", "--workdir", str(tmp_path / "ir")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([*args, *extra])
    assert not list(tmp_path.iterdir())
    (tmp_path / "corpus").mkdir()
    text = " ".join(f"Sentence number {i} talks about katydids and crickets singing at night." for i in range(12))
    (tmp_path / "corpus" / "heldout.jsonl").write_text("".join(
        json.dumps({"id": f"{i:016x}", "title": "", "text": f"Document {i}. {text}"}) + "\n" for i in range(4)))
    out = sib.main([*args, "--adapter-queries", "0", "--workdir", str(tmp_path / "ir"), "--device", "cpu",
                    "--variants", "hash-single"])
    assert out["device"] == "cpu" and [r["queries"] for r in out["variants"]] == [1]


def test_multi_gpu_is_ported() -> None:
    """Multi-GPU indexes are ported: ``num_devices`` no longer raises, and
    asking for the card's shards where there is no card still does."""
    from raglite_tpu_torch import RAGLiteConfig
    from raglite_tpu_torch.index.dense import DenseIndex

    assert RAGLiteConfig(num_devices=2).num_devices == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseIndex(dim=64, num_devices=2)


def test_config_num_devices_builds_a_sharded_index(tmp_path) -> None:
    """``RAGLiteConfig(num_devices=4, device="cpu")`` serves its store from
    a 4-shard index, and ``DenseIndex.load`` of that index's save (4 shards
    again, or 1) answers as it does."""
    import numpy as np

    from raglite_tpu_torch import Document, RAGLiteConfig, insert_documents, vector_search
    from raglite_tpu_torch.index.dense import DenseIndex, dense_index_from_config

    config = RAGLiteConfig(store_path=str(tmp_path / "kb"), embedder="hash:64", num_devices=4, device="cpu")
    insert_documents([Document.from_text("Katydids sing at night. They are relatives of crickets.")], config=config)
    ids, _ = vector_search("which insects sing at night?", num_results=2, config=config)
    index = dense_index_from_config(config)
    assert ids and index.num_devices == 4 and len(index._rows) == 4
    assert {r.shape[0] for r in index._rows} == {index.capacity // 4}
    q = np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)
    want = index.search_chunks(q, num_hits=8, num_results=3)
    index.save(str(tmp_path / "idx"))
    for num_devices in (None, 1):
        loaded = DenseIndex.load(str(tmp_path / "idx"), num_devices=num_devices, device="cpu")
        assert loaded.num_devices == (num_devices or 4)
        got = loaded.search_chunks(q, num_hits=8, num_results=3)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


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
