"""Command-line interface (counterpart of raglite_tpu/cli.py).

The same commands, options, ``RAGLITE_TPU_*`` environment variables and
``.env`` reading as the JAX package's click CLI, and the same text out,
built on ``argparse`` so that it runs wherever PyTorch does (no ``click``).
One option more, ``--device`` (env ``RAGLITE_TPU_DEVICE``, default
``cuda``), chooses ``RAGLiteConfig.device``: the card unless the caller
asks for the CPU.

    python -m raglite_tpu_torch --store-path kb insert report.pdf notes.docx
    python -m raglite_tpu_torch --store-path kb search "what is simultaneity?" --method vector
    python -m raglite_tpu_torch --store-path kb --device cpu serve --port 8080
    python -m raglite_tpu_torch --store-path kb mcp run

``bench`` needs the IR benchmark and its HNSW baseline, which are not
ported yet (ROADMAP queue 1 item 7): it exits with an error saying so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from raglite_tpu_torch.config import RAGLiteConfig

_SETTINGS = {
    "store_path": "RAGLITE_TPU_STORE_PATH",
    "llm": "RAGLITE_TPU_LLM",
    "embedder": "RAGLITE_TPU_EMBEDDER",
    "device": "RAGLITE_TPU_DEVICE",
}


class CLIError(Exception):
    """A usage or run error: printed as ``Error: <message>``, exit code 1."""


def _dotenv() -> dict[str, str]:
    """RAGLITE_TPU_* settings from a ``.env`` file in the working directory
    (the reference reads .env via pydantic-settings, _cli.py:13-23)."""
    env_path = Path(".env")
    if not env_path.is_file():
        return {}
    values: dict[str, str] = {}
    for line in env_path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        if key.startswith("RAGLITE_TPU_"):
            values[key] = value
    return values


def _config_from_options(args: argparse.Namespace) -> RAGLiteConfig:
    """Options first, then the environment, then ``.env``."""
    dotenv = _dotenv()
    kwargs = {}
    for field, env in _SETTINGS.items():
        value = getattr(args, field) or os.environ.get(env) or dotenv.get(env)
        if value:
            kwargs[field] = value
    return RAGLiteConfig(**kwargs)


# --- Commands ---------------------------------------------------------------


def _insert(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Insert documents into the knowledge base."""
    from raglite_tpu_torch.documents import Document
    from raglite_tpu_torch.insert import insert_documents

    documents = [Document.from_path(p) for p in args.paths]
    insert_documents(documents, config=config)
    print(f"Inserted {len(documents)} document(s) into {config.store_path}.")


def _search(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Search the knowledge base and print ranked chunks."""
    from raglite_tpu_torch.search import hybrid_search, keyword_search, retrieve_chunks, vector_search

    fn = {"vector": vector_search, "keyword": keyword_search, "hybrid": hybrid_search}[args.method]
    chunk_ids, scores = fn(args.query, num_results=args.num_results, config=config)
    # Look chunks up by id: retrieve_chunks drops ids deleted concurrently,
    # and a positional zip would misalign every following (chunk, score) pair.
    by_id = {c.id: c for c in retrieve_chunks(chunk_ids, config=config)}
    for chunk_id, score in zip(chunk_ids, scores):
        chunk = by_id.get(chunk_id)
        if chunk is None:
            print(f"{score:8.4f}  {chunk_id}  <deleted>")
            continue
        first_line = chunk.body.strip().splitlines()[0] if chunk.body.strip() else ""
        print(f"{score:8.4f}  {chunk.id}  {first_line[:100]}")


def _chat(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Interactive RAG chat in the terminal (the reference's Chainlit
    frontend equivalent)."""
    from raglite_tpu_torch.rag import rag

    print(f"RAGLite-TPU chat — store: {config.store_path}, llm: {config.llm}. Ctrl-D to exit.")
    messages: list[dict[str, str]] = []
    while True:
        try:
            user = input("you> ")
        except (EOFError, KeyboardInterrupt):
            print("\nbye")
            return
        if not user.strip():
            continue
        messages.append({"role": "user", "content": user})
        print("assistant> ", end="", flush=True)
        for token in rag(messages, config=config):
            print(token, end="", flush=True)
        print()


def _serve(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Web chat frontend with streaming answers, uploads and sources
    (webchat.py)."""
    from raglite_tpu_torch.webchat import create_web_app

    create_web_app(config).serve(args.host, args.port)


def _mcp_run(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Run the MCP server over stdio (reference: _cli.py:106-118)."""
    from raglite_tpu_torch.mcp import create_mcp_server

    create_mcp_server(config=config).run()


def _mcp_install(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Write a Claude Desktop config entry for this server
    (reference: _cli.py:58-103)."""
    if sys.platform == "darwin":
        config_path = Path.home() / "Library" / "Application Support" / "Claude"
    elif sys.platform == "win32":
        config_path = Path(os.environ.get("APPDATA", str(Path.home()))) / "Claude"
    else:
        config_path = Path.home() / ".config" / "Claude"
    config_path.mkdir(parents=True, exist_ok=True)
    config_file = config_path / "claude_desktop_config.json"
    desktop = json.loads(config_file.read_text()) if config_file.exists() else {}
    desktop.setdefault("mcpServers", {})[args.server_name] = {
        "command": sys.executable,
        "args": ["-m", "raglite_tpu_torch", "--store-path", config.store_path,
                 "--llm", config.llm, "--embedder", config.embedder,
                 "--device", config.device, "mcp", "run"],
    }
    config_file.write_text(json.dumps(desktop, indent=2))
    print(f"Installed MCP server {args.server_name!r} in {config_file}.")


def _bench(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """IR benchmark comparing retrieval variants (reference: _cli.py:121-206)."""
    msg = (
        "bench needs the IR benchmark (irbench.py) and its HNSW baseline, which are not "
        "ported to raglite_tpu_torch yet: ROADMAP queue 1 item 7 (irbench)"
    )
    raise CLIError(msg)


def _delete(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Delete documents by id (reference public API: delete_documents)."""
    from raglite_tpu_torch.delete import delete_documents

    delete_documents(list(args.document_ids), config=config)
    print(f"Deleted {len(args.document_ids)} document(s).")


def _update_adapter(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Train the Procrustes query adapter from stored evals
    (reference: update_query_adapter, _query_adapter.py:41)."""
    from raglite_tpu_torch.query_adapter import update_query_adapter

    adapter = update_query_adapter(config=config)
    print(f"Query adapter updated: shape {adapter.shape}.")


def _evals_insert(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    from raglite_tpu_torch.evals import insert_evals

    insert_evals(num_evals=args.num_evals, config=config)
    print(f"Inserted up to {args.num_evals} eval(s).")


def _evals_run(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Answer stored evals and print first-party quality metrics (a pandas
    table, as the JAX CLI prints it)."""
    from raglite_tpu_torch.evals import evaluate

    print(evaluate(args.num_evals, config).to_string())


def _stats(config: RAGLiteConfig, args: argparse.Namespace) -> None:
    """Show store/index statistics."""
    from raglite_tpu_torch.store import store_from_config

    store = store_from_config(config)
    print(
        json.dumps(
            {
                "store_path": config.store_path,
                "documents": len(store.documents),
                "chunks": len(store.chunk_order),
                "sub_vectors": store.num_embedding_vectors,
                "evals": len(store.evals),
                "metadata_fields": sorted(store.metadata),
                "has_query_adapter": "query_adapter" in store.index_metadata,
            },
            indent=2,
        )
    )


# --- Parser -----------------------------------------------------------------


def _command(subparsers, name: str, fn, help_text: str | None = None) -> argparse.ArgumentParser:
    doc = help_text or (fn.__doc__ or "").strip().split("\n\n")[0]
    parser = subparsers.add_parser(name, help=doc, description=doc)
    parser.set_defaults(fn=fn)
    return parser


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m raglite_tpu_torch",
        description="RAGLite-TPU (PyTorch port): retrieval-augmented generation on an NVIDIA GPU.",
    )
    parser.add_argument("--store-path", default=None, help="Store directory (env: RAGLITE_TPU_STORE_PATH).")
    parser.add_argument("--llm", default=None, help="LLM spec, e.g. 'echo' or 'jax:tiny' (env: RAGLITE_TPU_LLM).")
    parser.add_argument(
        "--embedder", default=None,
        help="Embedder spec: 'flax:sem' (default, in-package semantic encoder), 'hash:<dim>' (hermetic "
        "lexical), 'flax:<path>'/'openai:<model>' (env: RAGLITE_TPU_EMBEDDER).",
    )
    parser.add_argument(
        "--device", default=None,
        help="Torch device: 'cuda' (default) or 'cpu' (env: RAGLITE_TPU_DEVICE).",
    )
    commands = parser.add_subparsers(dest="command", metavar="COMMAND")

    p = _command(commands, "insert", _insert)
    p.add_argument("paths", nargs="*")
    p = _command(commands, "search", _search)
    p.add_argument("query")
    p.add_argument("--num-results", type=int, default=5, help="(default: 5)")
    p.add_argument("--method", choices=["vector", "keyword", "hybrid"], default="hybrid", help="(default: hybrid)")
    _command(commands, "chat", _chat)
    p = _command(commands, "serve", _serve)
    p.add_argument("--host", default="127.0.0.1", help="(default: 127.0.0.1)")
    p.add_argument("--port", type=int, default=8080, help="(default: 8080)")

    mcp = commands.add_parser("mcp", help="Model Context Protocol server.", description="Model Context Protocol server.")
    mcp_commands = mcp.add_subparsers(dest="mcp_command", metavar="COMMAND", required=True)
    _command(mcp_commands, "run", _mcp_run)
    p = _command(mcp_commands, "install", _mcp_install)
    p.add_argument("--server-name", default="RAGLite-TPU", help="(default: RAGLite-TPU)")

    p = _command(commands, "bench", _bench, "IR benchmark (not ported yet: ROADMAP queue 1 item 7, irbench).")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--measure", default="AP@10")
    p.add_argument("--num-queries", type=int, default=50)
    p.add_argument("--hnsw-recall", action="store_true")
    p.add_argument("--num-rows", type=int, default=100_000)
    p.add_argument("--remote-vector-store", default="")
    p = _command(commands, "delete", _delete)
    p.add_argument("document_ids", nargs="*")
    _command(commands, "update-adapter", _update_adapter)

    evals = commands.add_parser(
        "evals", help="Generate, answer, and score evals (reference: _eval.py).",
        description="Generate, answer, and score evals (reference: _eval.py).",
    )
    evals_commands = evals.add_subparsers(dest="evals_command", metavar="COMMAND", required=True)
    p = _command(evals_commands, "insert", _evals_insert, "Generate evals from the knowledge base and store them.")
    p.add_argument("--num-evals", type=int, default=10, help="(default: 10)")
    p = _command(evals_commands, "run", _evals_run)
    p.add_argument("--num-evals", type=int, default=10, help="(default: 10)")
    _command(commands, "stats", _stats)
    return parser


def main(argv: list[str] | None = None) -> int:
    """Run the CLI; returns the exit code (0, 1 on an error, 2 on a usage
    error as argparse gives it)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    if args.command == "insert":
        missing = [p for p in args.paths if not Path(p).exists()]
        if missing:
            parser.error(f"Path '{missing[0]}' does not exist.")
    try:
        args.fn(_config_from_options(args), args)
    except CLIError as error:
        print(f"Error: {error}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
