"""MCP (Model Context Protocol) server (a copy of raglite_tpu/mcp.py over
the port's retrieval).

Counterpart of raglite/_mcp.py:22-53, which uses the
FastMCP package.  This is a first-party implementation of the MCP stdio
transport: JSON-RPC 2.0 over stdin/stdout implementing ``initialize``,
``tools/list``, ``tools/call``, ``prompts/list``, and ``prompts/get`` —
enough for Claude Desktop-class clients.  Exposes the same surface as the
reference: a ``kb`` prompt and a ``search_knowledge_base`` tool returning
the JSON documents payload of rag._run_tools.
"""

from __future__ import annotations

import json
import sys
from typing import Any

from raglite_tpu_torch.config import RAGLiteConfig
from raglite_tpu_torch.rag import retrieve_context

PROTOCOL_VERSION = "2024-11-05"

_SEARCH_TOOL_SCHEMA = {
    "name": "search_knowledge_base",
    "description": (
        "Search the knowledge base.\n"
        "IMPORTANT: You MAY NOT use this function if the question can be answered with "
        "common knowledge or straightforward reasoning.\n"
        "For multi-faceted questions, call this function once for each facet."
    ),
    "inputSchema": {
        "type": "object",
        "properties": {
            "query": {
                "type": "string",
                "description": (
                    "The `query` string MUST be a precise single-faceted question in the "
                    "user's language.\nThe `query` string MUST resolve all pronouns to "
                    "explicit nouns."
                ),
            }
        },
        "required": ["query"],
    },
}

_KB_PROMPT = {
    "name": "kb",
    "description": "Answer a question with information from the knowledge base.",
    "arguments": [
        {"name": "query", "description": "The question to answer.", "required": True}
    ],
}


def search_knowledge_base(query: str, *, config: RAGLiteConfig) -> str:
    """Tool body: retrieve context and render the JSON documents payload
    (reference: _mcp.py:33-47, same format as _rag._run_tools)."""
    spans = retrieve_context(query=query, config=config)
    return '{{"documents": [{elements}]}}'.format(
        elements=", ".join(span.to_json(index=i + 1) for i, span in enumerate(spans))
    )


class MCPServer:
    """Minimal JSON-RPC 2.0 MCP server over stdio."""

    def __init__(self, name: str = "RAGLite-TPU", *, config: RAGLiteConfig | None = None) -> None:
        self.name = name
        self.config = config or RAGLiteConfig()

    # --- Request handlers -------------------------------------------------

    def handle(self, request: dict[str, Any]) -> dict[str, Any] | None:
        if not isinstance(request, dict):
            # Valid JSON that is not a request object (e.g. a batch array,
            # which this minimal server does not support) must produce an
            # Invalid Request error, not crash the stdio loop.
            return {
                "jsonrpc": "2.0",
                "id": None,
                "error": {"code": -32600, "message": "Invalid Request: expected an object"},
            }
        method = request.get("method", "")
        params = request.get("params") or {}
        req_id = request.get("id")
        try:
            if method == "initialize":
                result: Any = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}, "prompts": {}},
                    "serverInfo": {"name": self.name, "version": "0.1.0"},
                }
            elif method == "notifications/initialized":
                return None  # notification: no response
            elif method == "tools/list":
                result = {"tools": [_SEARCH_TOOL_SCHEMA]}
            elif method == "tools/call":
                result = self._call_tool(params)
            elif method == "prompts/list":
                result = {"prompts": [_KB_PROMPT]}
            elif method == "prompts/get":
                result = self._get_prompt(params)
            elif method == "ping":
                result = {}
            else:
                if req_id is None:
                    return None
                return {
                    "jsonrpc": "2.0",
                    "id": req_id,
                    "error": {"code": -32601, "message": f"Method not found: {method}"},
                }
        except Exception as e:  # noqa: BLE001
            if req_id is None:
                return None  # JSON-RPC forbids responding to notifications
            return {
                "jsonrpc": "2.0",
                "id": req_id,
                "error": {"code": -32603, "message": str(e)},
            }
        if req_id is None:
            return None
        return {"jsonrpc": "2.0", "id": req_id, "result": result}

    def _call_tool(self, params: dict[str, Any]) -> dict[str, Any]:
        name = params.get("name")
        arguments = params.get("arguments") or {}
        if name != "search_knowledge_base":
            msg = f"Unknown tool {name!r}"
            raise ValueError(msg)
        payload = search_knowledge_base(arguments["query"], config=self.config)
        return {"content": [{"type": "text", "text": payload}], "isError": False}

    def _get_prompt(self, params: dict[str, Any]) -> dict[str, Any]:
        name = params.get("name")
        arguments = params.get("arguments") or {}
        if name != "kb":
            msg = f"Unknown prompt {name!r}"
            raise ValueError(msg)
        query = arguments.get("query", "")
        return {
            "description": _KB_PROMPT["description"],
            "messages": [
                {
                    "role": "user",
                    "content": {
                        "type": "text",
                        "text": f"Answer the question '{query}' with information from the knowledge base.",
                    },
                }
            ],
        }

    # --- Transport --------------------------------------------------------

    def run(self, stdin=None, stdout=None) -> None:
        """Serve newline-delimited JSON-RPC until EOF."""
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        # Warm up retrieval so the first tool call is fast
        # (reference: _mcp.py:49-51).
        try:
            retrieve_context(query="warmup", num_chunks=1, config=self.config)
        except Exception:  # noqa: BLE001,S110
            pass
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                request = json.loads(line)
            except json.JSONDecodeError:
                continue
            response = self.handle(request)
            if response is not None:
                stdout.write(json.dumps(response) + "\n")
                stdout.flush()


def create_mcp_server(
    server_name: str = "RAGLite-TPU", *, config: RAGLiteConfig | None = None
) -> MCPServer:
    """Create the MCP server (reference: _mcp.py:22)."""
    return MCPServer(server_name, config=config)
