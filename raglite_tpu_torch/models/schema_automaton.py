"""Schema-constrained JSON automaton for decoding (a copy of
raglite_tpu/models/schema_automaton.py, pure Python).

Generation cannot deviate from a JSON schema: :class:`SchemaAutomaton` is a
byte-level automaton that walks a compiled JSON
schema, emitting fixed bytes for object keys/punctuation and delegating
free-form value regions (strings, numbers, booleans, enums, nested
objects/arrays) to type-restricted sub-automata built on
models/json_automaton.py.

Supported schema subset (what ``extract_with_llm`` / tool manifests emit):
``type: object`` with ``properties`` + ``required``, ``string`` (+enum),
``number``/``integer``, ``boolean``, ``null``, ``array`` (+items), nested
objects, and ``anyOf`` over primitive types.  Unknown/absent types fall
back to any-JSON-value.  All ``properties`` are generated, in declaration
order.
"""

from __future__ import annotations

from typing import Any

from raglite_tpu_torch.models.json_automaton import JsonAutomaton, _DIGITS, _WS

__all__ = ["SchemaAutomaton"]


def _fixed(text: str) -> list[tuple[str, Any]]:
    return [("fixed", text.encode("utf-8"))]


def _compile(
    schema: dict[str, Any] | None,
    root: dict[str, Any] | None = None,
    depth: int = 0,
) -> list[tuple[str, Any]]:
    """Compile a schema into a program: a list of (op, arg) steps.

    ops: ("fixed", bytes) — emit exactly these bytes;
         ("value", sub-schema|None) — free-form value region.
    """
    if not isinstance(schema, dict) or depth > 16:
        return [("value", None)]
    if root is None:
        root = schema
    if "$ref" in schema:
        # "#/$defs/Name" (pydantic model_json_schema nested models).
        target: Any = root
        for part in schema["$ref"].lstrip("#/").split("/"):
            target = target.get(part, {}) if isinstance(target, dict) else {}
        return _compile(target, root, depth + 1)
    if "enum" in schema:
        return [("enum", [_render_enum(v) for v in schema["enum"]])]
    if "const" in schema:
        return [("enum", [_render_enum(schema["const"])])]
    if "anyOf" in schema:
        return [("enum_program", [_compile(s, root, depth + 1) for s in schema["anyOf"]])]
    stype = schema.get("type")
    if stype == "object" and "properties" in schema:
        program: list[tuple[str, Any]] = _fixed("{")
        properties = list(schema["properties"].items())
        for index, (key, sub) in enumerate(properties):
            if index:
                program += _fixed(", ")
            program += _fixed(f'"{key}": ')
            program += _compile(sub, root, depth + 1)
        program += _fixed("}")
        return program
    if stype == "array":
        return [("array", _compile(schema.get("items"), root, depth + 1))]
    if stype in ("string", "number", "integer", "boolean", "null", "object"):
        return [("typed", stype)]
    return [("value", None)]


def _render_enum(value: Any) -> bytes:
    import json

    return json.dumps(value).encode("utf-8")


class _TypedValue:
    """A JsonAutomaton restricted to one top-level value type."""

    _OPENERS = {
        "string": {0x22},
        "number": {0x2D, *_DIGITS},
        "integer": {0x2D, *_DIGITS},
        "boolean": {0x74, 0x66},
        "null": {0x6E},
        "object": {0x7B},
        "array": {0x5B},
    }

    def __init__(self, stype: str | None) -> None:
        self._json = JsonAutomaton(top_level_object=False)
        self._stype = stype
        self._started = False

    def allowed_bytes(self) -> set[int]:
        allowed = self._json.allowed_bytes() - _WS
        if not self._started and self._stype in self._OPENERS:
            allowed &= self._OPENERS[self._stype]
        if self._started and self._stype == "integer":
            allowed -= {0x2E, 0x65, 0x45}  # no fraction/exponent
        return allowed

    def feed(self, byte: int) -> None:
        self._json.feed(byte)
        self._started = True

    def done_or_can_end(self) -> bool:
        return self._started and (self._json.done() or self._json.can_end())

    def done(self) -> bool:
        return self._json.done()

    def completion_bytes(self) -> bytes:
        if not self._started:
            first = {"string": b'""', "number": b"0", "integer": b"0",
                     "boolean": b"true", "null": b"null", "object": b"{}",
                     "array": b"[]"}.get(self._stype or "", b"null")
            for byte in first:
                self.feed(byte)
            return first
        return self._json.completion_bytes()


class SchemaAutomaton:
    """Byte-level recognizer for JSON conforming to a specific schema."""

    def __init__(self, schema: dict[str, Any] | None) -> None:
        self._program = _compile(schema)
        self._pc = 0  # program counter
        self._offset = 0  # position within a fixed step
        self._value: Any = None  # active sub-automaton for value regions
        self._advance_into_step()

    @classmethod
    def from_program(cls, program: list[tuple[str, Any]]) -> "SchemaAutomaton":
        """Instantiate from an already-compiled program — array items and
        anyOf branches spawn sub-automatons without recompiling a schema.
        (Previously three copy-pasted __new__ bootstrap blocks, none of
        which initialized ``_value``.)"""
        item = cls.__new__(cls)
        item._program = program
        item._pc = 0
        item._offset = 0
        item._value = None
        item._advance_into_step()
        return item

    # --- Step management ---------------------------------------------------

    def _current(self) -> tuple[str, Any] | None:
        return self._program[self._pc] if self._pc < len(self._program) else None

    def _advance_into_step(self) -> None:
        step = self._current()
        if step is None:
            return
        op, arg = step
        if op == "value":
            self._value = JsonAutomaton(top_level_object=False)
        elif op == "typed":
            self._value = _TypedValue(arg)
        elif op == "array":
            self._value = _ArrayValue(arg)
        elif op == "enum":
            self._value = _EnumValue(arg)
        elif op == "enum_program":
            self._value = _FirstByteDispatch(arg)
        else:
            self._value = None

    def _next_step(self) -> None:
        self._pc += 1
        self._offset = 0
        self._advance_into_step()

    # --- Queries / transitions ---------------------------------------------

    def done(self) -> bool:
        return self._pc >= len(self._program)

    def can_end(self) -> bool:
        if self.done():
            return True
        # A trailing free-value step that could end now, with nothing after.
        if self._pc == len(self._program) - 1 and self._value is not None:
            if isinstance(self._value, JsonAutomaton):
                return self._value.done() or self._value.can_end()
            return self._value.done_or_can_end()
        return False

    def allowed_bytes(self) -> set[int]:
        step = self._current()
        if step is None:
            return set()
        op, arg = step
        if op == "fixed":
            return {arg[self._offset]}
        allowed = (
            self._value.allowed_bytes()
            if not isinstance(self._value, JsonAutomaton)
            else self._value.allowed_bytes() - _WS
        )
        # If the value can end here and more program follows, the next fixed
        # byte is also allowed (value end is detected by that byte).
        if self._value_can_end() and self._pc + 1 < len(self._program):
            nxt = self._program[self._pc + 1]
            if nxt[0] == "fixed":
                allowed = allowed | {nxt[1][0]}
        return allowed

    def _value_can_end(self) -> bool:
        if self._value is None:
            return False
        if isinstance(self._value, JsonAutomaton):
            return self._value.done() or self._value.can_end()
        return self._value.done_or_can_end()

    def _value_done(self) -> bool:
        if self._value is None:
            return False
        return self._value.done()

    def feed(self, byte: int) -> None:
        step = self._current()
        if step is None:
            msg = "schema document already complete"
            raise ValueError(msg)
        op, arg = step
        if op == "fixed":
            if byte != arg[self._offset]:
                msg = f"expected byte {arg[self._offset]:#x}, got {byte:#x}"
                raise ValueError(msg)
            self._offset += 1
            if self._offset == len(arg):
                self._next_step()
            return
        # Value region: byte may end the value (start of the next fixed step).
        if self._value_can_end() and not self._value_done() and self._pc + 1 < len(self._program):
            nxt = self._program[self._pc + 1]
            if nxt[0] == "fixed" and byte == nxt[1][0] and byte not in self._value.allowed_bytes():
                self._next_step()
                self.feed(byte)
                return
        self._value.feed(byte)
        if self._value_done():
            self._next_step()

    def completion_bytes(self) -> bytes:
        """Close the document from the current state (budget exhaustion)."""
        out = bytearray()
        for _ in range(4096):
            step = self._current()
            if step is None:
                break
            op, arg = step
            if op == "fixed":
                remaining = arg[self._offset :]
                out += remaining
                self._offset = len(arg)
                self._next_step()
                continue
            suffix = self._value.completion_bytes()
            out += suffix
            if self._value_can_end():
                self._next_step()
        return bytes(out)


class _ArrayValue:
    """`[ item (, item)* ]` with schema-constrained items."""

    def __init__(self, item_program: list[tuple[str, Any]]) -> None:
        self._item_program = item_program
        self._state = "open"  # open -> item -> sep -> item ... -> done
        self._item: SchemaAutomaton | None = None

    def allowed_bytes(self) -> set[int]:
        if self._state == "open":
            return {0x5B}
        if self._state == "first":
            allowed = set(self._spawn_peek())
            allowed.add(0x5D)  # empty array
            return allowed
        if self._state == "item":
            allowed = set(self._item.allowed_bytes())
            if self._item.can_end():
                allowed |= {0x2C, 0x5D}
            return allowed
        if self._state == "sep":
            return set(self._spawn_peek())
        return set()

    def _spawn_peek(self) -> set[int]:
        return self._spawn().allowed_bytes()

    def _spawn(self) -> SchemaAutomaton:
        return SchemaAutomaton.from_program(self._item_program)

    def feed(self, byte: int) -> None:
        if byte not in self.allowed_bytes():
            msg = f"byte {byte:#x} not allowed in array state {self._state}"
            raise ValueError(msg)
        if self._state == "open":
            self._state = "first"
            return
        if self._state in ("first", "sep"):
            if self._state == "first" and byte == 0x5D:
                self._state = "done"
                return
            self._item = self._spawn()
            self._item.feed(byte)
            self._state = "item"
            if self._item.done():
                self._state = "item"  # wait for , or ]
            return
        if self._state == "item":
            if self._item.can_end() and byte in (0x2C, 0x5D) and byte not in self._item.allowed_bytes():
                self._state = "sep" if byte == 0x2C else "done"
                return
            if self._item.done():
                self._state = "sep" if byte == 0x2C else "done"
                return
            self._item.feed(byte)

    def done(self) -> bool:
        return self._state == "done"

    def done_or_can_end(self) -> bool:
        return self._state == "done"

    def completion_bytes(self) -> bytes:
        out = bytearray()
        if self._state == "open":
            out += b"[]"
            self._state = "done"
            return bytes(out)
        if self._state == "first":
            out += b"]"
            self._state = "done"
            return bytes(out)
        if self._state == "item":
            out += self._item.completion_bytes()
            out += b"]"
            self._state = "done"
            return bytes(out)
        if self._state == "sep":
            item = self._spawn()
            out += item.completion_bytes()
            out += b"]"
            self._state = "done"
        return bytes(out)


class _EnumValue:
    """One of a fixed set of rendered JSON literals."""

    def __init__(self, options: list[bytes]) -> None:
        self._options = options
        self._pos = 0

    def allowed_bytes(self) -> set[int]:
        return {o[self._pos] for o in self._options if len(o) > self._pos}

    def feed(self, byte: int) -> None:
        if byte not in self.allowed_bytes():
            msg = f"byte {byte:#x} not in enum"
            raise ValueError(msg)
        self._options = [o for o in self._options if len(o) > self._pos and o[self._pos] == byte]
        self._pos += 1

    def done(self) -> bool:
        # Done only when NO option extends the consumed bytes: an option
        # that is a byte-prefix of another (enum [1, 12]) must stay
        # reachable — the program's next fixed byte (',', '}') terminates
        # the prefix value via done_or_can_end instead.
        return any(len(o) == self._pos for o in self._options) and not any(
            len(o) > self._pos for o in self._options
        )

    def done_or_can_end(self) -> bool:
        return any(len(o) == self._pos for o in self._options)

    def completion_bytes(self) -> bytes:
        remaining = min((o for o in self._options), key=len)[self._pos :]
        self._pos = len(min((o for o in self._options), key=len))
        self._options = [min(self._options, key=len)]
        return remaining


class _FirstByteDispatch:
    """anyOf: pick the branch whose first byte matches, then delegate."""

    def __init__(self, programs: list[list[tuple[str, Any]]]) -> None:
        self._programs = programs
        self._active: SchemaAutomaton | None = None

    def _spawn(self, program: list[tuple[str, Any]]) -> SchemaAutomaton:
        return SchemaAutomaton.from_program(program)

    def allowed_bytes(self) -> set[int]:
        if self._active is not None:
            return self._active.allowed_bytes()
        allowed: set[int] = set()
        for program in self._programs:
            allowed |= self._spawn(program).allowed_bytes()
        return allowed

    def feed(self, byte: int) -> None:
        if self._active is None:
            for program in self._programs:
                probe = self._spawn(program)
                if byte in probe.allowed_bytes():
                    probe.feed(byte)
                    self._active = probe
                    return
            msg = f"byte {byte:#x} matches no anyOf branch"
            raise ValueError(msg)
        self._active.feed(byte)

    def done(self) -> bool:
        return self._active is not None and self._active.done()

    def done_or_can_end(self) -> bool:
        return self._active is not None and self._active.can_end()

    def completion_bytes(self) -> bytes:
        if self._active is None:
            self._active = self._spawn(self._programs[0])
        return self._active.completion_bytes()
