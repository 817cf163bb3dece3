"""Incremental byte-level JSON recognizer for constrained decoding (a copy
of raglite_tpu/models/json_automaton.py, pure Python, with one repair: a
top-level-object document closed before its first ``{`` (a budget spent on
leading white space) closes as ``{}``, where the original tries to emit
``null``, which a top-level object forbids, and raises).

Drives logit masking in the decoder (models/decoder.py): at each step,
``allowed_bytes()`` is the set of next bytes that keep the output a valid
JSON prefix, and the corresponding token logits are the only ones left
unmasked: generation cannot produce malformed JSON, by a pushdown
automaton over UTF-8 bytes.
"""

from __future__ import annotations

__all__ = ["JsonAutomaton"]

_WS = {0x09, 0x0A, 0x0D, 0x20}
_DIGITS = set(range(0x30, 0x3A))
_ONENINE = set(range(0x31, 0x3A))
_HEX = _DIGITS | set(range(0x41, 0x47)) | set(range(0x61, 0x67))
#: Printable/extended bytes legal inside a JSON string (minus '"' and '\\').
_STRING_BYTES = (set(range(0x20, 0x100)) - {0x22, 0x5C})

_LITERALS = {0x74: b"true", 0x66: b"false", 0x6E: b"null"}


class JsonAutomaton:
    """Tracks the state of a JSON document as bytes are fed one at a time."""

    def __init__(self, *, top_level_object: bool = True) -> None:
        #: Containers entered so far: "o" (object) / "a" (array).
        self.stack: list[str] = []
        #: Current mode; see _allowed for the full set.
        self.mode = "value"
        self._literal: bytes = b""
        self._literal_pos = 0
        self._unicode_left = 0
        self._number_state = ""
        #: Restrict the top-level value to an object (response_format
        #: {"type": "json_object"} semantics).
        self._top_level_object = top_level_object
        self._started = False

    # --- Queries ----------------------------------------------------------

    def allowed_bytes(self) -> set[int]:
        return self._allowed()

    def done(self) -> bool:
        return self.mode == "done"

    def can_end(self) -> bool:
        """True when generation may stop here (document complete)."""
        if self.mode == "done":
            return True
        # A top-level number is complete without a terminating delimiter.
        return self.mode == "number" and not self.stack and self._number_complete()

    def completion_bytes(self) -> bytes:
        """Shortest-ish byte suffix that closes the document from the current
        state (used when the token budget runs out mid-document so constrained
        output is always parseable).  Mutates the automaton as it goes."""
        out = bytearray()
        for _ in range(512):
            if self.can_end():
                break
            mode = self.mode.split(":")[0]
            allowed = self._allowed()
            if mode == "literal":
                byte = self._literal[self._literal_pos]
            elif mode == "string":
                byte = 0x22
            elif mode == "string_escape":
                byte = 0x6E
            elif mode == "string_unicode":
                byte = 0x30
            elif mode == "number" and not self._number_complete():
                byte = 0x30
            elif 0x7D in allowed:
                byte = 0x7D
            elif 0x5D in allowed:
                byte = 0x5D
            elif 0x3A in allowed:
                byte = 0x3A
            elif 0x22 in allowed:
                byte = 0x22  # forced object key
            elif 0x6E in allowed:  # a value is required: emit null
                byte = 0x6E
            else:  # only an object may start the document: open one
                byte = 0x7B
            self.feed(byte)
            out.append(byte)
        return bytes(out)

    # --- Transitions ------------------------------------------------------

    def feed(self, byte: int) -> None:
        if byte not in self._allowed():
            msg = f"byte {byte:#x} not allowed in mode {self.mode}"
            raise ValueError(msg)
        handler = getattr(self, f"_feed_{self.mode.split(':')[0]}")
        handler(byte)

    # --- Mode implementations --------------------------------------------

    def _value_start(self, byte: int) -> None:
        """Dispatch the first byte of a value."""
        if byte in _WS:
            # Leading whitespace does not start the value — marking it
            # "started" would lift the top_level_object restriction and let
            # constrained decoding emit a top-level array/scalar.
            return
        self._started = True
        if byte == 0x7B:  # {
            self.stack.append("o")
            self.mode = "obj_key_or_end"
        elif byte == 0x5B:  # [
            self.stack.append("a0")  # "a0" = array with no elements yet
            self.mode = "value"
        elif byte == 0x22:  # "
            self.mode = "string"
        elif byte in _LITERALS:
            self._literal = _LITERALS[byte]
            self._literal_pos = 1
            if len(self._literal) == 1:
                self._end_value()
            else:
                self.mode = "literal"
        elif byte == 0x2D or byte in _DIGITS:  # - or digit
            self.mode = "number"
            self._number_state = "sign" if byte == 0x2D else ("int0" if byte == 0x30 else "int")
        else:  # whitespace
            pass

    def _feed_value(self, byte: int) -> None:
        if byte == 0x5D and self.stack and self.stack[-1] == "a0":  # ] closes empty array
            self.stack.pop()
            self._end_value()
            return
        self._value_start(byte)

    def _feed_obj_key_or_end(self, byte: int) -> None:
        if byte == 0x7D:  # }
            self.stack.pop()
            self._end_value()
        elif byte == 0x22:
            self.mode = "string:key"

    def _feed_obj_colon(self, byte: int) -> None:
        if byte == 0x3A:
            self.mode = "value"

    def _feed_obj_comma_or_end(self, byte: int) -> None:
        if byte == 0x2C:
            self.mode = "obj_key"
        elif byte == 0x7D:
            self.stack.pop()
            self._end_value()

    def _feed_obj_key(self, byte: int) -> None:
        if byte == 0x22:
            self.mode = "string:key"

    def _feed_arr_comma_or_end(self, byte: int) -> None:
        if byte == 0x2C:
            self.mode = "value"
        elif byte == 0x5D:
            self.stack.pop()
            self._end_value()

    def _feed_string(self, byte: int) -> None:
        is_key = self.mode.endswith(":key")
        if byte == 0x22:
            if is_key:
                self.mode = "obj_colon"
            else:
                self._end_value()
        elif byte == 0x5C:
            self.mode = "string_escape:key" if is_key else "string_escape"

    def _feed_string_escape(self, byte: int) -> None:
        is_key = self.mode.endswith(":key")
        if byte == 0x75:  # \u
            self._unicode_left = 4
            self.mode = "string_unicode:key" if is_key else "string_unicode"
        else:
            self.mode = "string:key" if is_key else "string"

    def _feed_string_unicode(self, byte: int) -> None:
        is_key = self.mode.endswith(":key")
        self._unicode_left -= 1
        if self._unicode_left == 0:
            self.mode = "string:key" if is_key else "string"

    def _feed_literal(self, byte: int) -> None:
        self._literal_pos += 1
        if self._literal_pos == len(self._literal):
            self._end_value()

    def _feed_number(self, byte: int) -> None:
        ns = self._number_state
        if byte in _DIGITS:
            self._number_state = {
                "sign": "int0" if byte == 0x30 else "int",
                "int0": "int0",  # unreachable: leading zero forbids digits
                "int": "int",
                "frac0": "frac",
                "frac": "frac",
                "exp_sign": "exp",
                "exp0": "exp",
                "exp": "exp",
            }[ns]
        elif byte == 0x2E:  # .
            self._number_state = "frac0"
        elif byte in (0x65, 0x45):  # e E
            self._number_state = "exp0"
        elif byte in (0x2B, 0x2D):  # exponent sign
            self._number_state = "exp_sign"
        else:
            # Delimiter terminates the number; reprocess it post-value.
            self._end_value()
            if byte not in _WS:
                self.feed(byte)

    def _feed_done(self, byte: int) -> None:
        pass  # only whitespace is allowed

    def _end_value(self) -> None:
        """A value just completed; move to the container's next state."""
        self._number_state = ""
        if not self.stack:
            self.mode = "done"
        elif self.stack[-1] == "o":
            self.mode = "obj_comma_or_end"
        else:
            self.stack[-1] = "a"  # the array now has at least one element
            self.mode = "arr_comma_or_end"

    # --- Allowed sets -----------------------------------------------------

    def _number_complete(self) -> bool:
        return self._number_state in ("int0", "int", "frac", "exp")

    def _allowed(self) -> set[int]:  # noqa: C901, PLR0912
        mode = self.mode.split(":")[0]
        if mode == "value":
            allowed = set(_WS)
            if not self._started and self._top_level_object:
                allowed |= {0x7B}
                return allowed
            allowed |= {0x7B, 0x5B, 0x22, 0x74, 0x66, 0x6E, 0x2D} | _DIGITS
            if self.stack and self.stack[-1] == "a0":
                allowed.add(0x5D)  # empty array close
            return allowed
        if mode == "obj_key_or_end":
            return _WS | {0x22, 0x7D}
        if mode == "obj_key":
            return _WS | {0x22}
        if mode == "obj_colon":
            return _WS | {0x3A}
        if mode == "obj_comma_or_end":
            return _WS | {0x2C, 0x7D}
        if mode == "arr_comma_or_end":
            return _WS | {0x2C, 0x5D}
        if mode == "string":
            return _STRING_BYTES | {0x22, 0x5C}
        if mode == "string_escape":
            return {0x22, 0x5C, 0x2F, 0x62, 0x66, 0x6E, 0x72, 0x74, 0x75}
        if mode == "string_unicode":
            return set(_HEX)
        if mode == "literal":
            return {self._literal[self._literal_pos]}
        if mode == "number":
            ns = self._number_state
            allowed: set[int] = set()
            if ns == "sign":
                return set(_DIGITS)
            if ns == "int0":
                allowed = {0x2E, 0x65, 0x45}
            elif ns == "int":
                allowed = _DIGITS | {0x2E, 0x65, 0x45}
            elif ns in ("frac0", "exp_sign"):
                return set(_DIGITS)
            elif ns == "frac":
                allowed = _DIGITS | {0x65, 0x45}
            elif ns == "exp0":
                allowed = _DIGITS | {0x2B, 0x2D}
            elif ns == "exp":
                allowed = set(_DIGITS)
            if self._number_complete():
                allowed |= set(_WS)
                if self.stack and self.stack[-1] == "o":
                    allowed |= {0x2C, 0x7D}
                elif self.stack and self.stack[-1] in ("a", "a0"):
                    allowed |= {0x2C, 0x5D}
            return allowed
        if mode == "done":
            return set(_WS)
        msg = f"unknown mode {self.mode}"
        raise AssertionError(msg)
