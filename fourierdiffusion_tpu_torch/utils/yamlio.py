"""A reader and writer for the subset of YAML that the configs and the
``results.yaml`` files use, so that the port needs no YAML library.

The reader takes block mappings (by indentation), block sequences (indented
or not under their key), comments, plain and quoted scalars, and the empty
collections ``[]`` and ``{}``. Plain scalars resolve as ``yaml.safe_load``
(YAML 1.1) resolves them, quirks included: ``1e-3`` is a string and
``1.0e-3`` a float; ``yes``/``no``/``on``/``off`` are booleans; ``~``,
``null`` and an empty value are ``None``; ``.inf``, ``-.inf``, ``.nan`` are
floats; ``0x1f``, ``0o``-less octal ``017`` and ``1_000`` are ints.
``${a.b}`` and ``???`` stay strings. Anything else (flow collections,
anchors and aliases, tags, block scalars, multi-line scalars, directives,
timestamps) raises ``YamlSubsetError``: the reader does not guess.

The writer emits block style that ``yaml.safe_load`` and this reader read
back equal to the value: floats by ``repr`` (with ``.nan``/``.inf`` and a
``.0`` before a bare exponent), strings quoted wherever a plain scalar would
resolve to something else.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any

__all__ = ["YamlSubsetError", "dump", "dumps", "load", "loads", "resolve_plain"]


class YamlSubsetError(ValueError):
    """The text is outside the YAML subset this module reads."""


# PyYAML's implicit resolvers (resolver.py, YAML 1.1).
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF")
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN)""", re.X)
_INT = re.compile(r"""[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_NULL = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]"
                        r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?")
# A plain scalar may not start with these (flow collections, anchors,
# aliases, tags, block scalars, directives, reserved indicators).
_UNSUPPORTED_START = set("[]{},&*!|>%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# What may precede a quote that opens a scalar: nothing, sequence dashes, or
# a key and its colon.
_TOKEN_START = re.compile(r"(?:-[ \t]+)*(?:[^'\"#]*:[ \t]+)?")


def _sexagesimal(value: str, base_type):
    sign = -1 if value.startswith("-") else 1
    digits = [base_type(part) for part in value.lstrip("+-").split(":")]
    out, base = 0, 1
    for d in reversed(digits):
        out += d * base
        base *= 60
    return sign * out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = 1
    if value[0] in "+-":
        sign = -1 if value[0] == "-" else 1
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = 1.0
    if value[0] in "+-":
        sign = -1.0 if value[0] == "-" else 1.0
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """The value ``yaml.safe_load`` gives a plain (unquoted) scalar."""
    if _NULL.fullmatch(text):
        return None
    if _BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.fullmatch(text):
        return _construct_int(text)
    if _FLOAT.fullmatch(text):
        return _construct_float(text)
    if text == "<<" or text == "=" or _TIMESTAMP.fullmatch(text):
        raise YamlSubsetError(f"unsupported plain scalar {text!r}")
    return text


# -- reader -------------------------------------------------------------------


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str) -> None:
        self.no, self.indent, self.text = no, indent, text


def _scan_quoted(text: str, start: int, no: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[start]``; returns its value and
    the index after its closing quote."""
    quote = text[start]
    out = []
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                width = _HEX_ESCAPES[esc]
                digits = text[i + 2:i + 2 + width]
                if len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YamlSubsetError(f"line {no}: bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            raise YamlSubsetError(f"line {no}: unsupported escape in a double-quoted scalar")
        out.append(c)
        i += 1
    raise YamlSubsetError(f"line {no}: quoted scalar does not end on its line")


def _strip_comment(text: str, no: int) -> str:
    """``text`` without its comment. A quote opens a quoted scalar only where
    a scalar can start: at the line's start, after ``- `` and after ``: ``."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and _TOKEN_START.fullmatch(text[:i]):
            _, i = _scan_quoted(text, i, no)
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _lines(text: str) -> list[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlSubsetError(f"line {no}: tab in indentation")
        content = _strip_comment(body, no)
        if not content:
            continue
        if no == 1 and content.startswith("%"):
            raise YamlSubsetError(f"line {no}: directives are not supported")
        if content in ("---", "...") or content.startswith(("--- ", "... ")):
            raise YamlSubsetError(f"line {no}: document markers are not supported")
        out.append(_Line(no, len(raw) - len(body), content))
    return out


def _scalar(text: str, no: int) -> Any:
    """A scalar value, whole: quoted, plain, ``[]`` or ``{}``."""
    if text in ("[]", "{}"):
        return [] if text == "[]" else {}
    if text[0] in "'\"":
        value, end = _scan_quoted(text, 0, no)
        if text[end:].strip():
            raise YamlSubsetError(f"line {no}: text after a quoted scalar")
        return value
    if text[0] in _UNSUPPORTED_START:
        raise YamlSubsetError(f"line {no}: unsupported YAML construct {text!r}")
    if text[0] in "?:-" and (len(text) == 1 or text[1] in " \t"):
        raise YamlSubsetError(f"line {no}: unsupported YAML construct {text!r}")
    if ": " in text or text.endswith(":"):
        raise YamlSubsetError(f"line {no}: a mapping value is not allowed here: {text!r}")
    return resolve_plain(text)


def _split_key(text: str, no: int) -> tuple[Any, str] | None:
    """``(key, rest)`` where ``text`` is a mapping entry, else None."""
    if text[0] in "'\"":
        key, end = _scan_quoted(text, 0, no)
        rest = text[end:]
        if rest == ":" or rest.startswith((": ", ":\t")):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    key = text[:m.start()]
    if not key or key[0] in _UNSUPPORTED_START or key.startswith(("? ", "- ")) or key == "?":
        raise YamlSubsetError(f"line {no}: unsupported mapping key {key!r}")
    return resolve_plain(key.rstrip()), text[m.end():].strip()


def _is_item(line: _Line) -> bool:
    return line.text == "-" or line.text.startswith(("- ", "-\t"))


class _Reader:
    def __init__(self, lines: list[_Line]) -> None:
        self.lines = lines
        self.i = 0

    def peek(self) -> _Line | None:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if _is_item(line):
            return self.sequence(indent)
        if _split_key(line.text, line.no) is None:
            self.i += 1
            nxt = self.peek()
            if nxt is not None and nxt.indent >= indent:
                raise YamlSubsetError(f"line {nxt.no}: multi-line scalars are not supported")
            return _scalar(line.text, line.no)
        return self.mapping(indent)

    def nested(self, indent: int, allow_indentless: bool) -> Any:
        """The value of an entry whose own line left it empty."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt.indent > indent:
            return self.block(nxt.indent)
        if allow_indentless and nxt.indent == indent and _is_item(nxt):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self.peek()) is not None and line.indent == indent:
            if _is_item(line):
                break
            entry = _split_key(line.text, line.no)
            if entry is None:
                raise YamlSubsetError(f"line {line.no}: expected 'key: value', got {line.text!r}")
            key, rest = entry
            self.i += 1
            out[key] = _scalar(rest, line.no) if rest else self.nested(indent, True)
        if line is not None and line.indent > indent:
            raise YamlSubsetError(f"line {line.no}: unexpected indentation")
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while (line := self.peek()) is not None and line.indent == indent and _is_item(line):
            rest = line.text[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.nested(indent, False))
                continue
            if rest.startswith("\t"):
                raise YamlSubsetError(f"line {line.no}: tab after '-'")
            # The item's content starts a block at its own column.
            self.lines[self.i] = _Line(line.no, indent + len(line.text) - len(rest), rest)
            out.append(self.block(self.lines[self.i].indent))
        if line is not None and line.indent > indent:
            raise YamlSubsetError(f"line {line.no}: unexpected indentation")
        return out


def loads(text: str) -> Any:
    """Parse ``text``; an empty document is ``None``, as in ``yaml.safe_load``."""
    lines = _lines(text)
    if not lines:
        return None
    reader = _Reader(lines)
    value = reader.block(lines[0].indent)
    if (line := reader.peek()) is not None:
        raise YamlSubsetError(f"line {line.no}: unexpected text {line.text!r}")
    return value


def load(path: str | Path) -> Any:
    return loads(Path(path).read_text())


# -- writer -------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_$/.][A-Za-z0-9_$/.{}?+\- ]*")


def _str_out(value: str) -> str:
    if (_PLAIN_SAFE.fullmatch(value) and not value.endswith(" ")
            and " #" not in value and _resolves_to_itself(value)):
        return value
    if value.isprintable():
        return "'" + value.replace("'", "''") + "'"
    return json.dumps(value)


def _resolves_to_itself(value: str) -> bool:
    try:
        return resolve_plain(value) == value
    except YamlSubsetError:
        return False


def _float_out(value: float) -> str:
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_out(value: Any) -> str:
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        value = value.item()  # numpy and torch scalars
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float_out(value)
    if isinstance(value, str):
        return _str_out(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML")


def _emit(value: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            if not isinstance(key, str):
                raise TypeError(f"mapping keys must be strings, got {key!r}")
            head = f"{pad}{_str_out(key)}:"
            if isinstance(item, dict) and item:
                out.append(head)
                _emit(item, indent + 2, out)
            elif isinstance(item, (list, tuple)) and item:
                out.append(head)
                _emit(list(item), indent, out)
            else:
                out.append(f"{head} {_inline(item)}")
        return
    for item in value:  # a sequence, written without extra indentation
        if isinstance(item, dict) and item:
            sub: list[str] = []
            _emit(item, indent + 2, sub)
            out.append(f"{pad}- {sub[0].lstrip(' ')}")
            out.extend(sub[1:])
        elif isinstance(item, (list, tuple)) and item:
            raise TypeError("sequences of sequences are not supported")
        else:
            out.append(f"{pad}- {_inline(item)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar_out(value)


def dumps(value: Any) -> str:
    """Block-style YAML for dicts of scalars, dicts and lists."""
    if isinstance(value, dict) and value or isinstance(value, (list, tuple)) and value:
        out: list[str] = []
        _emit(value if isinstance(value, dict) else list(value), 0, out)
        return "\n".join(out) + "\n"
    return _inline(value) + "\n"


def dump(value: Any, path: str | Path) -> None:
    Path(path).write_text(dumps(value))
