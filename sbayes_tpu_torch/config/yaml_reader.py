"""The port's YAML reader: the subset of YAML that sBayes configs use,
without PyYAML (the card's machine has none).

It reads block mappings and block sequences by indentation, single-line
flow sequences and flow mappings (``[]``, ``{}``, ``[1, 3]``, nested),
full-line and trailing comments, and plain, single-quoted and
double-quoted scalars on one line. Plain scalars (values and keys) resolve
as PyYAML's ``safe_load`` resolves them (YAML 1.1): ``null`` / ``~`` / an
empty value give None; ``true/false/yes/no/on/off`` in their three cases
give bools; ints take ``0x``, ``0b``, a leading ``0`` (octal), ``_`` and
base 60 (``1:30``); floats need a dot (``1e6`` and ``1.0e6`` stay strings,
``1.0e+6`` is a float) or are ``.inf`` / ``.nan``; everything else is a
string. It is used whether PyYAML is installed or not, so that a config
gives the same dict on every machine.

Anything outside that subset raises a ``ValueError`` that names the line
and the construct, never a wrong value: anchors and aliases (``&``, ``*``),
tags (``!``), block scalars (``|``, ``>``), documents (``---``, ``...``),
directives (``%``), complex keys (``?``), merge keys (``<<``), timestamps,
tabs outside quotes, and scalars or flow collections that span lines.
"""
from __future__ import annotations

import re
from pathlib import Path

# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                         (?:[Tt]|[ \t]+)[0-9][0-9]?
                         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters that cannot start a plain scalar (PyYAML's check_plain)
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
# what PyYAML reads (its check_printable) less its line breaks other than
# \n and a \r before it
_UNREAD = re.compile("[^\x09\x20-\x7E\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010FFFF]"
                     "|[\u2028\u2029]")
_REFUSED_START = {"&": "an anchor (&)", "*": "an alias (*)", "!": "a tag (!)",
                  "|": "a block scalar (|)", ">": "a block scalar (>)",
                  "%": "a directive (%)", "@": "a reserved indicator (@)",
                  "`": "a reserved indicator (`)"}


def _fail(lineno: int, what: str):
    raise ValueError(f"YAML line {lineno}: {what} is not supported by the port's YAML reader")


def _sexagesimal(value: str, cast):
    out = cast(0)
    for part in value.split(":"):
        out = out * 60 + cast(part)
    return out


def resolve_plain(s: str, lineno: int = 0):
    """A plain scalar's value, as PyYAML's ``safe_load`` resolves it."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(s):
        _fail(lineno, f"the timestamp {s!r}")
    if s in ("<<", "="):
        _fail(lineno, f"the {'merge key' if s == '<<' else 'value key'} {s!r}")
    return s


class _Line:
    """One line of content: its number, its indentation and its text (from
    the first character after the indentation)."""

    __slots__ = ("lineno", "indent", "text")

    def __init__(self, lineno: int, indent: int, text: str):
        self.lineno, self.indent, self.text = lineno, indent, text


def _lines(text: str) -> list:
    out = []
    if text.startswith("\ufeff"):
        text = text[1:]
    for lineno, raw in enumerate(text.split("\n"), start=1):
        raw = raw.removesuffix("\r")
        bad = _UNREAD.search(raw)
        if bad:
            _fail(lineno, f"the character {bad.group()!r}")
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            _fail(lineno, "a tab in the indentation")
        if not body or body.startswith("#"):
            continue
        indent = len(raw) - len(body)
        if indent == 0 and body.startswith("%"):
            _fail(lineno, "a directive (%)")
        if indent == 0 and body[:3] in ("---", "...") and body[3:4] in ("", " "):
            _fail(lineno, f"a document marker ({body[:3]})")
        out.append(_Line(lineno, indent, body))
    return out


class _Cursor:
    """A position in the text of one line."""

    def __init__(self, line: _Line, pos: int = 0):
        self.line, self.text, self.pos = line, line.text, pos

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.text[i] if i < len(self.text) else ""

    def fail(self, what: str):
        _fail(self.line.lineno, what)

    def skip_spaces(self):
        while self.peek() in (" ", "\t"):
            if self.peek() == "\t":
                self.fail("a tab outside quotes")
            self.pos += 1

    def at_end(self) -> bool:
        """After the last token: only spaces and a comment may follow."""
        self.skip_spaces()
        return self.peek() in ("", "#")

    def expect_end(self, what: str):
        if not self.at_end():
            self.fail(f"{what} followed by {self.text[self.pos:]!r}")


def _spaced(ch: str) -> bool:
    return ch in ("", " ", "\t")


def _single_quoted(c: _Cursor) -> str:
    c.pos += 1
    out = []
    while True:
        j = c.text.find("'", c.pos)
        if j < 0:
            c.fail("a single-quoted scalar over several lines")
        out.append(c.text[c.pos:j])
        if c.text[j + 1:j + 2] == "'":
            out.append("'")
            c.pos = j + 2
            continue
        c.pos = j + 1
        return "".join(out)


def _double_quoted(c: _Cursor) -> str:
    c.pos += 1
    out = []
    while True:
        ch = c.peek()
        if ch == "":
            c.fail("a double-quoted scalar over several lines")
        c.pos += 1
        if ch == '"':
            return "".join(out)
        if ch != "\\":
            out.append(ch)
            continue
        esc = c.peek()
        c.pos += 1
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            digits = c.text[c.pos:c.pos + n]
            if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                c.fail(f"the escape \\{esc}{digits}")
            out.append(chr(int(digits, 16)))
            c.pos += n
        else:
            c.fail(f"the escape \\{esc}" if esc else "a double-quoted scalar over several lines")


def _plain(c: _Cursor, flow: bool) -> str:
    """A plain scalar from the cursor: up to ': ' (':' before a flow
    indicator in flow context), a comment, the end of the line, or in flow
    context a flow indicator."""
    start = end = c.pos
    while True:
        ch = c.peek()
        if ch == "":
            break
        if ch == "\t":
            c.fail("a tab outside quotes")
        if ch == ":" and (_spaced(c.peek(1)) or (flow and c.peek(1) in ",[]{}")):
            break
        if flow and ch in ",?[]{}":
            break
        if ch == " ":
            j = c.pos
            while c.peek(j - c.pos) == " ":
                j += 1
            if j >= len(c.text) or c.text[j] == "#":
                break
            c.pos = j
            continue
        c.pos += 1
        end = c.pos
    return c.text[start:end]


def _check_start(c: _Cursor, flow: bool):
    """Refuse what cannot start a scalar of the subset here."""
    ch, nxt = c.peek(), c.peek(1)
    if ch in _REFUSED_START:
        c.fail(_REFUSED_START[ch])
    if ch == "?" and (_spaced(nxt) or flow):
        c.fail("a complex key (?)")
    plain_start = not _spaced(nxt) and (ch == "-" or (not flow and ch in "?:"))
    if ch in _INDICATORS and ch not in "'\"[{" and not plain_start:
        c.fail(f"a node starting with {ch!r}")


def _scalar(c: _Cursor, flow: bool):
    """A quoted or plain scalar and whether it was plain."""
    ch = c.peek()
    if ch == "'":
        return _single_quoted(c), False
    if ch == '"':
        return _double_quoted(c), False
    _check_start(c, flow)
    return _plain(c, flow), True


def _flow_node(c: _Cursor):
    ch = c.peek()
    if ch in "[{":
        return _flow_collection(c)
    value, plain = _scalar(c, flow=True)
    return resolve_plain(value, c.line.lineno) if plain else value


def _flow_collection(c: _Cursor):
    is_map = c.peek() == "{"
    close = "}" if is_map else "]"
    c.pos += 1
    out = {} if is_map else []
    while True:
        c.skip_spaces()
        if c.peek() == close:
            c.pos += 1
            return out
        if c.peek() in ("", "#"):
            c.fail("a flow collection over several lines")
        if is_map:
            if c.peek() in "[{":
                c.fail("a flow collection as a key")
            key = _flow_node(c)
            c.skip_spaces()
            value = None
            if c.peek() == ":":
                c.pos += 1
                c.skip_spaces()
                if c.peek() not in (",", "}"):
                    value = _flow_node(c)
            out[key] = value
        else:
            out.append(_flow_node(c))
            c.skip_spaces()
            if c.peek() == ":":
                c.fail("a single-pair mapping in a flow sequence")
        c.skip_spaces()
        if c.peek() == ",":
            c.pos += 1
        elif c.peek() != close:
            c.fail(f"{c.peek()!r} in a flow collection" if c.peek()
                   else "a flow collection over several lines")


def _inline_value(c: _Cursor):
    """The value after ``key:`` or ``- `` on the same line (not empty)."""
    ch = c.peek()
    if ch in "[{":
        value = _flow_collection(c)
    elif ch == "-" and _spaced(c.peek(1)):
        c.fail("a sequence entry after a mapping key on one line")
    else:
        text, plain = _scalar(c, flow=False)
        if plain and c.peek() == ":":
            c.fail("a mapping value after a mapping value on one line")
        value = resolve_plain(text, c.line.lineno) if plain else text
    c.expect_end("a value")
    return value


def _mapping_key(line: _Line):
    """(key, cursor after ': ') when the line is a mapping entry, else None."""
    c = _Cursor(line)
    ch = c.peek()
    if ch in "[{":
        return None
    if ch in "'\"":
        key, plain = _scalar(c, flow=False)
        c.skip_spaces()
    elif ch == "?" and _spaced(c.peek(1)):
        c.fail("a complex key (?)")
    elif ch == ":" and _spaced(c.peek(1)):
        c.fail("an empty key")
    elif ch == "-" and _spaced(c.peek(1)):
        return None
    else:
        _check_start(c, flow=False)
        key, plain = _plain(c, flow=False), True
    if not (c.peek() == ":" and _spaced(c.peek(1))):
        return None
    c.pos += 1
    c.skip_spaces()
    return (resolve_plain(key, line.lineno) if plain else key), c


def _is_entry(line: _Line) -> bool:
    return line.text[0] == "-" and _spaced(line.text[1:2])


class _Parser:
    def __init__(self, lines: list):
        self.lines = lines
        self.i = 0

    def line(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int):
        """The block node whose first line is the current one, at ``indent``."""
        line = self.line()
        if _is_entry(line):
            return self.sequence(indent)
        if _mapping_key(line) is not None:
            return self.mapping(indent)
        value = _inline_value(_Cursor(line))
        self.i += 1
        following = self.line()
        if following is not None and following.indent >= indent:
            _fail(following.lineno, "a scalar over several lines")
        return value

    def nested(self, parent_indent: int, seq_at_same_indent: bool):
        """The value of a key or entry with nothing after it on its line:
        the block on the next lines indented deeper than the parent (a
        mapping's value may also be a sequence at the key's indentation),
        else None."""
        line = self.line()
        if line is None:
            return None
        if line.indent > parent_indent:
            return self.block(line.indent)
        if seq_at_same_indent and line.indent == parent_indent and _is_entry(line):
            return self.sequence(parent_indent)
        return None

    def after_inline(self, parent_indent: int):
        line = self.line()
        if line is not None and line.indent > parent_indent:
            _fail(line.lineno, "a scalar over several lines or a node after an inline value")

    def mapping(self, indent: int) -> dict:
        out = {}
        while (line := self.line()) is not None and line.indent == indent:
            entry = _mapping_key(line)
            if entry is None:
                _fail(line.lineno, "a line that is not a key of the mapping above it")
            key, c = entry
            if c.at_end():
                self.i += 1
                out[key] = self.nested(indent, seq_at_same_indent=True)
            else:
                out[key] = _inline_value(c)
                self.i += 1
                self.after_inline(indent)
        self.check_dedent(indent)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (line := self.line()) is not None and line.indent == indent and _is_entry(line):
            c = _Cursor(line, 1)
            c.skip_spaces()
            if c.at_end():
                self.i += 1
                out.append(self.nested(indent, seq_at_same_indent=False))
                continue
            if c.peek() == "?" and _spaced(c.peek(1)):
                c.fail("a complex key (?)")
            # the rest of the line is a node at its own column ("- a: 1" /
            # "- - a"): the line continues as if indented to that column
            rest = _Line(line.lineno, indent + c.pos, line.text[c.pos:])
            if _is_entry(rest) or _mapping_key(rest) is not None:
                self.lines[self.i] = rest
                out.append(self.block(rest.indent))
            else:
                out.append(_inline_value(_Cursor(rest)))
                self.i += 1
                self.after_inline(indent)
        self.check_dedent(indent, sequence=True)
        return out

    def check_dedent(self, indent: int, sequence: bool = False):
        line = self.line()
        if line is not None and line.indent > indent:
            _fail(line.lineno, "an indentation that matches no block above it")
        if sequence and line is not None and line.indent == indent and not _is_entry(line):
            # a sequence at a key's indentation ends at the next key
            if _mapping_key(line) is None:
                _fail(line.lineno, "a line that is not an entry of the sequence above it")


def loads(text: str):
    """The value of a YAML document of the subset, as ``yaml.safe_load``
    gives it; None for a document without content."""
    lines = _lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    value = p.block(lines[0].indent)
    if p.line() is not None:
        _fail(p.line().lineno, "content after the document's top-level node")
    return value


def load(path) -> object:
    """``loads`` of a UTF-8 file."""
    return loads(Path(path).read_text(encoding="utf-8"))
