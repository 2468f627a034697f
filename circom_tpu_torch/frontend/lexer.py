"""Lexer for circom source.

Comment preprocessing reproduces the reference's byte-offset-preserving
state machine (parser/src/parser_logic.rs:9-85): `//` and `/* */` comments
are replaced by spaces (newlines kept) so spans in diagnostics match the
original file; block comments inside string literals are stripped too
(a reference quirk we keep for parity).

Token set from the LALRPOP terminals (parser/src/lang.lalrpop:771-864):
identifiers `[$_]*[a-zA-Z][a-zA-Z$_0-9]*`, decimal / `0x` hex numbers,
double-quoted single-line strings, and the fixed operator/keyword set.
"""

import re

from ..utils.reports import Report, ReportCollection


def preprocess(src: str, file_id: int) -> str:
    out = []
    state = 0  # 0 normal, 1 line comment, 2 block comment
    i, n = 0, len(src)
    block_start = 0
    while i < n:
        c = src[i]
        if state == 0:
            if c == "/" and i + 1 < n and src[i + 1] == "/":
                out.append("  ")
                state = 1
                i += 2
                continue
            if c == "/" and i + 1 < n and src[i + 1] == "*":
                out.append("  ")
                state = 2
                block_start = i
                i += 2
                continue
            out.append(c)
        elif state == 1:
            if c == "\n":
                out.append("\n")
                state = 0
            else:
                out.append(" ")
        else:  # block comment
            if c == "*" and i + 1 < n and src[i + 1] == "/":
                out.append("  ")
                state = 0
                i += 2
                continue
            out.append("\n" if c == "\n" else " ")
        i += 1
    if state == 2:
        raise ReportCollection([
            Report.error("unterminated /* */ comment", "P1005").add_primary(
                file_id, block_start, block_start + 2, "comment starts here"
            )
        ])
    return "".join(out)


KEYWORDS = {
    "pragma", "circom", "custom_templates", "include", "template", "function",
    "bus", "custom", "extern_c", "parallel", "component", "main", "public",
    "signal", "input", "output", "var", "if", "else", "for", "while",
    "return", "log", "assert",
}

# longest-match-first operator table
OPERATORS = [
    "<==", "==>", "<--", "-->", "===", "**=", "<<=", ">>=",
    "<<", ">>", "<=", ">=", "==", "!=", "&&", "||", "**", "++", "--",
    "+=", "-=", "*=", "/=", "\\=", "%=", "&=", "|=", "^=",
    "=", "<", ">", "+", "-", "*", "/", "\\", "%", "&", "|", "^", "!", "~",
    "?", ":", ";", ",", ".", "(", ")", "[", "]", "{", "}", "_",
]

_ident_re = re.compile(r"[$_]*[a-zA-Z][a-zA-Z$_0-9]*")
_hex_re = re.compile(r"0x[0-9A-Fa-f]*")
_dec_re = re.compile(r"[0-9]+")
_string_re = re.compile(r'"[^"\n]*"')
_ws_re = re.compile(r"\s+")

# sort operators: longest first for maximal munch
_OPS_SORTED = sorted(OPERATORS, key=len, reverse=True)


class Token:
    __slots__ = ("kind", "value", "start", "end")

    def __init__(self, kind, value, start, end):
        self.kind = kind    # 'id' | 'num' | 'str' | keyword | operator | 'eof'
        self.value = value
        self.start = start
        self.end = end

    def __repr__(self):
        return f"Token({self.kind!r},{self.value!r}@{self.start})"


def tokenize(src: str, file_id: int) -> list:
    """Preprocessed source -> token list (ends with an 'eof' token)."""
    toks = []
    i, n = 0, len(src)
    while i < n:
        m = _ws_re.match(src, i)
        if m:
            i = m.end()
            continue
        c = src[i]
        if c == '"':
            m = _string_re.match(src, i)
            if not m:
                raise ReportCollection([
                    Report.error("unterminated string", "P1012").add_primary(
                        file_id, i, i + 1
                    )
                ])
            toks.append(Token("str", m.group(0)[1:-1], i, m.end()))
            i = m.end()
            continue
        m = _ident_re.match(src, i)
        if m:
            word = m.group(0)
            kind = word if word in KEYWORDS else "id"
            toks.append(Token(kind, word, i, m.end()))
            i = m.end()
            continue
        if c == "0" and src.startswith("0x", i):
            m = _hex_re.match(src, i)
            toks.append(Token("num", int(m.group(0)[2:] or "0", 16), i, m.end()))
            i = m.end()
            continue
        m = _dec_re.match(src, i)
        if m:
            toks.append(Token("num", int(m.group(0)), i, m.end()))
            i = m.end()
            continue
        for op in _OPS_SORTED:
            if src.startswith(op, i):
                toks.append(Token(op, op, i, i + len(op)))
                i += len(op)
                break
        else:
            raise ReportCollection([
                Report.error(f"invalid character {c!r}", "P1012").add_primary(
                    file_id, i, i + 1
                )
            ])
    toks.append(Token("eof", None, n, n))
    return toks
