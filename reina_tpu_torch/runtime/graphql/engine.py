"""A small GraphQL engine (a copy of reina_tpu/runtime/graphql/engine.py):
lexer, parser and executor for the executable subset of the language
(operations, selection sets, aliases, arguments, variables, fragments,
@skip/@include). Schemas are plain Python:

    SCHEMA = {"query": {field: resolver}, "mutation": {...}}

A resolver is ``fn(parent, info, **args)``; returned objects are
resolved field-by-field (dicts, dataclasses and attribute objects all
work). Lists map; callables are invoked. ``__typename`` is supported
via an object's ``graphql_typename`` attribute or class name.
"""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field as dfield, is_dataclass, asdict
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class GraphQLError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>[\s,]+)
  | (?P<comment>\#[^\n\r]*)
  | (?P<name>[_A-Za-z][_0-9A-Za-z]*)
  | (?P<float>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+[eE][+-]?\d+)
  | (?P<int>-?\d+)
  | (?P<blockstring>\"\"\"(?:[^"]|"(?!""))*\"\"\")
  | (?P<string>"(?:[^"\\\n]|\\.)*")
  | (?P<punct>\.\.\.|[!$():=@\[\]{}|])
""", re.VERBOSE)


@dataclass
class Token:
    kind: str
    value: str
    pos: int


def tokenize(src: str) -> List[Token]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise GraphQLError(f"Syntax error at position {pos}: {src[pos:pos+20]!r}")
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            out.append(Token(kind, m.group(), pos))
        pos = m.end()
    out.append(Token("eof", "", pos))
    return out


# ---------------------------------------------------------------------------
# AST + parser

@dataclass
class Field:
    name: str
    alias: Optional[str] = None
    arguments: Dict[str, Any] = dfield(default_factory=dict)
    directives: List = dfield(default_factory=list)
    selections: List = dfield(default_factory=list)


@dataclass
class FragmentSpread:
    name: str
    directives: List = dfield(default_factory=list)


@dataclass
class InlineFragment:
    type_condition: Optional[str]
    directives: List = dfield(default_factory=list)
    selections: List = dfield(default_factory=list)


@dataclass
class Operation:
    kind: str                      # query | mutation
    name: Optional[str]
    variable_defs: Dict[str, Any]  # name -> default value (or _NO_DEFAULT)
    selections: List = dfield(default_factory=list)


@dataclass
class Fragment:
    name: str
    type_condition: str
    selections: List = dfield(default_factory=list)


@dataclass
class Document:
    operations: List[Operation]
    fragments: Dict[str, Fragment]


class _Var:
    def __init__(self, name: str):
        self.name = name


_NO_DEFAULT = object()


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> Token:
        t = self.next()
        if t.value != value:
            raise GraphQLError(f"Expected {value!r}, got {t.value!r} at {t.pos}")
        return t

    def expect_kind(self, kind: str) -> Token:
        t = self.next()
        if t.kind != kind:
            raise GraphQLError(f"Expected {kind}, got {t.value!r} at {t.pos}")
        return t

    def parse_document(self) -> Document:
        ops, frags = [], {}
        while self.peek().kind != "eof":
            t = self.peek()
            if t.value == "{":
                ops.append(Operation("query", None, {},
                                     self.parse_selection_set()))
            elif t.value in ("query", "mutation", "subscription"):
                ops.append(self.parse_operation())
            elif t.value == "fragment":
                f = self.parse_fragment()
                frags[f.name] = f
            else:
                raise GraphQLError(f"Unexpected {t.value!r} at {t.pos}")
        return Document(ops, frags)

    def parse_operation(self) -> Operation:
        kind = self.next().value
        name = None
        if self.peek().kind == "name":
            name = self.next().value
        var_defs: Dict[str, Any] = {}
        if self.peek().value == "(":
            self.next()
            while self.peek().value != ")":
                self.expect("$")
                vname = self.expect_kind("name").value
                self.expect(":")
                self.parse_type()
                default = _NO_DEFAULT
                if self.peek().value == "=":
                    self.next()
                    default = self.parse_value(const=True)
                var_defs[vname] = default
            self.next()
        self.parse_directives()
        return Operation(kind, name, var_defs, self.parse_selection_set())

    def parse_type(self):
        if self.peek().value == "[":
            self.next()
            self.parse_type()
            self.expect("]")
        else:
            self.expect_kind("name")
        if self.peek().value == "!":
            self.next()

    def parse_fragment(self) -> Fragment:
        self.expect("fragment")
        name = self.expect_kind("name").value
        self.expect("on")
        cond = self.expect_kind("name").value
        self.parse_directives()
        return Fragment(name, cond, self.parse_selection_set())

    def parse_directives(self) -> List:
        out = []
        while self.peek().value == "@":
            self.next()
            name = self.expect_kind("name").value
            args = {}
            if self.peek().value == "(":
                args = self.parse_arguments()
            out.append((name, args))
        return out

    def parse_selection_set(self) -> List:
        self.expect("{")
        out = []
        while self.peek().value != "}":
            out.append(self.parse_selection())
        self.next()
        return out

    def parse_selection(self):
        if self.peek().value == "...":
            self.next()
            if self.peek().value == "on" or self.peek().value in ("{", "@"):
                cond = None
                if self.peek().value == "on":
                    self.next()
                    cond = self.expect_kind("name").value
                dirs = self.parse_directives()
                return InlineFragment(cond, dirs, self.parse_selection_set())
            name = self.expect_kind("name").value
            return FragmentSpread(name, self.parse_directives())
        name = self.expect_kind("name").value
        alias = None
        if self.peek().value == ":":
            self.next()
            alias = name
            name = self.expect_kind("name").value
        args = {}
        if self.peek().value == "(":
            args = self.parse_arguments()
        dirs = self.parse_directives()
        sels = []
        if self.peek().value == "{":
            sels = self.parse_selection_set()
        return Field(name, alias, args, dirs, sels)

    def parse_arguments(self) -> Dict[str, Any]:
        self.expect("(")
        out = {}
        while self.peek().value != ")":
            name = self.expect_kind("name").value
            self.expect(":")
            out[name] = self.parse_value()
        self.next()
        return out

    def parse_value(self, const: bool = False):
        t = self.peek()
        if t.value == "$" and not const:
            self.next()
            return _Var(self.expect_kind("name").value)
        if t.kind == "int":
            self.next()
            return int(t.value)
        if t.kind == "float":
            self.next()
            return float(t.value)
        if t.kind == "blockstring":
            self.next()
            return t.value[3:-3]
        if t.kind == "string":
            self.next()
            return _decode_string(t.value)
        if t.kind == "name":
            self.next()
            if t.value == "true":
                return True
            if t.value == "false":
                return False
            if t.value == "null":
                return None
            return _Enum(t.value)
        if t.value == "[":
            self.next()
            out = []
            while self.peek().value != "]":
                out.append(self.parse_value(const))
            self.next()
            return out
        if t.value == "{":
            self.next()
            out = {}
            while self.peek().value != "}":
                k = self.expect_kind("name").value
                self.expect(":")
                out[k] = self.parse_value(const)
            self.next()
            return out
        raise GraphQLError(f"Unexpected value token {t.value!r} at {t.pos}")


class _Enum(str):
    """Enum literal — behaves as its string name."""


_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "b": "\b", "f": "\f",
            "n": "\n", "r": "\r", "t": "\t"}


def _decode_string(raw: str) -> str:
    body = raw[1:-1]
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            nxt = body[i + 1]
            if nxt == "u":
                out.append(chr(int(body[i + 2:i + 6], 16)))
                i += 6
                continue
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def parse(src: str) -> Document:
    return Parser(tokenize(src)).parse_document()


# ---------------------------------------------------------------------------
# Executor

@dataclass
class Info:
    context: Dict[str, Any]
    fragments: Dict[str, Fragment]
    variables: Dict[str, Any]


def _coerce(value, variables):
    if isinstance(value, _Var):
        if value.name not in variables:
            raise GraphQLError(f"Missing variable ${value.name}")
        return variables[value.name]
    if isinstance(value, list):
        return [_coerce(v, variables) for v in value]
    if isinstance(value, dict):
        return {k: _coerce(v, variables) for k, v in value.items()}
    return value


def _directives_allow(dirs, variables) -> bool:
    for name, args in dirs or []:
        if name == "skip" and _coerce(args.get("if", False), variables):
            return False
        if name == "include" and not _coerce(args.get("if", True), variables):
            return False
    return True


def _typename(obj) -> str:
    return getattr(obj, "graphql_typename", type(obj).__name__)


def _type_matches(obj, condition: Optional[str]) -> bool:
    """Does a fragment's type condition apply to this object? Matches the
    concrete typename or any declared interface (graphql_interfaces)."""
    if condition is None:
        return True
    if condition == _typename(obj):
        return True
    return condition in getattr(obj, "graphql_interfaces", ())


def _get_field(obj, name: str, info: Info, args: Dict[str, Any]):
    if name == "__typename":
        return _typename(obj)
    snake = re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
    for key in (name, snake):
        if isinstance(obj, dict):
            if key in obj:
                resolver = obj[key]
                if callable(resolver) and not isinstance(resolver, type):
                    return resolver(obj, info, **args)
                return resolver
        else:
            if hasattr(obj, "resolve_" + key):
                return getattr(obj, "resolve_" + key)(info, **args)
            if hasattr(obj, key):
                return getattr(obj, key)
    raise GraphQLError(f"Cannot query field {name!r} on {_typename(obj)}")


def _complete(value, selections, info: Info):
    if value is None:
        return None
    if selections:
        if isinstance(value, (list, tuple)) or (
                hasattr(value, "__iter__") and hasattr(value, "shape")
                and getattr(value, "ndim", 1) >= 1):
            return [_complete(v, selections, info) for v in value]
        return _execute_selections(value, selections, info)
    # leaf
    if hasattr(value, "item") and getattr(value, "shape", None) == ():
        value = value.item()
    if isinstance(value, (list, tuple)) or (
            hasattr(value, "tolist") and getattr(value, "ndim", 0) >= 1):
        return [_complete(v, [], info) for v in value]
    if hasattr(value, "item") and not isinstance(value, (str, bytes, int, float, bool)):
        try:
            return value.item()
        except Exception:
            pass
    if value is not None and not isinstance(value, (str, int, float, bool)):
        return str(value)
    if isinstance(value, float) and value != value:  # NaN → null
        return None
    return value


def _execute_selections(obj, selections, info: Info) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for sel in selections:
        if isinstance(sel, FragmentSpread):
            if not _directives_allow(sel.directives, info.variables):
                continue
            frag = info.fragments.get(sel.name)
            if frag is None:
                raise GraphQLError(f"Unknown fragment {sel.name!r}")
            if _type_matches(obj, frag.type_condition):
                out.update(_execute_selections(obj, frag.selections, info))
            continue
        if isinstance(sel, InlineFragment):
            if not _directives_allow(sel.directives, info.variables):
                continue
            if _type_matches(obj, sel.type_condition):
                out.update(_execute_selections(obj, sel.selections, info))
            continue
        if not _directives_allow(sel.directives, info.variables):
            continue
        key = sel.alias or sel.name
        args = {re.sub(r"(?<!^)(?=[A-Z])", "_", k).lower(): _coerce(v, info.variables)
                for k, v in sel.arguments.items()}
        value = _get_field(obj, sel.name, info, args)
        out[key] = _complete(value, sel.selections, info)
    return out


def execute(schema: Dict[str, Any], source: str,
            variables: Optional[Dict[str, Any]] = None,
            operation_name: Optional[str] = None,
            context: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Execute a request; returns the standard {data, errors} envelope."""
    variables = dict(variables or {})
    try:
        doc = parse(source)
        ops = doc.operations
        if operation_name:
            ops = [o for o in ops if o.name == operation_name]
        if len(ops) != 1:
            raise GraphQLError("Exactly one operation must be selected")
        op = ops[0]
        for vname, default in op.variable_defs.items():
            if vname not in variables:
                if default is _NO_DEFAULT:
                    continue
                variables[vname] = default
        root = schema.get(op.kind)
        if root is None:
            raise GraphQLError(f"Schema has no {op.kind} type")
        info = Info(context or {}, doc.fragments, variables)
        data = _execute_selections(root, op.selections, info)
        return {"data": data}
    except GraphQLError as e:
        return {"data": None, "errors": [{"message": str(e)}]}
    except RecursionError:
        return {"data": None,
                "errors": [{"message": "query too deeply nested"}]}
    except Exception as e:  # noqa: BLE001 — a resolver bug must surface
        # as a spec-compliant {data, errors} envelope, not a dropped
        # HTTP connection (graphene wraps resolver exceptions the same
        # way; clients like graphiql/reina-ui expect JSON)
        logger.exception("resolver error")
        return {"data": None,
                "errors": [{"message": "%s: %s" % (type(e).__name__, e)}]}
