"""Schema introspection for the hand-rolled GraphQL engine (a copy of
reina_tpu/runtime/graphql/introspection.py).

The reference serves a real graphene schema, so graphiql, codegen and
Apollo dev tools can issue ``__schema``/``__type`` queries against it
(reference graphql_backend.py:40-45, graphql_schema.py:500-508). Here
the executable schema is plain resolver dicts, so the type system is
declared separately in SDL (see sdl.py), parsed into spec-shaped
``__Type``/``__Field``/... objects, and exposed through ``__schema`` /
``__type(name:)`` resolvers that merge into the query root.

Only the type-system *description* lives here; execution stays with
engine.py (which is schema-less by design).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional

from .engine import GraphQLError, Parser, Token, _Enum, tokenize


# ---------------------------------------------------------------------------
# Introspection object model (the GraphQL spec's __Schema/__Type/... shapes).
# Field names are snake_case; the engine camelCase-folds incoming names.

@dataclass
class IEnumValue:
    name: str
    description: Optional[str] = None
    is_deprecated: bool = False
    deprecation_reason: Optional[str] = None
    graphql_typename = "__EnumValue"


@dataclass
class IInputValue:
    name: str
    type: "IType" = None
    description: Optional[str] = None
    default_value: Optional[str] = None  # GraphQL-literal serialization
    is_deprecated: bool = False
    deprecation_reason: Optional[str] = None
    graphql_typename = "__InputValue"


@dataclass
class IField:
    name: str
    type: "IType" = None
    description: Optional[str] = None
    arg_list: List[IInputValue] = dfield(default_factory=list)
    is_deprecated: bool = False
    deprecation_reason: Optional[str] = None
    graphql_typename = "__Field"

    def resolve_args(self, info, include_deprecated=False):
        if include_deprecated:
            return self.arg_list
        return [a for a in self.arg_list if not a.is_deprecated]


@dataclass
class IType:
    kind: str                     # SCALAR OBJECT INTERFACE UNION ENUM
    #                               INPUT_OBJECT LIST NON_NULL
    name: Optional[str] = None
    description: Optional[str] = None
    field_list: Optional[List[IField]] = None
    interfaces: Optional[List["IType"]] = None
    possible_types: Optional[List["IType"]] = None
    enum_value_list: Optional[List[IEnumValue]] = None
    input_fields: Optional[List[IInputValue]] = None
    of_type: Optional["IType"] = None
    # attribute deliberately camelCase: the engine's camel→snake folding
    # turns "specifiedByURL" into "specified_by_u_r_l", so the exact-name
    # lookup must hit first
    specifiedByURL: Optional[str] = None
    is_one_of: Optional[bool] = None
    graphql_typename = "__Type"

    def resolve_fields(self, info, include_deprecated=False):
        if self.field_list is None:
            return None
        if include_deprecated:
            return self.field_list
        return [f for f in self.field_list if not f.is_deprecated]

    def resolve_enum_values(self, info, include_deprecated=False):
        if self.enum_value_list is None:
            return None
        if include_deprecated:
            return self.enum_value_list
        return [v for v in self.enum_value_list if not v.is_deprecated]


@dataclass
class IDirective:
    name: str
    description: Optional[str] = None
    locations: List[str] = dfield(default_factory=list)
    arg_list: List[IInputValue] = dfield(default_factory=list)
    is_repeatable: bool = False
    graphql_typename = "__Directive"

    def resolve_args(self, info, include_deprecated=False):
        if include_deprecated:
            return self.arg_list
        return [a for a in self.arg_list if not a.is_deprecated]


@dataclass
class ISchema:
    types: List[IType]
    query_type: IType
    mutation_type: Optional[IType] = None
    subscription_type: Optional[IType] = None
    directives: List[IDirective] = dfield(default_factory=list)
    description: Optional[str] = None
    graphql_typename = "__Schema"


# ---------------------------------------------------------------------------
# SDL parser: type-system definitions on top of the executable-language
# parser (engine.Parser handles values; we add type defs + descriptions).

class SDLParser(Parser):
    def __init__(self, tokens: List[Token]):
        super().__init__(tokens)
        self.types: Dict[str, IType] = {}
        self.defined: set = set()
        self.roots = {"query": "Query", "mutation": None, "subscription": None}
        self._implements: Dict[str, List[str]] = {}
        self._unions: Dict[str, List[str]] = {}

    # --- type references ---------------------------------------------------
    def ref_type(self) -> IType:
        """Parse a type reference into (possibly wrapped) ITypes. Named
        types resolve lazily through _named so forward references work."""
        if self.peek().value == "[":
            self.next()
            inner = self.ref_type()
            self.expect("]")
            t = IType(kind="LIST", of_type=inner)
        else:
            t = self._named(self.expect_kind("name").value)
        if self.peek().value == "!":
            self.next()
            t = IType(kind="NON_NULL", of_type=t)
        return t

    def _named(self, name: str) -> IType:
        t = self.types.get(name)
        if t is None:
            # placeholder patched when (if) the definition arrives
            t = IType(kind="SCALAR", name=name)
            self.types[name] = t
        return t

    def _description(self) -> Optional[str]:
        t = self.peek()
        if t.kind in ("string", "blockstring"):
            self.next()
            raw = t.value[3:-3] if t.kind == "blockstring" else t.value[1:-1]
            return raw.strip()
        return None

    def _directives_deprecation(self):
        """Parse field/value directives; return (is_deprecated, reason)."""
        deprecated, reason = False, None
        for name, args in self.parse_directives():
            if name == "deprecated":
                deprecated = True
                reason = args.get("reason", "No longer supported")
        return deprecated, reason

    def _args_def(self) -> List[IInputValue]:
        if self.peek().value != "(":
            return []
        self.next()
        out = []
        while self.peek().value != ")":
            desc = self._description()
            name = self.expect_kind("name").value
            self.expect(":")
            typ = self.ref_type()
            default = None
            if self.peek().value == "=":
                self.next()
                default = serialize_value(self.parse_value(const=True))
            dep, reason = self._directives_deprecation()
            out.append(IInputValue(name=name, type=typ, description=desc,
                                   default_value=default, is_deprecated=dep,
                                   deprecation_reason=reason))
        self.next()
        return out

    def _fields_def(self) -> List[IField]:
        self.expect("{")
        out = []
        while self.peek().value != "}":
            desc = self._description()
            name = self.expect_kind("name").value
            args = self._args_def()
            self.expect(":")
            typ = self.ref_type()
            dep, reason = self._directives_deprecation()
            out.append(IField(name=name, type=typ, description=desc,
                              arg_list=args, is_deprecated=dep,
                              deprecation_reason=reason))
        self.next()
        return out

    def _define(self, name: str, **kw) -> IType:
        t = self._named(name)
        self.defined.add(name)
        for k, v in kw.items():
            setattr(t, k, v)
        return t

    # --- definitions -------------------------------------------------------
    def parse_sdl(self):
        while self.peek().kind != "eof":
            desc = self._description()
            kw = self.expect_kind("name").value
            if kw == "schema":
                self.parse_directives()
                self.expect("{")
                while self.peek().value != "}":
                    role = self.expect_kind("name").value
                    self.expect(":")
                    self.roots[role] = self.expect_kind("name").value
                self.next()
            elif kw == "scalar":
                name = self.expect_kind("name").value
                self.parse_directives()
                self._define(name, kind="SCALAR", description=desc)
            elif kw in ("type", "interface"):
                name = self.expect_kind("name").value
                impls = []
                if self.peek().value == "implements":
                    self.next()
                    impls.append(self.expect_kind("name").value)
                    while self.peek().value == "&":
                        self.next()
                        impls.append(self.expect_kind("name").value)
                self.parse_directives()
                fields = self._fields_def()
                self._define(
                    name,
                    kind="OBJECT" if kw == "type" else "INTERFACE",
                    description=desc, field_list=fields, interfaces=[])
                self._implements[name] = impls
            elif kw == "enum":
                name = self.expect_kind("name").value
                self.parse_directives()
                self.expect("{")
                values = []
                while self.peek().value != "}":
                    vdesc = self._description()
                    vname = self.expect_kind("name").value
                    dep, reason = self._directives_deprecation()
                    values.append(IEnumValue(name=vname, description=vdesc,
                                             is_deprecated=dep,
                                             deprecation_reason=reason))
                self.next()
                self._define(name, kind="ENUM", description=desc,
                             enum_value_list=values)
            elif kw == "input":
                name = self.expect_kind("name").value
                self.parse_directives()
                self.expect("{")
                fields = []
                while self.peek().value != "}":
                    fdesc = self._description()
                    fname = self.expect_kind("name").value
                    self.expect(":")
                    typ = self.ref_type()
                    default = None
                    if self.peek().value == "=":
                        self.next()
                        default = serialize_value(self.parse_value(const=True))
                    dep, reason = self._directives_deprecation()
                    fields.append(IInputValue(
                        name=fname, type=typ, description=fdesc,
                        default_value=default, is_deprecated=dep,
                        deprecation_reason=reason))
                self.next()
                self._define(name, kind="INPUT_OBJECT", description=desc,
                             input_fields=fields, is_one_of=False)
            elif kw == "union":
                name = self.expect_kind("name").value
                self.parse_directives()
                self.expect("=")
                members = [self.expect_kind("name").value]
                while self.peek().value == "|":
                    self.next()
                    members.append(self.expect_kind("name").value)
                self._define(name, kind="UNION", description=desc,
                             possible_types=[])
                self._unions[name] = members
            else:
                raise GraphQLError(
                    f"Unexpected SDL keyword {kw!r} at {self.peek().pos}")
        self._link()
        return self

    def _link(self):
        """Resolve implements/union membership into interfaces /
        possible_types lists (both directions)."""
        for tname, impls in self._implements.items():
            t = self.types[tname]
            for iname in impls:
                iface = self.types.get(iname)
                if iface is None:
                    raise GraphQLError(f"Unknown interface {iname!r}")
                t.interfaces.append(iface)
                if iface.possible_types is None:
                    iface.possible_types = []
                if t.kind == "OBJECT":
                    iface.possible_types.append(t)
        for uname, members in self._unions.items():
            u = self.types[uname]
            u.possible_types = [self.types[m] for m in members]


def serialize_value(v: Any) -> str:
    """Serialize a parsed const value back to a GraphQL literal (the
    wire format of __InputValue.defaultValue)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, _Enum):
        return str(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(serialize_value(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {serialize_value(x)}"
                               for k, x in v.items()) + "}"
    raise GraphQLError(f"Cannot serialize default value {v!r}")


# ---------------------------------------------------------------------------
# The introspection meta-schema itself, declared in SDL so the parsed
# type map is self-describing (graphiql's buildClientSchema reads these
# types out of the `types` list like any other).

_META_SDL = """
scalar Int
scalar Float
scalar String
scalar Boolean
scalar ID

type __Schema {
  description: String
  types: [__Type!]!
  queryType: __Type!
  mutationType: __Type
  subscriptionType: __Type
  directives: [__Directive!]!
}

type __Type {
  kind: __TypeKind!
  name: String
  description: String
  specifiedByURL: String
  fields(includeDeprecated: Boolean = false): [__Field!]
  interfaces: [__Type!]
  possibleTypes: [__Type!]
  enumValues(includeDeprecated: Boolean = false): [__EnumValue!]
  inputFields(includeDeprecated: Boolean = false): [__InputValue!]
  ofType: __Type
  isOneOf: Boolean
}

enum __TypeKind {
  SCALAR OBJECT INTERFACE UNION ENUM INPUT_OBJECT LIST NON_NULL
}

type __Field {
  name: String!
  description: String
  args(includeDeprecated: Boolean = false): [__InputValue!]!
  type: __Type!
  isDeprecated: Boolean!
  deprecationReason: String
}

type __InputValue {
  name: String!
  description: String
  type: __Type!
  defaultValue: String
  isDeprecated: Boolean!
  deprecationReason: String
}

type __EnumValue {
  name: String!
  description: String
  isDeprecated: Boolean!
  deprecationReason: String
}

type __Directive {
  name: String!
  description: String
  locations: [__DirectiveLocation!]!
  args(includeDeprecated: Boolean = false): [__InputValue!]!
  isRepeatable: Boolean!
}

enum __DirectiveLocation {
  QUERY MUTATION SUBSCRIPTION FIELD FRAGMENT_DEFINITION FRAGMENT_SPREAD
  INLINE_FRAGMENT VARIABLE_DEFINITION SCHEMA SCALAR OBJECT FIELD_DEFINITION
  ARGUMENT_DEFINITION INTERFACE UNION ENUM ENUM_VALUE INPUT_OBJECT
  INPUT_FIELD_DEFINITION
}
"""


def _builtin_directives(types: Dict[str, IType]) -> List[IDirective]:
    boolean = IType(kind="NON_NULL", of_type=types["Boolean"])
    string = types["String"]
    return [
        IDirective(
            name="skip", locations=["FIELD", "FRAGMENT_SPREAD",
                                    "INLINE_FRAGMENT"],
            description="Skips this field or fragment when true.",
            arg_list=[IInputValue(name="if", type=boolean)]),
        IDirective(
            name="include", locations=["FIELD", "FRAGMENT_SPREAD",
                                       "INLINE_FRAGMENT"],
            description="Includes this field or fragment only when true.",
            arg_list=[IInputValue(name="if", type=boolean)]),
        IDirective(
            name="deprecated",
            locations=["FIELD_DEFINITION", "ARGUMENT_DEFINITION",
                       "INPUT_FIELD_DEFINITION", "ENUM_VALUE"],
            description="Marks the schema element as no longer supported.",
            arg_list=[IInputValue(name="reason", type=string,
                                  default_value='"No longer supported"')]),
        IDirective(
            name="specifiedBy", locations=["SCALAR"],
            description="Points to the specification of a custom scalar.",
            arg_list=[IInputValue(
                name="url", type=IType(kind="NON_NULL", of_type=string))]),
    ]


def build_schema(sdl: str) -> ISchema:
    """Parse SDL (plus the meta-schema) into an ISchema."""
    p = SDLParser(tokenize(_META_SDL + sdl)).parse_sdl()
    # A referenced-but-never-defined name parses as a placeholder SCALAR;
    # surface it loudly instead of serving a broken schema.
    undefined = sorted(set(p.types) - p.defined)
    if undefined:
        raise GraphQLError(f"SDL references undefined types: {undefined}")
    return ISchema(
        types=sorted(p.types.values(), key=lambda t: (t.name or "")),
        query_type=p.types[p.roots["query"]],
        mutation_type=(p.types[p.roots["mutation"]]
                       if p.roots.get("mutation") else None),
        subscription_type=(p.types[p.roots["subscription"]]
                           if p.roots.get("subscription") else None),
        directives=_builtin_directives(p.types))


def introspection_resolvers(sdl: str) -> Dict[str, Any]:
    """Resolvers to merge into the query root: ``__schema``, ``__type``."""
    schema = build_schema(sdl)
    by_name = {t.name: t for t in schema.types}

    def resolve_schema(_root, _info):
        return schema

    def resolve_type(_root, _info, name):
        return by_name.get(name)

    return {"__schema": resolve_schema, "__type": resolve_type}
