"""GraphQL API (port of reina_tpu/runtime/graphql; reference:
graphql_schema.py + graphql_backend.py).

A small spec-subset GraphQL engine (lexer, parser, executor in
``engine.py``), the REINA schema (``schema.py``) and a stdlib HTTP
server (``server.py``). The query/mutation surface matches the JAX
package's one-to-one, so the web UI and the reina-ui frontend work
against either server.
"""

from .engine import GraphQLError, execute, parse  # noqa: F401
from .schema import SCHEMA  # noqa: F401
