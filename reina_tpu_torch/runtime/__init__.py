"""Serving runtime: result cache, simulation workers, GraphQL API (port
of reina_tpu/runtime)."""
