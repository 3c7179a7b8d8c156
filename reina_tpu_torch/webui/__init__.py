"""Interactive web UI (reference: corona.py Dash app + components/),
served by the port's GraphQL server.

``app.html`` is a byte-for-byte copy of the JAX package's page
(tests/test_torch_config.py holds the two equal): a dependency-free
single-page app with scenario selector, intervention table editor, run
button, streamed result charts and the parameter explorer. State lives
in the signed session cookie the GraphQL API uses.
"""
import os

APP_HTML_PATH = os.path.join(os.path.dirname(__file__), "app.html")


def app_html() -> bytes:
    with open(APP_HTML_PATH, "rb") as f:
        return f.read()
