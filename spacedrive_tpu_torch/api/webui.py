"""The embedded web explorer's assets.

Port of ``spacedrive_tpu/api/webui.py``: ``api/static/`` holds byte-for-byte
copies of the JAX package's ``index.html``, ``style.css`` and ``app.js``
(plain JS over the ``/rspc`` WebSocket protocol, no build step); this module
only locates and reads them for ``api/server.py``.
"""

from __future__ import annotations

import os

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "static")


def asset_path(name: str) -> str:
    return os.path.join(STATIC_DIR, name)


def index_html() -> str:
    with open(asset_path("index.html"), encoding="utf-8") as f:
        return f.read()
