"""Web frontend: chat + knowledge-base UI and the chain-server client (a
port of the reference package's ``frontend`` package). The UI is
first-party HTML/JS served by aiohttp (``server.create_app``) at
``/content/converse`` and ``/content/kb``, talking to the chain server's
API through ``ChatClient``.
"""

from .chat_client import ChatClient

__all__ = ["ChatClient"]
