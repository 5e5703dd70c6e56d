from .kv import Server, Worker  # noqa: F401
