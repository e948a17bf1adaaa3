"""The node's API: the rspc router, its procedures and the HTTP/WebSocket host."""

from .router import Procedure, Router, RpcError, mount_router

__all__ = ["Router", "Procedure", "RpcError", "mount_router"]
