"""Live introspection over a serving engine — see :mod:`.server`."""

from .server import ObsServer, serve

__all__ = ["ObsServer", "serve"]
