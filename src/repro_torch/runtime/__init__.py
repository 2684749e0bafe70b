"""Serving runtime of the port (``server.DecodeServer``)."""
