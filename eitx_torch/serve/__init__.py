from .http import EitxHTTPServer, make_server

__all__ = ["EitxHTTPServer", "make_server"]
