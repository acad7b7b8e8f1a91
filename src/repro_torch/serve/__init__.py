from .decode import generate, sample
from .join_server import JoinServer, JoinTicket

__all__ = ["generate", "sample", "JoinServer", "JoinTicket"]
