from .decode import generate, generate_whisper, sample
from .join_server import JoinServer, JoinTicket

__all__ = ["generate", "generate_whisper", "sample", "JoinServer", "JoinTicket"]
