"""Small host-side utilities shared across the port."""

from .besseli0 import besseli0
from .misc import next_fast_len
from .timer import Timer

__all__ = ["besseli0", "next_fast_len", "Timer"]
