from .base import ALIASES, ARCH_IDS, PORTED, get, get_smoke, register

__all__ = ["ALIASES", "ARCH_IDS", "PORTED", "get", "get_smoke", "register"]
