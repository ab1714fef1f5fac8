from .base import ALIASES, ARCH_IDS, all_arch_ids, get, get_smoke, register

__all__ = ["ALIASES", "ARCH_IDS", "all_arch_ids", "get", "get_smoke",
           "register"]
