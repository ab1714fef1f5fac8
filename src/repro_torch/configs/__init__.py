from .base import ALIASES, ARCH_IDS, PORTED, all_arch_ids, get, get_smoke, \
    register

__all__ = ["ALIASES", "ARCH_IDS", "PORTED", "all_arch_ids", "get",
           "get_smoke", "register"]
