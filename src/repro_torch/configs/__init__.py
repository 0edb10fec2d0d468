from .archs import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "get_config", "smoke_config"]
