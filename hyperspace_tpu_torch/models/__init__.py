from .covering import CoveringIndex, CoveringIndexConfig

__all__ = ["CoveringIndex", "CoveringIndexConfig"]
