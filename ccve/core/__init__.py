from ccve.core.chunk import Chunk
from ccve.core.collection import DataCollection

__all__ = ["Chunk", "DataCollection"]
