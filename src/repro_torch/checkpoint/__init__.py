"""Delta checkpoints of torch pytrees in the device store."""
from .store import (CHUNK_BYTES, AsyncCheckpointer, CheckpointStore,
                    store_config)

__all__ = ["CHUNK_BYTES", "AsyncCheckpointer", "CheckpointStore",
           "store_config"]
