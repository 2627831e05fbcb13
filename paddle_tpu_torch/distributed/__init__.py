"""paddle_tpu_torch.distributed — so far the rendezvous store
(``tcp_store.py``); the collectives, meshes and parallel layers of the
JAX package's ``distributed/`` come in a later slice."""
from .tcp_store import StoreCorruptValue, StoreTimeout, TCPStore

__all__ = ["TCPStore", "StoreTimeout", "StoreCorruptValue"]
