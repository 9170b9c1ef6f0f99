"""Dense retrieval indexes of the port (counterpart of
lightningdot_tpu/index): the exact inner-product index on the card (or
sharded over a device mesh) and the host-side native HNSW, with the API
of dvl/indexer/faiss_indexers.py (``index_data``, ``search_knn``,
``serialize``/``deserialize_from``)."""

from lightningdot_tpu_torch.index.dense import (  # noqa: F401
    DenseFlatIndex, DenseFlatIndexer, DenseShardedIndex)
from lightningdot_tpu_torch.index.hnsw import DenseHNSWFlatIndexer  # noqa: F401
