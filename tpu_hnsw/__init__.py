"""tpu-hnsw: an HNSW index-and-query engine in JAX/XLA.

Built from scratch with the capabilities of the reference repo
``dhwodnjs/pgvector-hnsw-partitioning`` (a pgvector-derived
HNSW-partitioning project). It runs on an NVIDIA H100 through JAX/XLA,
and on the CPU for tests. See SURVEY.md at the repo root for the layer
map and the reference-to-JAX translation.
"""

import os as _os
import pathlib as _pathlib


def _enable_compile_cache() -> None:
    """Keep JAX's persistent compilation cache at one fixed path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    nothing is set here. Otherwise the cache is ``<checkout>/.jax_cache``
    (gitignored): the path is part of the cache key, so it must not move
    between runs.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update(
        "jax_compilation_cache_dir",
        str(_pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"))


_enable_compile_cache()

from tpu_hnsw.config import HnswConfig, Metric
from tpu_hnsw.index.binary import BinaryHnswIndex
from tpu_hnsw.index.block import BlockHnswIndex
from tpu_hnsw.index.flat import FlatIndex
from tpu_hnsw.index.hnsw import HnswIndex
from tpu_hnsw.index.ivf import IvfFlatIndex
from tpu_hnsw.ops.bitops import BinaryFlatIndex
from tpu_hnsw.index.sparse_ann import SparseHnswIndex
from tpu_hnsw.ops.sparse import SparseFlatIndex, SparseVecs
from tpu_hnsw.parallel.partition import PartitionedHnswIndex
from tpu_hnsw.planner import EnginePlan, HardwareModel, choose_engine

__all__ = [
    "HnswConfig", "Metric", "FlatIndex", "HnswIndex", "BlockHnswIndex",
    "IvfFlatIndex", "PartitionedHnswIndex", "SparseVecs", "SparseFlatIndex",
    "SparseHnswIndex",
    "BinaryHnswIndex", "BinaryFlatIndex", "choose_engine", "EnginePlan",
    "HardwareModel",
]
__version__ = "0.3.0"
