"""recsys — a recommender-systems framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
wangruichens/recsys: the Criteo CTR model zoo (FM, DeepFM, DCN,
xDeepFM/CIN, DNN, wide/linear), sequence models
(DIN), collaborative filtering (Multi-VAE/Multi-DAE, CDAE), classical models
(FTRL-proximal LR, GBDT-leaf+LR), plus the full training runtime (sharded
embedding tables, streaming AUC, checkpointing, train/eval driver), data
pipeline (Criteo preprocessing + sharded loaders), and serving stack.

Where the reference delegates to TF1's C++ internals (feature_column hashing,
MirroredStrategy NCCL all-reduce, TFRecord readers), this package provides
its own: a unified offset-packed embedding subsystem sharded over a
`jax.sharding.Mesh`, jit-compiled train steps whose collectives XLA hands to
NCCL, and a native C++ host-side data plane.
"""

__version__ = "0.1.0"

from recsys.core.config import (  # noqa: F401
    CriteoConfig,
    EmbeddingConfig,
    MeshConfig,
    ModelConfig,
    RunConfig,
    TrainConfig,
)
from recsys.core.mesh import MeshEnv, make_mesh  # noqa: F401
