"""PyTorch/CUDA port of the PRF system (``repro`` is the JAX reference).

The PRF path — quantile binning, DSI bootstrap, dimension reduction,
level-synchronous growth, OOB weights and weighted voting, for
classification and regression — runs on an NVIDIA H100 through three
hand-written CUDA kernels (``csrc/``): the T_GR histogram, the T_NS
split scan and the fused tree traversal, resident or streamed from host
sample blocks (``config.sample_block > 0``,
``core.api.grow_forest_streamed``), with growth checkpointed every level
and resumed after a crash (``checkpoint``, ``launch.fault``), on one
device or on a vertical-partition mesh of processes over
``torch.distributed`` (``core.distributed``, ``launch.mesh``).
LM serving runs two more (attention, the Mamba-2 SSD scan). Every module mirrors its ``repro`` counterpart by name; the
package imports ``torch`` and ``numpy`` only.
"""
from .core.api import PRFModel, fit_prf_from_draws, train_prf  # noqa: F401
from .core.types import Forest, ForestConfig, GrowthState  # noqa: F401
