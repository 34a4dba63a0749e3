"""TN-KDE core of the PyTorch port: build-once, query-many temporal network
KDE answering on an NVIDIA GPU.

Public entry point: ``TNKDE``, plus the individual pieces for power users
(RangeForest, kernel decompositions, lixel sharing). Module names mirror
``repro.core`` (the JAX reference package); ``torch_engine`` is the
counterpart of ``jax_engine``.
"""
from .events import Events, EdgeEvents, group_events_by_edge  # noqa: F401
from .kernels_math import get_kernel  # noqa: F401
from .network import Lixels, RoadNetwork, build_lixels  # noqa: F401
from .tnkde import TNKDE, PendingQuery, QueryStats  # noqa: F401
from .wal import RecoveryReport, WalError, WriteAheadLog  # noqa: F401
