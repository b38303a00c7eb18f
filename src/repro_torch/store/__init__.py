"""Versioned artifact store on PyTorch: content-addressed objects plus delta
chains, committed and checked out through the CUDA block kernels.  Stores
are interchangeable with the JAX package's ``repro.store``."""

from .convert import flat_from_numpy, flat_to_numpy
from .delta import (
    DeltaWire,
    RecreationCostModel,
    SparseLeafDelta,
    apply_delta,
    apply_delta_chain,
    apply_delta_chains,
    decode_delta_wire,
    decode_full,
    encode_delta,
    encode_full,
    flatten_payload,
)
from .materializer import (
    CheckoutPlan,
    CheckoutPlanner,
    MaterializationCache,
    Materializer,
)
from .objectstore import Codec, ObjectStore
from .repository import Ref, Repository, TreeDiff
from .version_store import VersionMeta, VersionStore

__all__ = [
    "Codec",
    "ObjectStore",
    "VersionStore",
    "VersionMeta",
    "Repository",
    "TreeDiff",
    "Ref",
    "Materializer",
    "MaterializationCache",
    "CheckoutPlanner",
    "CheckoutPlan",
    "RecreationCostModel",
    "flatten_payload",
    "encode_full",
    "decode_full",
    "encode_delta",
    "apply_delta",
    "apply_delta_chain",
    "apply_delta_chains",
    "decode_delta_wire",
    "DeltaWire",
    "SparseLeafDelta",
    "flat_from_numpy",
    "flat_to_numpy",
]
