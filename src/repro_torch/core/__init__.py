# The paper's primary contribution — the Helix iterative-execution optimizer
# as a composable library: Workflow DAG + change tracking (signatures) +
# OPT-EXEC-PLAN (max-flow) + OPT-MAT-PLAN (streaming heuristic) + the
# execution engine with a content-addressed, place-on-load store.
#
# Twin of the JAX package's ``core`` module for module, on torch tensors
# (CPU or CUDA) and numpy arrays; ``tree`` stands in for
# ``jax.tree_util``. ``sweep`` and ``search`` are clients of the session
# server in ``repro_torch.serve``.
from .config import (EngineConfig, ResilienceConfig, StoreConfig,
                     reset_legacy_warnings)
from .dag import DAG, Kind, Node, State, validate_states
from .signature import compute_signatures, source_version
from .oep import plan, plan_runtime, brute_force_plan
from .omp import Materializer, Policy, cumulative_runtime
from .eviction import EvictionStats, Evictor
from .remote import (FsObjectStore, ObjectStore, RemoteStats, RemoteStore,
                     TransientBackendError, as_remote_store)
from .faults import ChaosObjectStore, FaultPlan, InjectedCrash
from .store import ComputeLease, ReadPin, Store, tree_nbytes
from .locking import FileLock, SharedEwma, StorageLedger
from .costs import CostModel
from .executor import ExecutionReport, JobCancelled, execute
from .workflow import Ref, Workflow
from .session import IterationReport, IterativeSession
from .pruning import slice_from_outputs, zero_weight_extractors
from .sweep import (SweepReport, SweepVariant, VariantResult, grid,
                    random_search, run_sweep)
from .search import (ArmResult, HalvingConfig, SearchConfig, SearchDriver,
                     SearchReport, tune)

__all__ = [
    "EngineConfig", "ResilienceConfig", "StoreConfig",
    "reset_legacy_warnings",
    "DAG", "Kind", "Node", "State", "validate_states",
    "compute_signatures", "source_version",
    "plan", "plan_runtime", "brute_force_plan",
    "Materializer", "Policy", "cumulative_runtime",
    "EvictionStats", "Evictor",
    "FsObjectStore", "ObjectStore", "RemoteStats", "RemoteStore",
    "TransientBackendError", "as_remote_store",
    "ChaosObjectStore", "FaultPlan", "InjectedCrash",
    "ComputeLease", "ReadPin", "Store", "tree_nbytes", "CostModel",
    "FileLock", "SharedEwma", "StorageLedger",
    "ExecutionReport", "JobCancelled", "execute",
    "Ref", "Workflow",
    "slice_from_outputs", "zero_weight_extractors",
    "IterationReport", "IterativeSession",
    "SweepReport", "SweepVariant", "VariantResult",
    "grid", "random_search", "run_sweep",
    "ArmResult", "HalvingConfig", "SearchConfig", "SearchDriver",
    "SearchReport", "tune",
]
