"""AISQL core: the paper's contribution (operators + AI-aware engine)."""
from repro_torch.core.engine import (  # noqa: F401
    AisqlEngine, OperatorReport, QueryReport)
from repro_torch.core.stats import (  # noqa: F401
    PredObservation, StatsStore, predicate_fingerprint,
    predicate_prompt_text)
from repro_torch.core.cost import CostDefaults, TransferredPrior  # noqa: F401
from repro_torch.core.cascade import (  # noqa: F401
    CascadeConfig, SupgItCascade, CalibratedCascade)
from repro_torch.core.optimizer import (  # noqa: F401
    Optimizer, OptimizerConfig, PlanMemo, plan_fingerprint)
from repro_torch.core.executor import ExecConfig, Executor  # noqa: F401
from repro_torch.core.sqlparse import ParseError, parse  # noqa: F401
from repro_torch.core.aggregate import (  # noqa: F401
    AggConfig, HierarchicalAggregator)
from repro_torch.core.cost import Catalog, CostModel  # noqa: F401
from repro_torch.core.serving import (  # noqa: F401
    AdmissionError, QuerySession, QueryTicket, ServingConfig, ServingEngine,
    ServingReport, TenantPolicy, TenantReport, TenantStatsStore)
from repro_torch.semindex import (  # noqa: F401
    EmbeddingStore, IvfFlatIndex, SemanticIndexManager, SemIndexConfig)
