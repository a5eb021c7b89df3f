"""Step-driven serving engine with stored-KV-cache reuse (plan/execute API)."""
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.planner import (  # noqa: F401
    AlwaysReusePlanner,
    CostAwarePlanner,
    ReusePlan,
    ReusePlanner,
    StoreLookup,
)
from repro_torch.serving.request import Request  # noqa: F401
