"""Step-driven serving engine with stored-KV-cache reuse (plan/execute API)."""
from repro_torch.serving import audit  # noqa: F401
from repro_torch.serving.cluster import ClusterConfig, ServingCluster  # noqa: F401
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.planner import (  # noqa: F401
    AlwaysReusePlanner,
    BlendPlanner,
    CostAwarePlanner,
    ReusePlan,
    ReusePlanner,
    StoreLookup,
)
from repro_torch.serving.request import Request  # noqa: F401
from repro_torch.serving.trace import (  # noqa: F401
    TraceWriter,
    read_events,
    read_tagged_events,
    read_trace,
)
from repro_torch.serving.router import (  # noqa: F401
    AffinityRouter,
    BloomDigest,
    ConsistentHashRing,
    ReplicaView,
    RoundRobinRouter,
    RouteDecision,
)
