from repro_torch.serve.colocate import ServeSpec, ServeTraffic, SLOPolicy
from repro_torch.serve.engine import (
    PrefillProgram,
    ServeConfig,
    cache_length,
    fed_sequence,
    generate,
    prefill,
    sample,
    serve_step,
)
from repro_torch.serve.scheduler import ContinuousBatcher, Request
from repro_torch.serve.slots import (FakePrefill, FakeShard, KVSlotManager,
                                     LMShard)
from repro_torch.serve.traffic import (
    DiurnalTraffic,
    PoissonTraffic,
    QueueSim,
    TrafficTrace,
    make_traffic,
    replay_latency_summary,
)

__all__ = ["ContinuousBatcher", "DiurnalTraffic", "FakePrefill", "FakeShard",
           "KVSlotManager", "LMShard", "PoissonTraffic", "PrefillProgram",
           "QueueSim", "Request", "SLOPolicy", "ServeConfig", "ServeSpec",
           "ServeTraffic", "TrafficTrace", "cache_length", "fed_sequence",
           "generate", "make_traffic", "prefill", "replay_latency_summary",
           "sample", "serve_step"]
