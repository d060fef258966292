from repro_torch.het.simulator import (
    WORKLOADS,
    ClusterSim,
    WorkerSpec,
    WorkloadModel,
    amdahl_speedup,
    hlevel_cluster,
    homogeneous_cluster,
    mixed_gpu_cpu_cluster,
)

__all__ = [
    "WORKLOADS",
    "ClusterSim",
    "WorkerSpec",
    "WorkloadModel",
    "amdahl_speedup",
    "hlevel_cluster",
    "homogeneous_cluster",
    "mixed_gpu_cpu_cluster",
]
