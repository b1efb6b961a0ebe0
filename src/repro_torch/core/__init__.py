"""FLASH-FHE core, ported: heterogeneous clusters, multi-job scheduler, simulator.

The paper's contribution as a composable library:
  hardware   — chip configs (FLASH-FHE + CraterLake/F1+ baselines), area/power
  jobs       — workload descriptions + deep/shallow classifier
  planner    — static instruction-stream generation (the "software driver")
  cache      — hierarchical L1/L2 SRAM model
  simulator  — cycle-level throughput model over instruction streams
  scheduler  — multi-job placement: 1 shallow job/affiliation, deep = all
               bootstrappable clusters, priority preemption (a thin wrapper
               over the discrete-event engine in repro_torch.serve)
  executor   — one shallow job per cluster affiliation, one CUDA stream per
               affiliation on the card, numerically real
"""

from . import cache, executor, hardware, jobs, planner, scheduler, simulator  # noqa: F401
