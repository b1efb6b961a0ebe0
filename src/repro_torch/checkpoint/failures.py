"""Fault-tolerance runtime: heartbeats, straggler detection, restart policy.

On a real multi-pod deployment each host runs a HeartbeatMonitor; the trainer
loop consults it each step.  Decisions:
  * missing heartbeat > deadline       → declare host dead → restart from the
    latest committed checkpoint on the surviving mesh (elastic restore);
  * heartbeat slow but alive (straggler) → reassign its data-shard index
    (deterministic pipeline ⇒ any host can recompute any shard) and keep going;
  * repeated stragglers                 → drop-and-continue for non-critical
    (eval) jobs, quarantine list for scheduling.

Tests drive this with a fake clock; nothing here sleeps.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float = 0.0
    slow_strikes: int = 0
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, deadline: float = 60.0,
                 straggle_factor: float = 3.0, strike_limit: int = 3):
        self.hosts = {i: HostState(i) for i in range(n_hosts)}
        self.deadline = deadline
        self.straggle_factor = straggle_factor
        self.strike_limit = strike_limit
        self.median_step_time = 1.0

    def beat(self, host_id: int, now: float, step_time: float | None = None):
        h = self.hosts[host_id]
        h.last_beat = now
        if step_time is not None:
            if step_time > self.straggle_factor * self.median_step_time:
                h.slow_strikes += 1
            else:
                h.slow_strikes = max(0, h.slow_strikes - 1)

    def set_median_step_time(self, t: float):
        self.median_step_time = t

    def check(self, now: float) -> dict:
        """Returns {'dead': [...], 'stragglers': [...], 'quarantine': [...]}."""
        dead, strag, quar = [], [], []
        for h in self.hosts.values():
            if not h.alive:
                continue
            if now - h.last_beat > self.deadline:
                h.alive = False
                dead.append(h.host_id)
            elif h.slow_strikes >= self.strike_limit:
                quar.append(h.host_id)
            elif h.slow_strikes > 0:
                strag.append(h.host_id)
        return {"dead": dead, "stragglers": strag, "quarantine": quar}

    def surviving(self) -> list[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]


@dataclasses.dataclass
class RestartPlan:
    """What the launcher does after a failure event."""

    restore_step: int
    new_shard_of_host: dict  # host → data-shard index (reassigned around dead hosts)
    mesh_hosts: list


def plan_restart(monitor: HeartbeatMonitor, latest_ckpt_step: int) -> RestartPlan:
    alive = monitor.surviving()
    return RestartPlan(
        restore_step=latest_ckpt_step,
        new_shard_of_host={h: i for i, h in enumerate(alive)},
        mesh_hosts=alive,
    )
