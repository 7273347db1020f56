"""Serverless cost models.

Port of ``repro/core/cost.py``.  ``alibaba_cost`` is Eqn. (1) of the paper
with the published unit prices (Alibaba Cloud Function Compute, GPU
instances); :class:`CostMeter` accumulates it per invocation.
:class:`GPUCostModel` prices the same objective in card-seconds.  The JAX
package's ``TPUCostModel`` carries a TPU v5e list price; this model
carries none, so the caller states the card's hourly price.
"""
from __future__ import annotations

import dataclasses
import threading

# unit prices from Section III-B
P_C = 2.138e-5        # $ / vCPU-second
P_M = 2.138e-5        # $ / GB(mem)-second
P_G = 1.05e-4         # $ / GB(GPU mem)-second
P_REQ = 2e-7          # $ / request


def alibaba_cost(t_f: float, n_vcpu: float = 2.0, mem_gb: float = 4.0,
                 gpu_mem_gb: float = 6.0) -> float:
    """Eqn. (1): C = T_f * (n_C P_C + m_M P_M + m_G P_G) + P_req."""
    return t_f * (n_vcpu * P_C + mem_gb * P_M + gpu_mem_gb * P_G) + P_REQ


def rate_per_second(n_vcpu: float = 2.0, mem_gb: float = 4.0,
                    gpu_mem_gb: float = 6.0) -> float:
    return n_vcpu * P_C + mem_gb * P_M + gpu_mem_gb * P_G


@dataclasses.dataclass(frozen=True)
class GPUCostModel:
    """Card-second pricing for a function on ``chips`` cards at
    ``usd_per_chip_hour`` (no default: the caller names its price)."""

    usd_per_chip_hour: float
    chips: int = 1                    # cards in one function instance
    p_req: float = P_REQ

    def cost(self, t_f: float) -> float:
        return t_f * self.chips * self.usd_per_chip_hour / 3600.0 + self.p_req


@dataclasses.dataclass
class CostMeter:
    """Accumulates per-invocation costs (Fig. 8 / Fig. 12 accounting).

    Platforms that share one meter may charge it from several threads, so
    the accumulation happens under a lock; ``total``, ``invocations`` and
    ``busy_seconds`` stay plain readable fields.
    """

    n_vcpu: float = 2.0
    mem_gb: float = 4.0
    gpu_mem_gb: float = 6.0
    total: float = 0.0
    invocations: int = 0
    busy_seconds: float = 0.0

    def __post_init__(self):
        self._lock = threading.Lock()

    def charge(self, t_f: float) -> float:
        c = alibaba_cost(t_f, self.n_vcpu, self.mem_gb, self.gpu_mem_gb)
        with self._lock:
            self.total += c
            self.invocations += 1
            self.busy_seconds += t_f
        return c
