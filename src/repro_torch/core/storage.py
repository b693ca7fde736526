"""Storage device/interface models and the paper's query-time cost model.

Reproduces, as an analysis framework (paper Sec. 4.1):

    T_sync  = T_compute + N_io * (T_request + T_read)                  (Eq. 6)
    T_async = max(T_compute + N_io * T_request,  N_io * T_read)        (Eq. 7)

and the derived storage requirements:

    sync:   T_read^-1  >= N_io / (T_target - T_compute)                (Eq. 9)
    async:  T_request^-1 >= N_io / (T_target - T_compute)              (Eq. 10)
            T_read^-1  >= N_io / T_target                              (Eq. 11)
    in-memory target with the 10% memory-stall correction (Sec. 4.5):
            T_request^-1 >= 10 * N_io / T_E2LSH                        (Eq. 16)

Device constants are the paper's measured values (Tables 2, 3, 5). All times
in seconds, rates in IOPS.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "StorageDevice", "StorageInterface", "StorageConfig",
    "DEVICES", "INTERFACES", "TABLE5_CONFIGS",
    "t_sync", "t_async", "t_async_at_qd", "model_qd_sweep",
    "required_iops_sync", "required_iops_async",
    "required_request_rate_async", "inmem_request_rate_requirement",
]


@dataclasses.dataclass(frozen=True)
class StorageDevice:
    """Random-read performance at queue depth 1 / 128 (paper Table 2)."""

    name: str
    iops_qd1: float
    iops_qd128: float
    capacity_tb: float

    def t_read(self, *, async_io: bool) -> float:
        return 1.0 / (self.iops_qd128 if async_io else self.iops_qd1)

    def iops_at_qd(self, qd: int) -> float:
        """Random-read IOPS at queue depth ``qd``, interpolated between the
        paper's two measured anchor points (Table 2): a device with QD1
        latency ``1/iops_qd1`` sustains ~``qd`` overlapped reads until it
        saturates at its QD128 rate — the standard Little's-law shape of
        the paper's Fig. 4-8 requirement curves."""
        return min(self.iops_qd128, max(1, int(qd)) * self.iops_qd1)


@dataclasses.dataclass(frozen=True)
class StorageInterface:
    """CPU time per I/O request (paper Table 3)."""

    name: str
    t_request: float

    @property
    def max_iops_per_core(self) -> float:
        return 1.0 / self.t_request


DEVICES = {
    "cssd": StorageDevice("cSSD (KIOXIA XG5, NVMe PCIe3)", 7.2e3, 273e3, 2.0),
    "essd": StorageDevice("eSSD (KIOXIA FL6, NVMe PCIe4)", 27.6e3, 1400e3, 0.8),
    "xlfdd": StorageDevice("XLFDD (XL-FLASH demo drive)", 132.3e3, 3860e3, 0.52),
    "hdd": StorageDevice("HDD (Seagate IronWolf 7200rpm)", 0.21e3, 0.54e3, 10.0),
}

INTERFACES = {
    "io_uring": StorageInterface("io_uring 2.0", 1.0e-6),
    "spdk": StorageInterface("SPDK 21.10", 350e-9),
    "xlfdd": StorageInterface("XLFDD interface", 50e-9),
}


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """A device x count x interface combination (paper Table 5 / Fig. 11)."""

    device: StorageDevice
    count: int
    interface: StorageInterface

    @property
    def total_iops(self) -> float:
        return self.device.iops_qd128 * self.count

    @property
    def total_capacity_tb(self) -> float:
        return self.device.capacity_tb * self.count

    @property
    def name(self) -> str:
        return f"{self.device.name.split(' ')[0]}x{self.count}+{self.interface.name.split(' ')[0]}"


TABLE5_CONFIGS = [
    StorageConfig(DEVICES["cssd"], 1, INTERFACES["io_uring"]),
    StorageConfig(DEVICES["cssd"], 1, INTERFACES["spdk"]),
    StorageConfig(DEVICES["cssd"], 4, INTERFACES["io_uring"]),
    StorageConfig(DEVICES["cssd"], 4, INTERFACES["spdk"]),
    StorageConfig(DEVICES["essd"], 1, INTERFACES["io_uring"]),
    StorageConfig(DEVICES["essd"], 1, INTERFACES["spdk"]),
    StorageConfig(DEVICES["essd"], 8, INTERFACES["io_uring"]),
    StorageConfig(DEVICES["essd"], 8, INTERFACES["spdk"]),
    StorageConfig(DEVICES["xlfdd"], 12, INTERFACES["xlfdd"]),
]


def t_sync(t_compute: float, n_io: float, cfg: StorageConfig) -> float:
    """Eq. 6 — synchronous external-memory query time (queue depth 1)."""
    return t_compute + n_io * (cfg.interface.t_request + cfg.device.t_read(async_io=False))


def t_async(t_compute: float, n_io: float, cfg: StorageConfig) -> float:
    """Eq. 7 — asynchronous: max(CPU lane, storage lane). Multi-device configs
    divide the storage lane by the aggregate IOPS."""
    cpu_lane = t_compute + n_io * cfg.interface.t_request
    storage_lane = n_io / cfg.total_iops
    return max(cpu_lane, storage_lane)


def t_async_at_qd(t_compute: float, n_io: float, cfg: StorageConfig,
                  qd: int) -> float:
    """Eq. 7 evaluated at a finite queue depth: the storage lane runs at
    the device's QD-``qd`` rate instead of its saturated QD128 rate. At
    ``qd=1`` this degenerates to (roughly) the synchronous discipline's
    storage behavior; at the saturation depth it equals :func:`t_async` —
    the model-side hook the measured QD sweep compares against."""
    cpu_lane = t_compute + n_io * cfg.interface.t_request
    storage_lane = n_io / (cfg.device.iops_at_qd(qd) * cfg.count)
    return max(cpu_lane, storage_lane)


def model_qd_sweep(t_compute: float, n_io: float, cfg: StorageConfig,
                   qds) -> list:
    """The model's side of the measured QD sweep: per queue depth, the
    Eq. 6/7 prediction at the SAME N_io — T_async at that depth, the fixed
    T_sync baseline, and their ratio (the paper's headline sync-vs-async
    number as a function of queue depth)."""
    ts = t_sync(t_compute, n_io, cfg)
    out = []
    for qd in qds:
        ta = t_async_at_qd(t_compute, n_io, cfg, qd)
        out.append(dict(qd=int(qd), t_async_us=ta * 1e6, t_sync_us=ts * 1e6,
                        slowdown_sync_vs_async=ts / ta,
                        device_iops=cfg.device.iops_at_qd(qd) * cfg.count))
    return out


def required_iops_sync(t_target: float, t_compute: float, n_io: float) -> float:
    """Eq. 9 — required device IOPS, synchronous case."""
    denom = t_target - t_compute
    return math.inf if denom <= 0 else n_io / denom


def required_iops_async(t_target: float, n_io: float) -> float:
    """Eq. 11 — required aggregate random-read IOPS, asynchronous case."""
    return math.inf if t_target <= 0 else n_io / t_target


def required_request_rate_async(t_target: float, t_compute: float, n_io: float) -> float:
    """Eq. 10 — required 1/T_request (max IOPS/core), asynchronous case."""
    denom = t_target - t_compute
    return math.inf if denom <= 0 else n_io / denom


def inmem_request_rate_requirement(t_e2lsh: float, n_io: float) -> float:
    """Eq. 16 — requirement to reach in-memory speed; uses the paper's
    measured ~10% memory-stall correction T_compute = 0.9 * T_E2LSH."""
    return 10.0 * n_io / t_e2lsh


def mmap_sync_model(t_compute: float, n_io: float, cfg: StorageConfig,
                    page_miss_rate: float = 0.93, page_overhead: float = 2.5e-6) -> float:
    """Sec. 6.5 comparison point: memory-mapped synchronous I/O through the
    page cache. Every miss pays device latency (QD~1) plus kernel page-fault
    overhead; hit rate is low because the access pattern is random."""
    t_fault = cfg.device.t_read(async_io=False) + page_overhead
    return t_compute + n_io * page_miss_rate * t_fault
