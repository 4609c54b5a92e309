"""Hardware timing/energy constants for the DIMM-NDP performance model.

The container has no DIMM-NDP (or TPU) hardware; this module plays the role
UniNDP plays in the paper — a calibrated performance model driven by real
search traces.  Constants follow Table II (DDR5-4800, 2 DIMMs/channel,
2 ranks/DIMM, 2 sub-channels/rank, VPE+LNC per sub-channel @1.2 GHz) and
standard DDR5/28nm literature numbers.  Platform baselines (CPU / CPU-HP /
GPU A100) are analytical roofline models of the same search trace.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NDPConfig:
    name: str = "naszip-2ch"
    n_channels: int = 2              # memory channels
    dimms_per_channel: int = 2
    ranks_per_dimm: int = 2
    subch_per_rank: int = 2
    # DDR5-4800 per sub-channel: 32-bit bus (4 devices x 8b) -> 19.2 GB/s
    subch_bw_gbps: float = 19.2
    burst_bytes: int = 64            # 4 devices x 128b burst
    t_row_open_ns: float = 28.0      # tRCD-ish stream-setup cost per list/vector
    vpe_freq_ghz: float = 1.2
    vpe_lanes: int = 4               # one per device (Fig. 10c)
    # caches (Fig. 13)
    lnc_t_bytes: int = 8 * 1024
    lnc_d_bytes: int = 256 * 1024
    lnc_ways_d: int = 8
    line_bytes: int = 64
    cache_hit_ns: float = 0.9
    # far-memory channel for the residual tier (storage="tiered"): the
    # coarse tier streams from the sub-channel's near DRAM at full burst
    # rate; residual words of non-exited lanes arrive over a narrower
    # expansion link (CXL-class) with a per-fetch latency that a small
    # prefetch queue amortizes across in-flight survivors
    far_latency_ns: float = 180.0
    far_bw_gbps: float = 12.8
    far_prefetch_depth: int = 4
    # varint neighbor-list decoder: the LNC front-end decodes sorted-delta
    # LEB128 ids serially — this many cycles per decoded id, vs the dense
    # path's one 4B id per cycle line consumption
    varint_decode_cycles_per_id: float = 2.0
    # host interaction
    host_cmd_ns: float = 120.0       # per-hop command dispatch (control, Fig. 4a)
    host_merge_base_ns: float = 260.0  # per-hop global merge latency
    host_merge_per_cand_ns: float = 6.0
    host_nlt_lookup_ns: float = 340.0  # CPU-side neighbor lookup (non-DaM path)
    cross_channel_ns_per_line: float = 95.0  # via host, per 64B line
    # energy (literature constants; 28nm logic + DDR5 I/O)
    e_dram_pj_per_bit: float = 14.0
    e_fpu_pj_per_feature: float = 3.2
    e_cache_pj_per_bit: float = 0.12
    e_host_nj_per_hop: float = 18.0

    @property
    def n_subchannels(self) -> int:
        return (self.n_channels * self.dimms_per_channel * self.ranks_per_dimm
                * self.subch_per_rank)

    @property
    def t_burst_ns(self) -> float:
        return self.burst_bytes / self.subch_bw_gbps

    @property
    def t_feature_ns(self) -> float:
        """VPE consumes one feature per lane per cycle (Fig. 10c)."""
        return 1.0 / (self.vpe_freq_ghz * self.vpe_lanes)


NASZIP_2CH = NDPConfig()
NASZIP_6CH = dataclasses.replace(NDPConfig(), name="naszip-6ch", n_channels=6)


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    """Analytical roofline baseline (Fig. 3 / Fig. 15-16 competitors)."""
    name: str
    mem_bw_gbps: float           # effective streaming bandwidth
    flops_gflops: float          # effective f32 throughput
    traversal_ns_per_hop: float  # queue/neighbor bookkeeping on the platform
    batch_parallel: int          # concurrent queries the platform sustains
    e_mem_pj_per_bit: float
    e_fpu_pj_per_feature: float
    e_static_w: float            # static/idle power amortized over queries


CPU_BASELINE = PlatformConfig("cpu-hnsw", 48.0, 180.0, 450.0, 32, 14.0, 8.0, 120.0)
CPU_SCANN = PlatformConfig("cpu-scann", 48.0, 700.0, 160.0, 32, 14.0, 2.5, 120.0)
CPU_HP = PlatformConfig("cpu-hp-96c", 140.0, 2100.0, 160.0, 96, 14.0, 2.5, 360.0)
GPU_A100 = PlatformConfig("gpu-cagra", 1555.0, 19500.0, 25.0, 4096, 7.0, 1.1, 300.0)
ANNA_ASIC = PlatformConfig("anna-asic", 410.0, 8000.0, 40.0, 512, 9.0, 0.9, 40.0)
PIMANN_UPMEM = PlatformConfig("pimann-upmem", 2100.0, 900.0, 900.0, 2048, 22.0, 18.0, 280.0)
DFGAS_FPGA = PlatformConfig("dfgas-fpga", 460.0, 3500.0, 60.0, 256, 11.0, 2.0, 90.0)
