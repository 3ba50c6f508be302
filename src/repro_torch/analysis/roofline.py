"""Roofline of one rank's step on the H100, from the port's cost count.

Port of ``repro.analysis.roofline``. The reference reads a compiled XLA
artifact (``cost_analysis``, ``memory_analysis`` and the post-SPMD HLO
text); the port has none, and takes instead the ``analysis.count.Count``
of the step run on the meta device:

  compute_s    = Σ_dtype FLOPs(dtype) / peak(dtype)
  memory_s     = bytes / HBM rate
  collective_s = Σ_group collective bytes(group) / link rate(group)

with the H100 SXM's datasheet rates (``H100_SXM``, no measurement): a
group that stays inside one 8-GPU node moves over NVLink, one that spans
nodes over the node's network, one NIC a GPU. The bytes are eager
PyTorch's, op by op and unfused (``analysis.count``), so ``memory_s``
is an upper bound where a fused program would keep values on chip.

The reference's HLO-text parser ``collective_stats`` has no counterpart:
there is no HLO. ``core.reduce`` records each collective as it runs
(kind, result and operand bytes, its group), and
``count.collective_traffic`` applies the parser's byte model to those
records. ``Count.collective_stats`` gives the parser's output format.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

H100_SXM = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 80 GB column, dense
    # (no sparsity). Datasheet figures, not measurements.
    "name": "H100 SXM5 80GB (datasheet)",
    "peak_flops": 989e12,                  # bf16 tensor cores
    "peak_flops_by_dtype": {"bfloat16": 989e12, "float16": 989e12,
                            "float32": 67e12},   # f32 outside tensor cores
    "hbm_bw": 3.35e12,                     # HBM3, bytes/s
    "nvlink_bw": 450e9,                    # NVLink 4, bytes/s a direction
    "nic_bw": 50e9,                        # one 400 Gb/s NIC a GPU (DGX H100)
    "node_gpus": 8,
    "hbm_bytes": 80e9,                     # HBM3, 80 GB
}


def link_bw(ranks, hw: dict = H100_SXM) -> float:
    """The slowest link a group over global ``ranks`` spans: NVLink inside
    one node of ``node_gpus`` consecutive ranks, else the NIC."""
    nodes = {r // hw["node_gpus"] for r in ranks}
    return hw["nvlink_bw"] if len(nodes) == 1 else hw["nic_bw"]


def compute_seconds(flops_by_dtype: dict, hw: dict = H100_SXM) -> float:
    peaks = hw["peak_flops_by_dtype"]
    return sum(n / peaks.get(dt, hw["peak_flops"])
               for dt, n in flops_by_dtype.items())


def collective_seconds(by_group: dict, hw: dict = H100_SXM) -> float:
    return sum(b / link_bw(ranks, hw) for ranks, b in by_group.items())


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float            # per device (the port's count, not HLO)
    hlo_gbytes: float            # per device
    collective_gbytes: float     # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_gflops: float          # 6·N·D useful flops per device
    useful_flops_ratio: float
    collectives: dict = field(default_factory=dict)
    memory_per_device_gb: float = 0.0
    hw: str = H100_SXM["name"]

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def terms(flops_by_dtype: dict, nbytes: float, by_group: dict,
          hw: dict = H100_SXM) -> dict:
    """{"compute", "memory", "collective"} seconds."""
    return {"compute": compute_seconds(flops_by_dtype, hw),
            "memory": nbytes / hw["hbm_bw"],
            "collective": collective_seconds(by_group, hw)}


def analyze(counts, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops_per_device: float = 0.0,
            hw: dict = H100_SXM) -> Roofline:
    """``counts``: the ``analysis.count.Count`` of one rank's step."""
    flops = float(counts.flops)
    t = terms(counts.flops_by_dtype, counts.bytes, counts.by_group(), hw)
    # the step's peak: what the caller and the engine hold, and the most
    # the step held at once (its outputs among it)
    per_dev = counts.arg_bytes + counts.buffer_bytes + counts.temp_peak
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=counts.bytes / 1e9,
        collective_gbytes=counts.collective_bytes / 1e9,
        compute_s=t["compute"], memory_s=t["memory"],
        collective_s=t["collective"], bottleneck=max(t, key=t.get),
        model_gflops=model_flops_per_device / 1e9,
        useful_flops_ratio=(model_flops_per_device / flops) if flops else 0.0,
        collectives=counts.collective_stats(),
        memory_per_device_gb=per_dev / 1e9, hw=hw["name"])


def model_flops(cfg, shape, chips: int) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) per device per step-equivalent."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:
        tokens = shape.global_batch          # one token per sequence
        factor = 2.0
    return factor * n_active * tokens / chips
