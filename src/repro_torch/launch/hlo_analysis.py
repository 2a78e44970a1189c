"""Roofline terms of a step (port of ``repro.launch.hlo_analysis``).

The reference prices the per-device FLOPs, HBM bytes and collective
bytes it reads from compiled HLO at TPU v5e constants. The port takes
the same three counts from ``launch.hlo_cost.StepCost`` (the step run on
``meta`` tensors) and prices them at a named hardware set, by default
the H100's. The terms are predictions at data-sheet rates, not
measurements.

Hardware sets (``HARDWARE``):

* ``h100-sxm`` (default): NVIDIA H100 80GB HBM3, SXM5, at its 700 W
  limit, dense rates from NVIDIA's H100 data sheet: 989e12 FLOP/s bf16
  (tensor cores, no sparsity), 3.35e12 B/s HBM3. Collectives: 450e9 B/s
  of NVLink 4 a direction (900 GB/s a GPU, both directions) inside one
  NVLink domain, the 8 GPUs of an HGX board; a mesh of more devices
  (pod1's 256 span 32 boards) is priced at the cross-board rate, one
  400 Gb/s NDR InfiniBand port a GPU (50e9 B/s, the DGX H100 layout),
  since its ring collectives cross boards.
* ``tpu-v5e``: the reference's 197e12 FLOP/s, 819e9 B/s HBM, 50e9 B/s
  a link (ICI at every mesh size).

``analyze`` returns the reference's ``roofline``, ``collectives`` and
``memory`` keys. The reference's ``xla_cost_analysis`` (XLA's own
counts, kept beside the HLO model) has no counterpart and is left out;
so are ``memory``'s ``temp_bytes`` and ``generated_code_bytes`` (there
is no compiled buffer assignment or code).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float    # FLOP/s a device
    hbm_bw: float        # bytes/s a device
    link_bw: float       # bytes/s a device, one direction, in a domain
    link: str            # what carries it
    domain: int = 0      # devices a link domain holds (0: any number)
    cross_bw: float = 0.0  # bytes/s a device across domains
    cross_link: str = ""

    def link_rate(self, n_devices: int) -> float:
        """The collective rate of a mesh of ``n_devices``."""
        if self.domain and n_devices > self.domain:
            return self.cross_bw
        return self.link_bw

    def describe(self, n_devices: int) -> dict:
        """What a cell's JSON records of the rates it was priced at."""
        cross = bool(self.domain and n_devices > self.domain)
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw,
                "collective_bw": self.link_rate(n_devices),
                "collective_link": self.cross_link if cross else self.link}


HARDWARE = {
    "h100-sxm": Hardware(
        "NVIDIA H100 80GB HBM3 (SXM5, 700 W)", 989e12, 3.35e12, 450e9,
        "NVLink 4 inside one 8-GPU board", domain=8, cross_bw=50e9,
        cross_link="one 400 Gb/s NDR InfiniBand port a GPU (the mesh "
                   "spans more than one 8-GPU board)"),
    "tpu-v5e": Hardware("TPU v5e", 197e12, 819e9, 50e9, "ICI"),
}
DEFAULT_HW = "h100-sxm"


def hardware(name: str = DEFAULT_HW) -> Hardware:
    if name not in HARDWARE:
        raise KeyError(f"unknown hardware {name!r}; known: {sorted(HARDWARE)}")
    return HARDWARE[name]


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int
    model_flops: float = 0.0
    hw: Hardware = HARDWARE[DEFAULT_HW]

    @property
    def compute_s(self):
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_s(self):
        return self.hbm_bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self):
        return self.collective_bytes_per_device / \
            self.hw.link_rate(self.n_devices)

    @property
    def bottleneck(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self):
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self):
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self):
        """MODEL_FLOPS-based MFU at the roofline step time: the score."""
        if self.step_time_s == 0:
            return 0.0
        return (self.model_flops / self.n_devices / self.step_time_s) \
            / self.hw.peak_flops

    def to_dict(self):
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(cost, model_flops: float, n_devices: int, *,
            collectives: dict = None, argument_bytes: int = 0,
            output_bytes: int = 0, hw: str = DEFAULT_HW) -> dict:
    """Roofline terms from a ``StepCost`` (``collectives``, when given,
    replaces the mode's own: the ranking sweep's come from its mesh)."""
    coll = cost.collectives() if collectives is None else collectives
    rl = Roofline(cost.flops, cost.bytes, coll["total_bytes"], n_devices,
                  model_flops, hardware(hw))
    return {
        "roofline": rl.to_dict(),
        "collectives": coll,
        "memory": {"argument_bytes": int(argument_bytes),
                   "output_bytes": int(output_bytes)},
    }
