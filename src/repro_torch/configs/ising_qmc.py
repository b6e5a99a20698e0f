"""The paper's own workload: layered QMC Ising models under parallel
tempering (D-Wave AQUA@Home production shape).

Paper §4: 115 Ising models x 24576 spins (256 layers x 96 spins),
30000 Metropolis sweeps.  The TPU mapping interlaces the 256 layers across
the 128 vector lanes (2 layers/section), so one replica's state is a
(192, 128) f32 tile — the direct analogue of the paper's 4-way SSE /
128-way GPU coalescing layouts.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class IsingConfig:
    name: str = "ising-qmc"
    family: str = "ising"
    spins_per_layer: int = 96
    num_layers: int = 256
    num_models: int = 115
    num_sweeps: int = 30000
    lanes: int = 128
    beta_min: float = 0.1
    beta_max: float = 3.0
    exp_flavor: str = "fast"
    seed: int = 0

    @property
    def spins_per_model(self) -> int:
        return self.spins_per_layer * self.num_layers

    @property
    def total_spins(self) -> int:
        return self.spins_per_model * self.num_models


CONFIG = IsingConfig()


def smoke_config() -> IsingConfig:
    return dataclasses.replace(
        CONFIG, spins_per_layer=6, num_layers=256, num_models=3, num_sweeps=2
    )
