"""The paper's own model: 3-conv CNN (16/12/10 filters) for 28x28 inputs.

Used by the faithful reproduction of Tables 1-2 (HFL vs AFL vs CFL on
MNIST-like / Fashion-MNIST-like data).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    arch_type: str = "cnn"
    source: str = "paper §2.4 Figure 7"
    image_size: int = 28
    in_channels: int = 1
    num_classes: int = 10


CONFIG = CNNConfig()
