"""The paper's own experimental model, the port's own copy.

Ports ``ResNetConfig``, ``CONFIG``, ``CAPACITY_BETAS`` and ``reduced`` of
``repro/configs/resnet18_cifar.py``, with the same names and defaults: a
pre-activated ResNet18 on CIFAR, modified per Section 5.1 (static batch
norm and a scalar module after each convolution), width-scalable for the
HeteroFL client capacities beta in {1, 1/2, 1/4, 1/8, 1/16}.
"""
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18-cifar"
    stages: tuple = (2, 2, 2, 2)       # pre-act ResNet18 block counts
    width: int = 64                    # stage-0 channels
    n_classes: int = 10
    image_size: int = 32
    in_channels: int = 3
    scaler: bool = True                # per-conv scalar module (paper §5.1)
    source: str = "paper §5.1 (He et al. pre-act ResNet18 + HeteroFL mods)"


CONFIG = ResNetConfig()

# The HeteroFL capacity mix of this config: the default capacity
# distribution of ``PaperExperiment.capacities`` and of the
# ``repro_torch.launch.experiment`` capacity-mix sweep.
CAPACITY_BETAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


def reduced():
    # ResNet-8-ish: 1 block/stage, width 8, 16x16 inputs -- CPU-friendly.
    return replace(CONFIG, name="resnet8-cifar-reduced", stages=(1, 1, 1),
                   width=8, image_size=16)
