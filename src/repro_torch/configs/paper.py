"""The paper's own experimental configurations (C3-SL Sec. 4.1).

These drive the Table 1 / Table 2 reproduction benchmarks:
  * VGG-16 on CIFAR-10,  split at the 4th max-pool  -> D = 2048
  * ResNet-50 on CIFAR-100, split after stage 3     -> D = 4096
  * batch size 64, Adam lr=1e-4, R in {2,4,8,16}
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperSplitConfig:
    name: str
    model: str            # "vgg16" | "resnet50"
    dataset: str          # "cifar10" | "cifar100"
    n_classes: int
    cut_shape: tuple      # (C, H, W) at the split
    batch_size: int = 64
    lr: float = 1e-4

    @property
    def D(self) -> int:
        c, h, w = self.cut_shape
        return c * h * w


VGG16_CIFAR10 = PaperSplitConfig(
    name="vgg16-cifar10", model="vgg16", dataset="cifar10", n_classes=10,
    cut_shape=(512, 2, 2))

RESNET50_CIFAR100 = PaperSplitConfig(
    name="resnet50-cifar100", model="resnet50", dataset="cifar100",
    n_classes=100, cut_shape=(1024, 2, 2))

PAPER_RS = (2, 4, 8, 16)

# Paper Table 1 reference values (for the analytic reproduction check)
TABLE1 = {
    # (config, R): (accuracy_%, params_x1e3, flops_x1e9)
    ("vgg16-cifar10", "vanilla"): (89.9, None, None),
    ("vgg16-cifar10", 2): (90.3, 4.1, 0.54),
    ("vgg16-cifar10", 4): (90.0, 8.2, 0.54),
    ("vgg16-cifar10", 8): (89.9, 16.4, 0.54),
    ("vgg16-cifar10", 16): (89.6, 32.8, 0.54),
    ("resnet50-cifar100", "vanilla"): (63.1, None, None),
    ("resnet50-cifar100", 2): (63.4, 8.2, 2.15),
    ("resnet50-cifar100", 4): (63.3, 16.4, 2.15),
    ("resnet50-cifar100", 8): (62.8, 32.8, 2.15),
    ("resnet50-cifar100", 16): (62.3, 65.5, 2.15),
}

TABLE1_BOTTLENET = {
    ("vgg16-cifar10", 2): (90.5, 2360.0, 1.21),
    ("vgg16-cifar10", 4): (90.4, 2098.2, 0.67),
    ("vgg16-cifar10", 8): (89.8, 1049.3, 0.34),
    ("vgg16-cifar10", 16): (89.6, 524.9, 0.17),
    ("resnet50-cifar100", 2): (63.6, 9438.7, 4.83),
    ("resnet50-cifar100", 4): (62.9, 8390.7, 2.68),
    ("resnet50-cifar100", 8): (62.6, 4195.8, 1.34),
    ("resnet50-cifar100", 16): (62.5, 2098.4, 0.67),
}
