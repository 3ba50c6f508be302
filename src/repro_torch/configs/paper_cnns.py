"""The paper's own benchmark networks (§5): LeNet on MNIST, Caffe
CIFAR-10-Quick on CIFAR-10 and a downscaled AlexNet on ImageNet.

A copy of ``repro.configs.paper_cnns`` (the port imports nothing of
``repro``); ``tests/test_torch_cnn.py`` holds every field equal to the
original. Dims follow the Caffe model zoo definitions the paper used.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ConvSpec:
    features: int
    kernel: int
    stride: int = 1
    pool: int = 0          # max-pool window (0 = none)
    pool_stride: int = 2


@dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int
    channels: int
    num_classes: int
    convs: tuple = ()
    hidden: tuple = ()
    source: str = ""

    @property
    def family(self) -> str:
        return "cnn"


LENET = CNNConfig(
    name="lenet", image_size=28, channels=1, num_classes=10,
    convs=(ConvSpec(20, 5, pool=2), ConvSpec(50, 5, pool=2)),
    hidden=(500,),
    source="LeCun et al. 1998 (Caffe LeNet)",
)

CIFAR_QUICK = CNNConfig(
    name="cifar-quick", image_size=32, channels=3, num_classes=10,
    convs=(ConvSpec(32, 5, pool=3), ConvSpec(32, 5, pool=3), ConvSpec(64, 5, pool=3)),
    hidden=(64,),
    source="Caffe CIFAR-10 Quick",
)

# Downscaled AlexNet-class network (the paper's large-scale case) at 64x64.
ALEXNET_SMALL = CNNConfig(
    name="alexnet-small", image_size=64, channels=3, num_classes=1000,
    convs=(ConvSpec(64, 11, stride=4, pool=3), ConvSpec(192, 5, pool=3),
           ConvSpec(384, 3), ConvSpec(256, 3), ConvSpec(256, 3, pool=3)),
    hidden=(1024, 1024),
    source="Krizhevsky et al. 2012 (Caffe AlexNet, downscaled)",
)

PAPER_CNNS = {c.name: c for c in (LENET, CIFAR_QUICK, ALEXNET_SMALL)}
