"""The vision model zoo (counterpart of ``paddle_tpu/vision/models/``;
ports ResNet, LeNet, AlexNet, VGG, MobileNetV1/V2/V3 and DenseNet; the
other four families are in ROADMAP Queue 1)."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet_flops_per_image)
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnet_flops_per_image)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnet_flops_per_image", "AlexNet",
           "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
           "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet_flops_per_image"]
