"""The vision model zoo (counterpart of ``paddle_tpu/vision/models/``):
LeNet, AlexNet, VGG, ResNet, MobileNetV1/V2/V3, DenseNet, SqueezeNet,
ShuffleNetV2, GoogLeNet and InceptionV3."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet_flops_per_image)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152, resnet_flops_per_image)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_flops_per_image,
                           shufflenet_v2_swish, shufflenet_v2_x0_25,
                           shufflenet_v2_x0_33, shufflenet_v2_x0_5,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                           shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnet_flops_per_image", "AlexNet",
           "alexnet", "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
           "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
           "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large", "DenseNet", "densenet121", "densenet161",
           "densenet169", "densenet201", "densenet_flops_per_image",
           "SqueezeNet", "squeezenet1_0", "squeezenet1_1", "GoogLeNet",
           "googlenet", "InceptionV3", "inception_v3", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish",
           "shufflenet_flops_per_image"]
