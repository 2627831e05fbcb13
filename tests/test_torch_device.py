"""The port's rule for placement: every public entry point builds on
``cuda`` unless the caller asks for the CPU by name (``core.resolve_device``).
With no card visible and no device named, construction raises
``RuntimeError``; it never carries on on the CPU quietly. On a machine with
a card the default is to use it, so these tests skip there."""
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import (ConformerForCTC, ConformerForRNNT,
                                     ErnieForMaskedLM, LlamaForCausalLM,
                                     WhisperForConditionalGeneration,
                                     conformer_tiny, ernie_tiny, llama_tiny,
                                     whisper_tiny)
from paddle_tpu_torch.serving import PagedKVCache
from paddle_tpu_torch.vision import models as vm
from paddle_tpu_torch.vision.ops import ConvNormActivation

ENTRY_POINTS = {
    "LayerNorm": lambda **kw: tnn.LayerNorm(8, **kw),
    "RMSNorm": lambda **kw: tnn.RMSNorm(8, **kw),
    "BatchNorm1D": lambda **kw: tnn.BatchNorm1D(8, **kw),
    "BatchNorm": lambda **kw: tnn.BatchNorm(8, **kw),
    "BatchNorm2D": lambda **kw: tnn.BatchNorm2D(8, **kw),
    "BatchNorm3D": lambda **kw: tnn.BatchNorm3D(8, **kw),
    "Linear": lambda **kw: tnn.Linear(4, 8, **kw),
    "PReLU": lambda **kw: tnn.PReLU(4, **kw),
    "ConvNormActivation": lambda **kw: ConvNormActivation(3, 8, **kw),
    "Conv1D": lambda **kw: tnn.Conv1D(4, 4, 3, **kw),
    "Conv2D": lambda **kw: tnn.Conv2D(1, 4, 3, **kw),
    "MultiHeadAttention": lambda **kw: tnn.MultiHeadAttention(8, 2, **kw),
    "TransformerEncoderLayer": lambda **kw: tnn.TransformerEncoderLayer(
        8, 2, 16, **kw),
    "TransformerDecoderLayer": lambda **kw: tnn.TransformerDecoderLayer(
        8, 2, 16, **kw),
    "Transformer": lambda **kw: tnn.Transformer(8, 2, 1, 1, 16, **kw),
    "LSTMCell": lambda **kw: tnn.LSTMCell(4, 8, **kw),
    "LSTM": lambda **kw: tnn.LSTM(4, 8, num_layers=2, direction="bidirect",
                                  **kw),
    "PagedKVCache": lambda **kw: PagedKVCache(1, 4, 1, 4, 8, **kw),
    "LlamaForCausalLM": lambda **kw: LlamaForCausalLM(
        llama_tiny(vocab=61, hidden=32, layers=1), **kw),
    "ErnieForMaskedLM": lambda **kw: ErnieForMaskedLM(ernie_tiny(), **kw),
    "ConformerForCTC": lambda **kw: ConformerForCTC(conformer_tiny(), **kw),
    "ConformerForRNNT": lambda **kw: ConformerForRNNT(conformer_tiny(),
                                                      **kw),
    "WhisperForConditionalGeneration": lambda **kw:
        WhisperForConditionalGeneration(whisper_tiny(), **kw),
    "resnet18": lambda **kw: vm.resnet18(num_classes=10, **kw),
    "resnet50": lambda **kw: vm.resnet50(**kw),
    "LeNet": lambda **kw: vm.LeNet(**kw),
    "alexnet": lambda **kw: vm.alexnet(num_classes=10, **kw),
    "vgg11": lambda **kw: vm.vgg11(num_classes=10, with_pool=False, **kw),
    "mobilenet_v1": lambda **kw: vm.mobilenet_v1(scale=0.25, **kw),
    "mobilenet_v2": lambda **kw: vm.mobilenet_v2(scale=0.35, **kw),
    "mobilenet_v3_small": lambda **kw: vm.mobilenet_v3_small(**kw),
    "mobilenet_v3_large": lambda **kw: vm.mobilenet_v3_large(**kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_refuses_the_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_builds_on_the_cpu_when_asked(name):
    obj = ENTRY_POINTS[name](device="cpu")
    tensors = [obj.pool] if isinstance(obj, PagedKVCache) else \
        list(obj.parameters())
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_model_follows_its_networks_device():
    """``hapi.Model`` runs where its network's parameters (or buffers)
    lie; a network built with no device and no card raises where it is
    built, and a network with neither parameters nor buffers asks for the
    card."""
    import paddle_tpu_torch as paddle

    net = vm.LeNet(device="cpu")
    model = paddle.Model(net)
    assert model.device == torch.device("cpu")
    model.prepare(paddle.optimizer.SGD(parameters=net.parameters()),
                  paddle.nn.CrossEntropyLoss())
    loss, _ = model.train_batch([torch.zeros(2, 1, 28, 28)],
                                [torch.zeros(2, 1, dtype=torch.int64)])
    assert isinstance(loss[0], float)
    assert paddle.Model(tnn.BatchNorm2D(3, device="cpu")).device.type == \
        "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is to use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle.Model(vm.LeNet())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle.Model(tnn.ReLU()).device
