#!/usr/bin/env python3
"""Time ResNet-50 through ``Model.fit`` with the host side split out, on one
CUDA card.

    python tools/hapi_loader_bench.py [--pairs N]

The setup of ``chip_smoke.py`` ``[hapi resnet]`` (ResNet-50 in f32,
Momentum over PiecewiseDecay, 768 seeded 256 x 256 images through the
PaddleClas train transforms, batch 64, 4 worker processes), one epoch a
run, ``--pairs`` pairs of runs in turns (pageable, pinned, pinned,
pageable, ...) in one process: "pinned" is ``Model``'s own copy of each
batch to the card (pinned memory, not blocking the host), "pageable" the
plain blocking ``tensor.to("cuda")`` in its place. Each run prints the
median step wall (steps 3 on; a timing callback), the median wait for the
loader, and the median time of the parent's copy of a batch out of the
workers' shared memory (``io.worker._read_segment``), then images/s. Only
``csrc/softmax_ce.cu`` is built. Prints the card's name and power limit
first. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("hapi_loader_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    from paddle_tpu_torch.hapi import callbacks as cbks
    from paddle_tpu_torch.hapi import model as hmodel
    from paddle_tpu_torch.io import worker
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.optimizer import Momentum, PiecewiseDecay
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import resnet50

    print(cs.card_line())
    _build.sources = lambda: [_build.CSRC / "softmax_ce.cu"]
    _build.build_all()

    pinned = hmodel._to_tensor

    def pageable(x, device):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        return x.to(device)

    reads = []
    read = worker._read_segment

    def timed_read(name, nbytes):
        t = time.monotonic()
        out = read(name, nbytes)
        reads.append((time.monotonic() - t) * 1e3)
        return out

    worker._read_segment = timed_read
    images, labels = cs.imagenet_like(cs.HAPI_RESNET_IMAGES, 256, 1000, 11)

    class Images(io.Dataset):
        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            return tf(images[i]), labels[i]

    tf = T.Compose([T.ToTensor(), T.RandomCrop(224),
                    T.RandomHorizontalFlip(),
                    T.Normalize(cs.IMAGENET_MEAN, cs.IMAGENET_STD)])
    paddle.seed(0)
    net = resnet50(seed=0)
    model = paddle.Model(net)
    opt = Momentum(learning_rate=PiecewiseDecay(cs.RESNET_BOUNDARIES,
                                                cs.RESNET_LRS),
                   momentum=0.9, parameters=net.parameters(),
                   weight_decay=1e-4)
    model.prepare(opt, paddle.nn.CrossEntropyLoss(),
                  paddle.metric.Accuracy(topk=(1, 5)))
    x = next(iter(io.DataLoader(Images(), batch_size=cs.RESNET_BATCH,
                                num_workers=cs.HAPI_RESNET_WORKERS)))[0]
    print(f"a worker batch in this process: pinned {x.is_pinned()}")
    order = []
    for i in range(args.pairs):
        order += ["pageable", "pinned"] if i % 2 == 0 else ["pinned",
                                                           "pageable"]
    med = lambda v: sorted(v)[len(v) // 2]     # noqa: E731
    for what in order:
        hmodel._to_tensor = pinned if what == "pinned" else pageable
        rec = cs._loss_recorder(cbks)
        reads.clear()
        np.random.seed(0)
        model.fit(Images(), batch_size=cs.RESNET_BATCH, epochs=1,
                  shuffle=True, drop_last=True,
                  num_workers=cs.HAPI_RESNET_WORKERS, verbose=0,
                  callbacks=[rec])
        torch.cuda.synchronize()
        step, wait = med(rec.steps[2:]) * 1e3, med(rec.waits[1:]) * 1e3
        print(f"{what:9s} step {step:.2f} ms, loader wait {wait:.2f} ms (the "
              f"parent's copy out of shared memory {med(reads):.2f} ms), "
              f"{cs.RESNET_BATCH * 1e3 / (step + wait):.1f} images/s")
    hmodel._to_tensor = pinned
    return 0


if __name__ == "__main__":
    sys.exit(main())
