"""Tutorial 2: making a classifier rotation-invariant by canonicalization.

A learned C4 canonicalizer (the registry's "e2cnn" GCNN) wraps a ResNet-18,
the two are trained together with the prior regularization, and the
trained pipeline is swept over every group element of a test batch
(`group_inference`). The headline property: the accuracy is identical
under every element, since the canonicalized pipeline is exactly
rotation-invariant (the absolute accuracy depends on the task and the
backbone, not on the orientation). `make_optimizer(...,
freeze_prediction=True)` gives the frozen-backbone adaptation instead.

On the card the sweep's orbit is kernel K4, and the canonicalizer's
select on it K1 (the pipeline hands the fp32 ResNet NCHW memory).

    python -m equiadapt_tpu_torch.tutorials.classification_group_equivariant_canonicalization

On the CPU: `main(device="cpu")`.
"""

from __future__ import annotations

from typing import Dict

import torch

from equiadapt_tpu_torch.data import synthetic_image_batch
from equiadapt_tpu_torch.models import ResNet18
from equiadapt_tpu_torch.pipelines import (
    ImageClassifierPipeline,
    create_train_state,
    group_inference,
    make_optimizer,
    make_train_step,
)
from equiadapt_tpu_torch.tutorials._common import fp32, seeded
from equiadapt_tpu_torch.utils import (
    CanonicalizationConfig,
    NetworkHyperparams,
    get_image_canonicalization_network,
    get_image_canonicalizer,
)


def build_pipeline(size: int = 32, device="cuda") -> ImageClassifierPipeline:
    """C4 GCNN canonicalizer (3 x 3, 8 channels, 2 layers) around a
    ResNet-18 with a CIFAR stem and 4 classes."""
    cfg = CanonicalizationConfig(
        canonicalization_type="group_equivariant", network_type="e2cnn",
        network_hyperparams=NetworkHyperparams(kernel_size=3, out_channels=8,
                                               num_layers=2, num_rotations=4))
    in_shape = (size, size, 3)
    net = get_image_canonicalization_network(cfg, in_shape, device=device)
    canon = get_image_canonicalizer(cfg, net, in_shape, device=device)
    pred = ResNet18(num_classes=4, small_images=True, device=device)
    return ImageClassifierPipeline(canonicalizer=canon, prediction_network=pred)


def main(device="cuda", size: int = 32, batch: int = 64, steps: int = 60,
         seed: int = 0) -> Dict:
    with seeded(seed, device):
        pipeline = build_pipeline(size, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    # eight training batches, cycled; the test batch is a ninth draw
    batches = [synthetic_image_batch(gen, batch, size=size, num_classes=4) for _ in range(8)]
    test = synthetic_image_batch(gen, batch, size=size, num_classes=4)
    tx = make_optimizer(pipeline, architecture="resnet18", learning_rate=1e-3,
                        canonicalization_learning_rate=1e-3)
    state = create_train_state(pipeline, tx)
    step = make_train_step({"prior_weight": 100.0})
    draws = torch.Generator(device=device).manual_seed(seed + 1)  # dropout
    with fp32():
        for i in range(steps):
            state, metrics = step(state, batches[i % 8], draws)
        train = {k: v.item() for k, v in metrics.items()}
        print({k: round(v, 4) for k, v in train.items()})
        # group robustness: accuracy under every group element of the test input
        gm = {k: v.item() for k, v in group_inference(state.model, test,
                                                      num_rotations=4).items()}
    print({k: round(v, 4) for k, v in gm.items()})
    accs = [gm[f"test/acc_element_{g}"] for g in range(4)]
    assert max(accs) - min(accs) < 1e-6, accs
    print("per-element accuracies identical -> exact rotation invariance")
    return {"train": train, "group": gm, "element_accs": accs}


if __name__ == "__main__":
    main()
