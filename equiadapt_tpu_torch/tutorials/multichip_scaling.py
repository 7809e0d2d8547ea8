"""Tutorial 5: scaling canonicalization pipelines across GPUs.

The port's scale-out surface (`equiadapt_tpu_torch.parallel`), one process
a rank over `torch.distributed`:

1. DP: the batch sharded over a 1-D "data" mesh, the gradients averaged
   (`data_parallel_jit`), the global batch's BatchNorm statistics;
2. FSDP: parameters and optimizer moments sharded on the same axis
   (`shard_state_fsdp`, FSDP2);
3. TP: Megatron column / row splits of a ViT over a (data, model) grid;
4. PP: a GPipe pipeline of the ViT trunk over a "stage" mesh;
5. GP: the |G| orbit axis of the per-element robustness sweep sharded over
   a (data, group) grid.

`main()` starts one NCCL rank on each visible GPU (`parallel.spawn`);
`main(device="cpu", world=2)` starts gloo ranks on the CPU. The grids are
2 x (world / 2) at an even world of 4 or more, else 1 x world; on one GPU
every regime runs over a world of one. The pipeline under test is a C4
GCNN canonicalizer (crop 0.9, resize 16) around a ResNet-18, on a global
batch of 16 images of 32 px. On the card the sweep's orbit is kernel K4
and its select K1a.

    python -m equiadapt_tpu_torch.tutorials.multichip_scaling
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from equiadapt_tpu_torch import parallel as par
from equiadapt_tpu_torch.data import synthetic_image_batch
from equiadapt_tpu_torch.models import ResNet18, ViT
from equiadapt_tpu_torch.pipelines import (
    ImageClassifierPipeline,
    create_train_state,
    group_inference,
    make_train_step,
)
from equiadapt_tpu_torch.tutorials._common import fp32, seeded
from equiadapt_tpu_torch.utils import (
    CanonicalizationConfig,
    NetworkHyperparams,
    get_image_canonicalization_network,
    get_image_canonicalizer,
)

PP_BAR = 1e-4  # pipelined against sequential logits, max |delta|


def grid(world: int):
    """(n_data, n_inner) of the 2-D meshes."""
    n_data = 2 if world >= 4 and world % 2 == 0 else 1
    return n_data, world // n_data


def _canonicalizer(size: int, device):
    cfg = CanonicalizationConfig(
        canonicalization_type="group_equivariant", network_type="e2cnn",
        network_hyperparams=NetworkHyperparams(kernel_size=3, out_channels=8,
                                               num_layers=2, num_rotations=4),
        input_crop_ratio=0.9, resize_shape=16)
    in_shape = (size, size, 3)
    return get_image_canonicalizer(
        cfg, get_image_canonicalization_network(cfg, in_shape, device=device), in_shape,
        device=device)


def _state(prediction_network, seed: int, size: int, device):
    """The pipeline (canonicalizer and `prediction_network`, weights from
    `seed`) with AdamW at 1e-3 (optax's default decay, 1e-4)."""
    with seeded(seed, device):
        pipe = ImageClassifierPipeline(canonicalizer=_canonicalizer(size, device),
                                       prediction_network=prediction_network())
    opt = torch.optim.AdamW(pipe.parameters(), lr=1e-3, weight_decay=1e-4)
    return create_train_state(pipe, ([opt], []))


def _rank(rank: int, world: int, device: str, batch_size: int, size: int) -> Dict:
    """The five regimes on one rank; every rank returns its readings."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else device
    n_data, n_inner = grid(world)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = synthetic_image_batch(gen, batch_size, size=size)
    step = make_train_step({"prior_weight": 1.0})
    resnet = lambda: ResNet18(num_classes=10, small_images=True, device=dev)  # noqa: E731
    out = {"rank": rank, "world": world, "grid": [n_data, n_inner]}
    with fp32():
        # 1. DP: replicate the state, shard the batch
        mesh = par.make_mesh()
        state = par.replicate(_state(resnet, 1, size, dev), mesh)
        dp_step = par.data_parallel_jit(step, mesh, num_extra_args=1)
        state, m = dp_step(state, batch, torch.Generator(device=dev).manual_seed(2))
        out["dp_loss"] = m["loss/total"].item()
        # 2. FSDP: parameters and moments sharded on the data axis
        state_f = par.shard_state_fsdp(_state(resnet, 3, size, dev), mesh,
                                       min_shard_bytes=1 << 10)
        _, m = dp_step(state_f, batch, torch.Generator(device=dev).manual_seed(4))
        out["fsdp_loss"] = m["loss/total"].item()
        # 3. TP: the ViT's attention and MLP split over the model axis
        vit = lambda: ViT(num_classes=10, patch_size=4, hidden_dim=16,  # noqa: E731
                          num_layers=2, num_heads=4, mlp_dim=32, image_size=size,
                          device=dev)
        mesh2 = par.make_mesh_2d(n_data, n_inner)
        state_t = par.shard_state_tp(par.replicate(_state(vit, 5, size, dev), mesh2), mesh2)
        _, m = par.data_parallel_jit(step, mesh2, num_extra_args=1)(
            state_t, batch, torch.Generator(device=dev).manual_seed(6))
        out["tp_loss"] = m["loss/total"].item()
        # 4. PP: the trunk of an 8-block ViT over the world's stages
        with seeded(7, dev):
            vit_pp = ViT(num_classes=10, patch_size=4, hidden_dim=16, num_layers=8,
                         num_heads=4, mlp_dim=32, image_size=16, device=dev)
        xs = batch["image"][:8, :16, :16, :]
        with torch.no_grad():
            logits_pp = par.vit_pipeline_apply(vit_pp, None, xs, par.make_mesh_stage(world),
                                               num_microbatches=4)
            out["pp_max_abs_err"] = (logits_pp - vit_pp(xs)).abs().max().item()
        # 5. GP: the sweep's orbit axis over the group axis, against the
        # unsharded sweep of the same model
        gm = par.group_sharded_inference(state.model, batch,
                                         par.make_mesh_group(n_data, n_inner),
                                         num_rotations=4)
        ref = group_inference(state.model, batch, num_rotations=4)
        out["gp_group_acc"] = gm["test/group_acc"].item()
        out["gp_equal"] = all(gm[k].item() == ref[k].item() for k in ref)
    if rank == 0:
        print(f"DP   loss={out['dp_loss']:.4f}")
        print(f"FSDP loss={out['fsdp_loss']:.4f}")
        print(f"TP   loss={out['tp_loss']:.4f} (grid {n_data} x {n_inner})")
        print(f"PP   max|pipeline - sequential| = {out['pp_max_abs_err']:.2e}")
        print(f"GP   group_acc={out['gp_group_acc']:.4f}, equal to the unsharded "
              f"sweep: {out['gp_equal']}")
    return out


def main(device="cuda", world: Optional[int] = None, batch: int = 16, size: int = 32,
         timeout: float = 600.0) -> Dict:
    """Spawn the ranks (all visible GPUs over NCCL, or `world` gloo ranks on
    the CPU, 2 by default) and return rank 0's readings."""
    if device == "cuda":
        from equiadapt_tpu_torch.ops.kernels import _build

        world = world or torch.cuda.device_count()
        backend, threads = "nccl", None
        _build.build_all()  # once, before the ranks load the kernels
    else:
        world, backend, threads = world or 2, "gloo", 1
    print(f"multichip_scaling: world {world} over {backend}")
    ranks = par.spawn(_rank, world, backend, args=(device, batch, size),
                      timeout=timeout, threads=threads)
    out = dict(ranks[0], backend=backend)
    assert all(r["pp_max_abs_err"] < PP_BAR for r in ranks), ranks
    assert all(r["gp_equal"] for r in ranks), ranks
    assert all(torch.isfinite(torch.tensor([r["dp_loss"], r["fsdp_loss"], r["tp_loss"]])).all()
               for r in ranks), ranks
    print(f"all five regimes ran on {world} {backend} rank(s)")
    return out


if __name__ == "__main__":
    main()
