"""Runnable walkthroughs of the port, one module each, on the card unless
the caller asks for the CPU:

* `understanding_discrete_canonicalization`: a C4 canonicalizer on the four
  quarter turns of one image (the select kernel; the prior's gradient);
* `classification_group_equivariant_canonicalization`: a canonicalized
  ResNet-18 trained with the prior, then the per-element sweep (K4, K1);
* `instance_segmentation_group_equivariant_canonicalization`: images and
  box / mask targets canonicalized together, SAMLite adapted, masks
  inverted (K1a, K3);
* `nbody`: a GNN with and without SE(3) canonicalization, evaluated under
  random rotations;
* `multichip_scaling`: data, FSDP, tensor, pipeline and orbit-axis
  parallelism over `torch.distributed` (`parallel.spawn`).

    python -m equiadapt_tpu_torch.tutorials.<name>

Each module's `main(device="cuda", **sizes)` returns its headline numbers
and asserts the property it demonstrates. Draws of data, dropout and noise
come from explicit `torch.Generator`s; weights from a seeded generator
forked for the build. The tutorials compute in fp32 with TF32 off: their
exactness claims (identical canonical copies, identical per-element
accuracies) are claims about fp32 arithmetic.
"""
